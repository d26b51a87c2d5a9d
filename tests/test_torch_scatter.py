"""The payload carry's wrapper on the CPU (``repro_torch.kernels.
fractal_scatter``): its plain version against the torch-op carry of
``PassBackend.scatter`` (the rank widened to int64, a zero fill, the
index write), and ``CudaBackend.scatter`` taking that plain version on
CPU tensors.  The kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from repro_torch.core import CudaBackend, PassBackend
from repro_torch.kernels import ops
from repro_torch.kernels.fractal_scatter import fractal_scatter

_PAYLOADS = ("int32", "uint32", "int64", "uint64", "int16", "uint8",
             "float32", "bfloat16", "float32x3")


def _payload(rng, name: str, n: int) -> torch.Tensor:
    if name == "float32x3":  # a 2-D payload of 12-byte rows
        return torch.from_numpy(rng.standard_normal((n, 3), np.float32))
    return torch.from_numpy(rng.integers(0, 1 << 7, n)).to(
        getattr(torch, name))


def _same(got: tuple, want: tuple) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert not g.numel() or torch.equal(g.view(torch.uint8),
                                            w.view(torch.uint8))


@pytest.mark.parametrize("payload", _PAYLOADS)
@pytest.mark.parametrize("n", [0, 1, 1001])
@pytest.mark.parametrize("trailing_bits", [None, 28])
def test_plain_version_is_the_torch_op_carry(rng, payload, n, trailing_bits):
    rank = torch.from_numpy(rng.permutation(n).astype(np.int32))
    keys = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n)
                            .astype(np.int32))
    pay = _payload(rng, payload, n)
    want = PassBackend().scatter(rank, keys, pay, trailing_bits=trailing_bits)
    _same(fractal_scatter(rank, keys, pay, trailing_bits=trailing_bits), want)
    ops.reset_launch_counts()
    _same(CudaBackend().scatter(rank, keys, pay,
                                trailing_bits=trailing_bits), want)
    assert ops.launch_counts()["fractal_scatter"] == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rank = torch.arange(8, dtype=torch.int32)
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):  # an array of another length
        fractal_scatter(rank, keys, keys[:7])
    with pytest.raises(ValueError):
        fractal_scatter(rank, keys, trailing_bits=32)
    with pytest.raises(TypeError):  # the mask is for 32-bit integer keys
        fractal_scatter(rank, keys.long(), trailing_bits=4)
