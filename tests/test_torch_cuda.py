"""The hand-written CUDA kernels of ``repro_torch`` on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU (a CUDA kernel has no CPU mode; the CPU tests hold the kernels'
plain versions against the JAX reference instead).  The module imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (fractal_argsort, fractal_sort,
                              fractal_sort_pairs, make_sort_plan)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fractal_histogram import fractal_histogram
from repro_torch.kernels.fractal_rank import (fractal_rank_kernel,
                                              fractal_rank_scatter_kernel)
from repro_torch.kernels.fractal_reconstruct import fractal_reconstruct

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n_bins", [16, 256, 1 << 16])
def test_kernels_match_plain_versions(rng, cuda_device, n_bins):
    """Digits with −1 and n_bins pads mixed in; injected bin starts; a
    carried histogram; reconstruct of the sorted digits."""
    n = 100_003
    d = rng.integers(-1, n_bins + 1, n).astype(np.int32)
    keys = torch.from_numpy(d).to(cuda_device)
    start = torch.from_numpy(rng.integers(0, 1 << 20, n_bins).astype(np.int32)
                             ).to(cuda_device)
    init = torch.from_numpy(rng.integers(0, 9, n_bins).astype(np.int32)
                            ).to(cuda_device)
    assert torch.equal(fractal_histogram(keys, n_bins, init=init),
                       ref.histogram_ref(keys, n_bins, init=init))
    want = ref.rank_ref(keys, start, n_bins)
    assert torch.equal(fractal_rank_kernel(keys, start, n_bins), want)
    assert torch.equal(fractal_rank_scatter_kernel(keys, start, n_bins), want)
    s = torch.sort(keys.clamp(0, n_bins - 1)).values
    counts = ref.histogram_ref(s, n_bins)
    assert torch.equal(
        fractal_reconstruct(counts, torch.zeros_like(s), n_bins, 0), s)


def test_sort_entry_points_launch_the_kernels(rng, cuda_device):
    keys = rng.integers(0, 1 << 32, 300_001, dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(keys).to(cuda_device)
    order = np.argsort(keys, kind="stable")
    ops.reset_launch_counts()
    out = fractal_sort(t, 32)
    assert out.dtype == torch.uint32
    np.testing.assert_array_equal(out.cpu().numpy(), np.sort(keys))
    sk, sv = fractal_sort_pairs(
        t, torch.arange(len(keys), dtype=torch.int32, device=cuda_device), 32)
    np.testing.assert_array_equal(sv.cpu().numpy(), order)
    plan = make_sort_plan(len(keys), 32, max_bins_log2=8, engine="scatter")
    perm = fractal_argsort(t, 32, plan=plan)
    np.testing.assert_array_equal(perm.cpu().numpy(), order)
    np.testing.assert_array_equal(
        ops.fractal_sort_kernel(t, 32).cpu().numpy(), np.sort(keys))
    assert all(c > 0 for c in ops.launch_counts().values()), ops.launch_counts()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    keys = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    start = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        fractal_histogram(keys.to(torch.int64), 16)
    with pytest.raises(ValueError):  # not contiguous
        fractal_histogram(torch.zeros(128, dtype=torch.int32,
                                      device=cuda_device)[::2], 16)
    with pytest.raises(ValueError):  # bin_start of the wrong length
        fractal_rank_kernel(keys, start[:8], 16)
    with pytest.raises(ValueError):  # the CUDA sort block holds <= 1024 keys
        fractal_rank_scatter_kernel(keys, start, 16, block=2048)
    with pytest.raises(ValueError):  # a CPU operand next to a CUDA one
        fractal_histogram(keys, 16, init=torch.zeros(16, dtype=torch.int32))
