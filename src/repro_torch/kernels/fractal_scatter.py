"""The payload carry of a sort pass — wrapper over ``csrc/fractal_scatter.cu``.

``fractal_scatter(rank, *arrays)`` places row ``i`` of every array at row
``rank[i]`` of its output, all arrays in one launch over one read of the
int32 ranks.  ``trailing_bits`` keeps only that many low bits of the
first array (the MSD pass's trailing-bit entries), applied on the way.
The kernel fills no output: ``rank`` must be a permutation of
``[0, n)``, as every caller's stable ranks are.

The kernel observes each array's row width (element size times its
trailing dimensions) and its addresses: up to four arrays of 4-byte rows
with 16-byte aligned sources are grouped in shared memory by destination
line before they are stored (the sort's keys and int32 payloads); any
other row is copied one a thread in the widest unit that divides it.  On
a CPU tensor the wrapper computes the plain version
(:func:`~repro_torch.kernels.ref.scatter_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

__all__ = ["MAX_ARRAYS", "fractal_scatter"]

#: arrays one launch carries (the kernel's own); more take more launches
MAX_ARRAYS = 8


@functools.cache
def _lib():
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _build.library("fractal_scatter",
                          {"fs_scatter": [vp, ll, i, vp, vp, vp, i, vp]})


def _check(rank: torch.Tensor, arrays: tuple,
           trailing_bits: Optional[int]) -> None:
    n = rank.shape[0] if rank.dim() == 1 else None
    for k, a in enumerate(arrays):
        if a.device != rank.device:
            raise ValueError(f"array {k} is on {a.device}, rank on "
                             f"{rank.device}")
        if a.dim() < 1 or a.shape[0] != n:
            raise ValueError(f"array {k} has shape {tuple(a.shape)}; "
                             f"expected {n} rows, one a rank")
    if trailing_bits is not None:
        if not 0 <= trailing_bits < 32:
            raise ValueError(f"trailing_bits={trailing_bits} out of range "
                             f"(0..31)")
        if (not arrays or arrays[0].dim() != 1
                or arrays[0].dtype not in (torch.int32, torch.uint32)):
            raise TypeError("trailing_bits masks a first array of 32-bit "
                            "integers")


def fractal_scatter(rank: torch.Tensor, *arrays: torch.Tensor,
                    trailing_bits: Optional[int] = None) -> tuple:
    """``out_k[rank[i]] = arrays[k][i]`` for every array, as a tuple of
    outputs in the arrays' dtypes and shapes.  ``rank`` is ``(n,)`` int32,
    a permutation of ``[0, n)``; each array has ``n`` rows of any dtype
    and trailing shape."""
    if rank.device.type == "cpu":
        _check(rank, arrays, trailing_bits)
        return ref.scatter_ref(rank, *arrays, trailing_bits=trailing_bits)
    _build.check_operand(rank, "rank")
    _check(rank, arrays, trailing_bits)
    for k, a in enumerate(arrays):
        if not a.is_contiguous():
            raise ValueError(f"array {k} must be contiguous")
    outs = tuple(torch.empty_like(a) for a in arrays)
    n = rank.shape[0]
    moved = [k for k, a in enumerate(arrays) if a.numel()]
    if not n or not moved:
        return outs
    mask = -1 if trailing_bits is None else (1 << trailing_bits) - 1
    stream = _build.stream(rank.device)
    for lo in range(0, len(moved), MAX_ARRAYS):
        group = moved[lo:lo + MAX_ARRAYS]
        count = len(group)
        src = (ctypes.c_void_p * count)(*(arrays[k].data_ptr()
                                          for k in group))
        dst = (ctypes.c_void_p * count)(*(outs[k].data_ptr() for k in group))
        row_bytes = (ctypes.c_longlong * count)(*(
            arrays[k].element_size() * math.prod(arrays[k].shape[1:])
            for k in group))
        _build.check(_lib().fs_scatter(
            rank.data_ptr(), n, count, src, dst, row_bytes,
            mask if group[0] == 0 else -1, stream), "fractal_scatter")
        _build.count_launch(fractal_scatter)
    return outs


fractal_scatter.launches = 0
