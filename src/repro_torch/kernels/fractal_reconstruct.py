"""K4: Algorithm-5 reconstruct — wrapper over ``csrc/fractal_reconstruct.cu``.

Port of ``repro.kernels.fractal_reconstruct``.  Rebuilds sorted keys from
the MSD bin counts and the sorted-order trailing-bit entries: each key's
prefix bits come from its output position against the bin CDF and are
never read.  Output is int32 bit patterns (p = 32 wraps, exact as
uint32).  On a CPU tensor the wrapper computes the plain version
(:func:`~repro_torch.kernels.ref.reconstruct_ref`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

__all__ = ["fractal_reconstruct", "fractal_reconstruct_plan"]


@functools.cache
def _lib():
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _build.library("fractal_reconstruct",
                          {"fs_reconstruct": [vp, i, vp, vp, ll, i, vp]})


def fractal_reconstruct(counts: torch.Tensor, trailing: torch.Tensor,
                        n_bins: int, t_bits: int) -> torch.Tensor:
    """Sorted keys from bin ``counts`` ((n_bins,) int32) and sorted-order
    ``trailing`` entries ((n,) int32, low ``t_bits`` used; zeros when the
    trie covers the full precision)."""
    if not 0 <= t_bits < 32:
        raise ValueError(f"t_bits={t_bits} out of range (0..31)")
    if counts.shape != (n_bins,):
        raise ValueError(f"counts has shape {tuple(counts.shape)}, "
                         f"expected ({n_bins},)")
    if trailing.device.type == "cpu":
        return ref.reconstruct_ref(counts, trailing, t_bits)
    _build.check_operand(counts, "counts", n_bins)
    _build.check_operand(trailing, "trailing")
    n = trailing.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=trailing.device)
    if n:
        cdf = torch.cumsum(counts, 0, dtype=torch.int32)
        _build.check(_lib().fs_reconstruct(
            cdf.data_ptr(), n_bins, trailing.data_ptr(), out.data_ptr(), n,
            t_bits, _build.stream(trailing.device)), "fractal_reconstruct")
        _build.count_launch(fractal_reconstruct)
    return out


fractal_reconstruct.launches = 0


def fractal_reconstruct_plan(counts: torch.Tensor, trailing: torch.Tensor,
                             plan) -> torch.Tensor:
    """Algorithm 5 for a :class:`~repro_torch.core.sort_plan.SortPlan`'s
    MSD pass: the final pass gives the bin space (``2**depth``) and the
    entry width (``shift = p - depth``)."""
    last = plan.passes[-1]
    return fractal_reconstruct(counts, trailing, last.n_bins, last.shift)
