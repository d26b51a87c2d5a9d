"""K1: digit histogram — wrapper over ``csrc/fractal_histogram.cu``.

Port of ``repro.kernels.fractal_histogram``.  :func:`fractal_histogram`
bincounts an int32 digit stream over ``[0, n_bins)`` onto carried counts
(``init``, the streaming accumulation of paper §III.D); values outside the
range are ignored.  On a CPU tensor it computes the plain version
(:func:`~repro_torch.kernels.ref.histogram_ref`); on a CUDA tensor it
launches the kernel or raises.  :func:`digit_histograms` is the
multi-digit driver, one histogram per plan pass.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.fractal_tree import as_u32_bits
from repro_torch.kernels import _build, ref

__all__ = ["fractal_histogram", "digit_histograms"]

_MAX_BINS = 1 << 16


@functools.cache
def _lib():
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _build.library("fractal_histogram",
                          {"fs_histogram": [vp, ll, vp, i, vp]})


def fractal_histogram(keys: torch.Tensor, n_bins: int,
                      init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leaf counts (bincount) of the int32 ``keys`` over ``[0, n_bins)``,
    added onto ``init`` when given."""
    if keys.device.type == "cpu":
        return ref.histogram_ref(keys, n_bins, init=init)
    if not 1 <= n_bins <= _MAX_BINS:
        raise ValueError(f"n_bins={n_bins} out of range (1..{_MAX_BINS})")
    _build.check_operand(keys, "keys")
    out = torch.empty((n_bins,), dtype=torch.int32, device=keys.device)
    if init is None:
        out.zero_()
    else:
        _build.check_operand(init, "init", n_bins)
        out.copy_(init)
    n = keys.shape[0]
    if n:
        _build.check(_lib().fs_histogram(
            keys.data_ptr(), n, out.data_ptr(), n_bins,
            _build.stream(keys.device)), "fractal_histogram")
        fractal_histogram.launches += 1
    return out


fractal_histogram.launches = 0


def digit_histograms(keys: torch.Tensor, passes, init=None):
    """One leaf histogram per :class:`~repro_torch.core.sort_plan.DigitPass`:
    the bincount of each pass's ``bits``-wide digit at ``shift`` of the
    (uint32) key stream, each added onto the matching entry of ``init``
    (one counts tensor per pass) when given.  Returns a tuple of
    ``(2**bits,)`` int32 tensors, plan order."""
    u = as_u32_bits(keys)
    passes = tuple(passes)
    if init is None:
        init = (None,) * len(passes)
    return tuple(
        fractal_histogram(((u >> dp.shift) & (dp.n_bins - 1)).contiguous(),
                          dp.n_bins, init=carried)
        for dp, carried in zip(passes, init))
