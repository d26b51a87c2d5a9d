"""The paper's comparison set on PyTorch (port of ``repro.core.baselines``).

§IV's quick/merge/heap/Tim sort columns collapse to one comparison sort
(:func:`torch_sort`, the counterpart of the reference's ``xla_sort``);
the radix baseline is a classic multi-pass LSD sort with full-key
scatters (:func:`lsd_radix_sort`), the thing FractalSort's compressed
entries beat on bandwidth; :func:`bitonic_sort` is the sorting-network
column.  Each baseline also has an analytic traffic model mirroring
:func:`~repro_torch.core.fractal_sort.fractal_sort_stats`, so a
bandwidth comparison (paper Fig. 10) counts like for like.

Key order follows the key dtype, as in the reference: ``torch.uint32``
(the port's p = 32 key dtype) orders as unsigned, every other dtype as
its signed values.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.executor import _like_keys
from repro_torch.core.fractal_sort import SortStats, make_backend, to_device
from repro_torch.core.fractal_tree import as_u32_bits

__all__ = [
    "torch_sort",
    "lsd_radix_sort",
    "bitonic_sort",
    "radix_sort_stats",
    "comparison_sort_stats",
    "bitonic_sort_stats",
]

# XOR with the int32 sign bit maps uint32 order onto int32 order
_SIGN = -(1 << 31)


def _ordered(keys: torch.Tensor) -> torch.Tensor:
    """``keys`` in a dtype whose signed order is the keys' order."""
    return keys.view(torch.int32) ^ _SIGN if keys.dtype == torch.uint32 \
        else keys


def _unordered(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`_ordered` for keys of ``dtype``."""
    return (x ^ _SIGN).view(torch.uint32) if dtype == torch.uint32 else x


def torch_sort(keys, *, device=None) -> torch.Tensor:
    """Comparison sort (stands in for the quick/merge/heap/Tim sort
    columns): ``torch.sort`` in key order, in the input's dtype, on
    ``device`` (``None`` means cuda); the port's counterpart of the
    reference's ``xla_sort``."""
    keys = to_device(keys, device)
    return _unordered(torch.sort(_ordered(keys)).values, keys.dtype)


def lsd_radix_sort(keys, p: int, radix_bits: int = 8, batch: int = 1024, *,
                   device=None, backend: Optional[str] = None
                   ) -> torch.Tensor:
    """Classic LSD radix sort: ceil(p / radix_bits) stable counting passes,
    each moving the FULL key through memory (the bandwidth cost
    FractalSort removes via bin-position reconstruction).  Each pass ranks
    its digit through the pass backend's ``rank`` (on the card K1's counts
    and K2, at 2**radix_bits bins) and scatters the keys; the result has
    the input's dtype."""
    keys = to_device(keys, device)
    pb = make_backend(backend, keys.device, batch)
    u = as_u32_bits(keys)
    n_bins = 1 << radix_bits
    for i in range(math.ceil(p / radix_bits)):
        digit = (u >> (i * radix_bits)) & (n_bins - 1)
        rank, _, _ = pb.rank(digit, n_bins)
        u, = pb.scatter(rank, u)
    return _like_keys(u, keys)


def bitonic_sort(keys, ascending: bool = True, *,
                 device=None) -> torch.Tensor:
    """Bitonic sorting network (the paper's GPU/Terasort comparison column,
    Table I: O(log^2 n) depth), one compare-exchange sweep of the whole
    array per (stage, stride), on ``device`` (``None`` means cuda).
    Requires a power-of-two length."""
    keys = to_device(keys, device).contiguous()
    n = keys.shape[0]
    if n & (n - 1):
        raise ValueError(f"bitonic_sort requires a power-of-two length, "
                         f"got {n}")
    x = _ordered(keys)
    log_n = n.bit_length() - 1
    for stage in range(1, log_n + 1):
        for sub in range(stage - 1, -1, -1):
            stride = 1 << sub
            # each row pairs the first half of a 2*stride block with its
            # second half (partner = index ^ stride)
            pairs = x.view(-1, 2, stride)
            lo = torch.minimum(pairs[:, 0], pairs[:, 1])
            hi = torch.maximum(pairs[:, 0], pairs[:, 1])
            if stage < log_n:
                # a block's direction is bit `stage` of its indices
                block = torch.arange(pairs.shape[0], device=x.device)
                up = (((block >> (stage - sub - 1)) & 1) == 0)[:, None]
                first = torch.where(up, lo, hi)
                second = torch.where(up, hi, lo)
            else:
                first, second = (lo, hi) if ascending else (hi, lo)
            x = torch.stack((first, second), 1).view(n)
    return _unordered(x, keys.dtype)


def radix_sort_stats(n: int, p: int, radix_bits: int = 8,
                     with_index: bool = False) -> SortStats:
    """LSD radix traffic: every pass reads AND writes the full key array
    (+ a 4-byte arrival index per key when tracking stable payloads)."""
    passes = math.ceil(p / radix_bits)
    kb = 4 if p > 16 else 2
    per = kb + (4 if with_index else 0)
    return SortStats(
        n=n, p=p, l_n=radix_bits, passes=passes,
        bytes_read=passes * n * per,
        bytes_written=passes * n * per,
        histogram_bytes=(1 << radix_bits) * 4,
    )


def comparison_sort_stats(n: int, p: int) -> SortStats:
    """Merge-sort-like traffic: log2(n) passes, full keys both ways."""
    passes = max(1, math.ceil(math.log2(max(n, 2))))
    kb = 4 if p > 16 else 2
    return SortStats(
        n=n, p=p, l_n=0, passes=passes,
        bytes_read=passes * n * kb, bytes_written=passes * n * kb,
        histogram_bytes=0,
    )


def bitonic_sort_stats(n: int, p: int) -> SortStats:
    """Bitonic network: log2(n)*(log2(n)+1)/2 compare-exchange sweeps."""
    log_n = max(1, math.ceil(math.log2(max(n, 2))))
    passes = log_n * (log_n + 1) // 2
    kb = 4 if p > 16 else 2
    return SortStats(
        n=n, p=p, l_n=0, passes=passes,
        bytes_read=passes * n * kb, bytes_written=passes * n * kb,
        histogram_bytes=0,
    )
