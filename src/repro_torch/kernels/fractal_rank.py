"""K2 and K3: stable rank kernels — wrappers over ``csrc/fractal_rank.cu``.

Port of ``repro.kernels.fractal_rank``.  Both engines give, for a digit
stream ``keys`` in ``[0, n_bins)`` and exclusive bin starts,

    rank[i] = bin_start[keys[i]] + (earlier keys equal to keys[i]).

:func:`fractal_rank_kernel` (K2, the reference's one-hot engine) and
:func:`fractal_rank_scatter_kernel` (K3, the sorted-composite engine) are
separate kernels with separate launch counters.  The reference carries
the running per-bin count across a sequential grid; here it is an
explicit scan over an ``(n_bins, tiles)`` table of per-tile counts (see
the note in the CUDA source).  The table is refused above
:data:`TABLE_CAP` entries.

On a CPU tensor each wrapper computes the plain version
(:func:`~repro_torch.kernels.ref.rank_ref`); on a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.fractal_tree import as_u32_bits, exclusive_cumsum
from repro_torch.kernels import _build, ref
from repro_torch.kernels.fractal_histogram import fractal_histogram

__all__ = [
    "DEFAULT_BLOCK",
    "TABLE_CAP",
    "fractal_rank_kernel",
    "fractal_rank_scatter_kernel",
    "fractal_rank_counts",
    "fractal_rank_digit",
    "onehot_tile_len",
]

DEFAULT_BLOCK = 1024
_MAX_BINS = 1 << 16

#: Most int32 entries the per-tile count table may hold (1 GiB).  K2's
#: tile grows with n_bins so its table never exceeds the key count (plus
#: one tile); K3's tile is its sort block, so wide digits over long
#: streams pass the cap.
TABLE_CAP = 1 << 28


@functools.cache
def _lib():
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _build.library("fractal_rank", {
        "fs_rank_tile_counts": [vp, ll, vp, i, i, vp],
        "fs_rank_onehot": [vp, ll, vp, vp, i, i, vp],
        "fs_rank_scatter": [vp, ll, vp, vp, i, i, vp],
    })


def onehot_tile_len(n_bins: int, block: int = DEFAULT_BLOCK) -> int:
    """K2's tile: at least ``block`` keys and at least ``n_bins``, so the
    (n_bins, tiles) table holds no more entries than keys (plus a tile)."""
    return max(block, 1 << max(n_bins - 1, 0).bit_length())


def _check_args(keys: torch.Tensor, bin_start: torch.Tensor, n_bins: int):
    if not 1 <= n_bins <= _MAX_BINS:
        raise ValueError(f"n_bins={n_bins} out of range (1..{_MAX_BINS})")
    _build.check_operand(keys, "keys")
    _build.check_operand(bin_start, "bin_start", n_bins)


def _tile_starts(keys: torch.Tensor, bin_start: torch.Tensor, n_bins: int,
                 tile: int) -> torch.Tensor:
    """The explicit carry scan: per-tile counts (kernel), then each tile's
    starting slot per bin = bin_start + counts of all earlier tiles."""
    n = keys.shape[0]
    tiles = -(-n // tile)
    if tiles * n_bins > TABLE_CAP:
        raise ValueError(
            f"rank table of {tiles} tiles x {n_bins} bins passes the cap of "
            f"{TABLE_CAP} entries; use a narrower digit or the other engine")
    # bin-major: flattened, it is in stable counting-sort order, so one
    # 1-D exclusive scan gives every (bin, tile) its dense start
    table = torch.empty((n_bins, tiles), dtype=torch.int32, device=keys.device)
    _build.check(_lib().fs_rank_tile_counts(
        keys.data_ptr(), n, table.data_ptr(), n_bins, tile,
        _build.stream(keys.device)), "fs_rank_tile_counts")
    flat = table.view(-1)
    starts = torch.cumsum(flat, 0, dtype=torch.int32)
    starts -= flat
    starts = starts.view(n_bins, tiles)
    starts += (bin_start - starts[:, 0])[:, None]  # dense start -> bin_start
    return starts


def fractal_rank_kernel(keys: torch.Tensor, bin_start: torch.Tensor,
                        n_bins: int,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """K2: stable output slot per key given exclusive bin starts.
    ``keys`` is int32 in ``[0, n_bins)``; ``bin_start`` is ``(n_bins,)``
    int32.  Keys outside the range get rank 0."""
    if keys.device.type == "cpu":
        return ref.rank_ref(keys, bin_start, n_bins)
    _check_args(keys, bin_start, n_bins)
    if block < 1:
        raise ValueError(f"block={block} must be positive")
    n = keys.shape[0]
    rank = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n:
        tile = onehot_tile_len(n_bins, block)
        starts = _tile_starts(keys, bin_start, n_bins, tile)
        _build.check(_lib().fs_rank_onehot(
            keys.data_ptr(), n, starts.data_ptr(), rank.data_ptr(), n_bins,
            tile, _build.stream(keys.device)), "fractal_rank_kernel")
        fractal_rank_kernel.launches += 1
    return rank


fractal_rank_kernel.launches = 0


def fractal_rank_scatter_kernel(keys: torch.Tensor, bin_start: torch.Tensor,
                                n_bins: int,
                                block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """K3: the same ranks as :func:`fractal_rank_kernel`, from a stable
    block radix sort of ``digit << log2(block) | position`` composites.
    ``block`` must be a power of two (at most 1024 on the card) with
    ``n_bins << log2(block) < 2**32``."""
    if block < 1 or block & (block - 1):
        raise ValueError(f"block={block} must be a power of two")
    if n_bins << (block.bit_length() - 1) >= 1 << 32:
        raise ValueError(f"composite packing overflow: n_bins={n_bins} "
                         f"block={block}")
    if keys.device.type == "cpu":
        return ref.rank_ref(keys, bin_start, n_bins)
    _check_args(keys, bin_start, n_bins)
    if not 32 <= block <= 1024:
        raise ValueError(f"block={block}: the CUDA kernel sorts 32..1024 "
                         f"keys a block")
    n = keys.shape[0]
    rank = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n:
        starts = _tile_starts(keys, bin_start, n_bins, block)
        _build.check(_lib().fs_rank_scatter(
            keys.data_ptr(), n, starts.data_ptr(), rank.data_ptr(), n_bins,
            block, _build.stream(keys.device)), "fractal_rank_scatter_kernel")
        fractal_rank_scatter_kernel.launches += 1
    return rank


fractal_rank_scatter_kernel.launches = 0


def fractal_rank_counts(digit: torch.Tensor, n_bins: int,
                        block: int = DEFAULT_BLOCK,
                        bin_start: Optional[torch.Tensor] = None,
                        engine: Optional[str] = None):
    """Kernel-path rank primitive on an extracted digit stream: histogram
    kernel → exclusive scan → the ``engine``'s rank kernel (``None`` and
    "onehot" → K2, "scatter" → K3).

    Returns ``(rank, counts, carry_out)`` with ``carry_out == counts`` —
    the executor's streaming-carry contract; a call starts from zero
    carry.  ``bin_start`` may be supplied when the global histogram is
    already known."""
    if engine not in (None, "onehot", "scatter"):
        raise ValueError(f"unknown kernel rank engine {engine!r}")
    counts = fractal_histogram(digit, n_bins)
    if bin_start is None:
        bin_start = exclusive_cumsum(counts)
    kernel = (fractal_rank_scatter_kernel if engine == "scatter"
              else fractal_rank_kernel)
    rank = kernel(digit, bin_start, n_bins, block=block)
    return rank, counts, counts


def fractal_rank_digit(keys: torch.Tensor, digit_pass,
                       block: int = DEFAULT_BLOCK,
                       bin_start: Optional[torch.Tensor] = None):
    """Stable ranks on one :class:`~repro_torch.core.sort_plan.DigitPass`
    digit of the raw key stream, under the pass's engine hint.  Returns
    ``(rank, counts)``."""
    dp = digit_pass
    digit = ((as_u32_bits(keys) >> dp.shift) & (dp.n_bins - 1)).contiguous()
    rank, counts, _ = fractal_rank_counts(digit, dp.n_bins, block=block,
                                          bin_start=bin_start,
                                          engine=dp.engine)
    return rank, counts
