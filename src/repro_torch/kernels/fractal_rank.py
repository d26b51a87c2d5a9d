"""K2 and K3: stable rank kernels — wrappers over ``csrc/fractal_rank.cu``.

Port of ``repro.kernels.fractal_rank``.  Both engines give, for a digit
stream ``keys`` in ``[0, n_bins)`` and exclusive bin starts,

    rank[i] = bin_start[keys[i]] + (earlier keys equal to keys[i]).

:func:`fractal_rank_kernel` (K2, the reference's one-hot engine) and
:func:`fractal_rank_scatter_kernel` (K3, the sorted-composite engine) are
separate kernels with separate launch counters.  The reference carries
the running per-bin count across a sequential grid.  Here both carry it
up to :data:`LOOKBACK_MAX_BINS` bins by decoupled look-back between
tiles, in one launch over a zeroed status buffer
(:func:`lookback_status_bytes`).  Above that, K2 ranks in two levels of
the same look-back, the digit's high bits (:func:`wide_hi_bins` bins)
and then its low :data:`WIDE_LO_BITS` bits over the high-major order,
with a scratch of :func:`wide_rank_scratch_bytes`; K3 takes an explicit
scan over a tile-major ``(tiles, n_bins)`` table of per-tile counts with
its 8192-key tile (:data:`SCATTER_TILE`; see the note in the CUDA
source), refused above :data:`TABLE_CAP` entries.

K2's one-sweep path also ranks a key stream on one digit, ``(key >>
shift) & (n_bins - 1)``, taken in the kernel's registers:
:func:`fractal_rank_digit` ranks a sort pass's digit so where
:func:`ranks_key_stream` holds, and makes no digit stream.

On a CPU tensor each wrapper computes the plain version
(:func:`~repro_torch.kernels.ref.rank_ref`, after
:func:`~repro_torch.kernels.ref.digit_ref` for a key stream); on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.fractal_tree import as_u32_bits, exclusive_cumsum
from repro_torch.kernels import _build, ref
from repro_torch.kernels.fractal_histogram import (fractal_histogram,
                                                   fractal_histogram_digits)

__all__ = [
    "DEFAULT_BLOCK",
    "LOOKBACK_MAX_BINS",
    "LOOKBACK_TILE",
    "SCATTER_TILE",
    "TABLE_CAP",
    "fractal_rank_kernel",
    "fractal_rank_scatter_kernel",
    "fractal_rank_counts",
    "fractal_rank_digit",
    "lookback_status_bytes",
    "lookback_tiles",
    "ranks_key_stream",
    "scatter_table_entries",
    "scatter_table_fits",
    "uses_lookback",
    "WIDE_LO_BITS",
    "wide_hi_bins",
    "wide_rank_scratch_bytes",
]

DEFAULT_BLOCK = 1024
_MAX_BINS = 1 << 16

#: Most int32 entries K3's per-tile count table may hold (1 GiB).  Its
#: tile is its 8192-key sort tile, so wide digits over long streams pass
#: the cap (at 2**16 bins, n <= 2**25 is admitted); K2 has no such table.
TABLE_CAP = 1 << 28

#: K2's one-sweep path: keys a tile (256 threads x 32; the kernel's own,
#: checked when the library loads), and the most bins it takes (one
#: look-back thread a bin); wider digits take the two-level path
LOOKBACK_TILE = 8192
LOOKBACK_MAX_BINS = 256

#: K2's two-level path: level 2 ranks a digit's low bits, level 1 the
#: rest (its high bits, at most LOOKBACK_MAX_BINS bins up to 2**16)
WIDE_LO_BITS = 8

#: K3's tile: keys a CTA sorts (512 threads x 16; the kernel's own,
#: checked when the library loads).  It is the tile of its look-back
#: status words (up to LOOKBACK_MAX_BINS bins) and of its count table
#: (above).
SCATTER_TILE = 8192


@functools.cache
def _lib():
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = _build.library("fractal_rank", {
        "fs_rank_wide": [vp, ll, vp, vp, vp, i, vp, ll, vp],
        "fs_rank_lookback": [vp, ll, vp, vp, i, vp, i, ctypes.c_uint, vp],
        "fs_rank_lookback_tile": [],
        "fs_rank_scatter_tile": [],
        "fs_rank_scatter_lookback": [vp, ll, vp, vp, i, vp, vp],
        "fs_rank_scatter_counts": [vp, ll, vp, i, vp],
        "fs_rank_scatter": [vp, ll, vp, vp, i, vp],
    })
    for what, tile, want in (
            ("look-back kernel", lib.fs_rank_lookback_tile(), LOOKBACK_TILE),
            ("scatter kernel", lib.fs_rank_scatter_tile(), SCATTER_TILE)):
        if tile != want:
            raise RuntimeError(f"the {what}'s tile is {tile} keys, the "
                               f"wrapper's is {want}")
    return lib


def uses_lookback(n_bins: int) -> bool:
    """Whether K2 ranks ``n_bins`` bins in one look-back sweep (else in
    two levels of it)."""
    return n_bins <= LOOKBACK_MAX_BINS


def lookback_tiles(n: int, tile: int = LOOKBACK_TILE) -> int:
    """Tiles of ``tile`` keys over ``n`` keys (K2's look-back tile by
    default; K3 passes :data:`SCATTER_TILE`)."""
    return -(-n // tile)


def lookback_status_bytes(n: int, n_bins: int,
                          tile: int = LOOKBACK_TILE) -> int:
    """Bytes of the look-back status buffer: one 64-bit word per (tile,
    bin), then the tile counter."""
    return 8 * (lookback_tiles(n, tile) * n_bins + 1)


def wide_hi_bins(n_bins: int) -> int:
    """Bins of the high part of a digit of ``n_bins`` bins once its low
    :data:`WIDE_LO_BITS` bits are split off: K2's level-1 bins."""
    return -(-n_bins // (1 << WIDE_LO_BITS))


def wide_rank_scratch_bytes(n: int, n_bins: int) -> int:
    """Bytes of K2's two-level scratch above :data:`LOOKBACK_MAX_BINS`
    bins (the CUDA entry refuses less), each region rounded up to 16
    bytes: both levels' status buffers (:func:`lookback_status_bytes` at
    the high bins and at 2**WIDE_LO_BITS bins), the high-major digit
    stream and its ranks (4 bytes a key each), each tile's run slots and
    valid keys (4 bytes each), the digits' bases (4 bytes a bin), the high
    bins' starts and the low level's zero starts."""
    def up(b: int) -> int:
        return -(-b // 16) * 16

    n_hi = wide_hi_bins(n_bins)
    return (up(lookback_status_bytes(n, n_hi))
            + up(lookback_status_bytes(n, 1 << WIDE_LO_BITS))
            + 2 * up(4 * n) + up(4 * lookback_tiles(n) * (n_hi + 1))
            + up(4 * n_bins) + up(4 * n_hi) + 4 * (1 << WIDE_LO_BITS))


def scatter_table_entries(n: int, n_bins: int) -> int:
    """Entries of K3's ``(tiles, n_bins)`` count table: 0 up to
    :data:`LOOKBACK_MAX_BINS` bins, where it carries by look-back."""
    return (0 if uses_lookback(n_bins)
            else lookback_tiles(n, SCATTER_TILE) * n_bins)


def scatter_table_fits(n: int, n_bins: int) -> bool:
    """Whether K3 takes ``n`` keys over ``n_bins`` bins: its count table
    stays within :data:`TABLE_CAP` entries (at 2**16 bins, n <= 2**25)."""
    return scatter_table_entries(n, n_bins) <= TABLE_CAP


def _check_table(tiles: int, n_bins: int) -> None:
    if tiles * n_bins > TABLE_CAP:
        raise ValueError(
            f"rank table of {tiles} tiles x {n_bins} bins passes the cap of "
            f"{TABLE_CAP} entries; use a narrower digit or the other engine")


def _check_shift(n_bins: int, shift: int) -> None:
    """K2 takes a key stream's ``shift`` only on its one-sweep path."""
    if not uses_lookback(n_bins):
        raise ValueError(
            f"a shift takes K2's one-sweep path, up to {LOOKBACK_MAX_BINS} "
            f"bins, not {n_bins}; extract the digit")
    if not 0 <= shift <= 31:
        raise ValueError(f"shift={shift} out of range (0..31)")


def _check_args(keys: torch.Tensor, bin_start: torch.Tensor, n_bins: int):
    if not 1 <= n_bins <= _MAX_BINS:
        raise ValueError(f"n_bins={n_bins} out of range (1..{_MAX_BINS})")
    _build.check_operand(keys, "keys")
    _build.check_operand(bin_start, "bin_start", n_bins)


def _scatter_tile_starts(keys: torch.Tensor, bin_start: torch.Tensor,
                         n_bins: int) -> torch.Tensor:
    """K3's explicit carry scan: per-tile counts (kernel) into a zeroed
    tile-major table, each CTA writing its own row; then each tile's
    starting slot per bin = bin_start + that bin's counts in all earlier
    tiles (an exclusive cumulative sum down the tiles)."""
    n = keys.shape[0]
    tiles = lookback_tiles(n, SCATTER_TILE)
    _check_table(tiles, n_bins)
    table = torch.zeros((tiles, n_bins), dtype=torch.int32,
                        device=keys.device)
    _build.check(_lib().fs_rank_scatter_counts(
        keys.data_ptr(), n, table.data_ptr(), n_bins,
        _build.stream(keys.device)), "fs_rank_scatter_counts")
    starts = torch.cumsum(table, 0, dtype=torch.int32)
    starts -= table
    starts += bin_start
    return starts


def fractal_rank_kernel(keys: torch.Tensor, bin_start: torch.Tensor,
                        n_bins: int, block: int = DEFAULT_BLOCK,
                        counts: Optional[torch.Tensor] = None, *,
                        shift: Optional[int] = None) -> torch.Tensor:
    """K2: stable output slot per key given exclusive bin starts.
    ``keys`` is int32 in ``[0, n_bins)``; ``bin_start`` is ``(n_bins,)``
    int32.  Keys outside the range get rank 0.  ``block`` is the
    reference's argument (checked, no tile here).  Above
    :data:`LOOKBACK_MAX_BINS` bins the two-level path takes ``counts``,
    the histogram of ``keys`` over ``[0, n_bins)``, or launches K1 for it;
    up to that, ``counts`` is not read.

    With a ``shift``, ``keys`` is a key stream (int32 storage of uint32
    bits) and each key is ranked on its digit ``(key >> shift) & (n_bins -
    1)`` (:func:`~repro_torch.kernels.ref.digit_ref`), which the kernel
    takes in registers: no digit stream is made.  Only the one-sweep path
    takes one (at most :data:`LOOKBACK_MAX_BINS` bins); elsewhere it
    raises ValueError."""
    if shift is not None:
        _check_shift(n_bins, shift)
    if keys.device.type == "cpu":
        if shift is not None:
            keys = ref.digit_ref(keys, shift, n_bins - 1)
        return ref.rank_ref(keys, bin_start, n_bins)
    _check_args(keys, bin_start, n_bins)
    if block < 1:
        raise ValueError(f"block={block} must be positive")
    n = keys.shape[0]
    rank = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if not n:
        return rank
    if uses_lookback(n_bins):
        status = torch.zeros(lookback_status_bytes(n, n_bins) // 8,
                             dtype=torch.int64, device=keys.device)
        _build.check(_lib().fs_rank_lookback(
            keys.data_ptr(), n, bin_start.data_ptr(), rank.data_ptr(),
            n_bins, status.data_ptr(), shift or 0,
            0xFFFFFFFF if shift is None else n_bins - 1,
            _build.stream(keys.device)), "fractal_rank_kernel")
    else:
        if counts is None:
            counts = fractal_histogram(keys, n_bins)
        _build.check_operand(counts, "counts", n_bins)
        scratch = torch.empty(wide_rank_scratch_bytes(n, n_bins),
                              dtype=torch.uint8, device=keys.device)
        _build.check(_lib().fs_rank_wide(
            keys.data_ptr(), n, counts.data_ptr(), bin_start.data_ptr(),
            rank.data_ptr(), n_bins, scratch.data_ptr(), scratch.numel(),
            _build.stream(keys.device)), "fractal_rank_kernel")
    _build.count_launch(fractal_rank_kernel)
    return rank


fractal_rank_kernel.launches = 0


def fractal_rank_scatter_kernel(keys: torch.Tensor, bin_start: torch.Tensor,
                                n_bins: int,
                                block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """K3: the same ranks as :func:`fractal_rank_kernel`, from a stable
    radix sort of ``(digit, position)`` composites in each 8192-key tile
    (:data:`SCATTER_TILE`).  ``block`` is the reference's sort block: a
    power of two with ``n_bins << log2(block) < 2**32``, checked as the
    reference does; the CUDA kernel sorts its own tile whatever it is.  Up
    to :data:`LOOKBACK_MAX_BINS` bins one launch carries the counts
    between tiles by look-back; above, a counting launch, a cumulative sum
    over the table and the rank launch."""
    if block < 1 or block & (block - 1):
        raise ValueError(f"block={block} must be a power of two")
    if n_bins << (block.bit_length() - 1) >= 1 << 32:
        raise ValueError(f"composite packing overflow: n_bins={n_bins} "
                         f"block={block}")
    if keys.device.type == "cpu":
        return ref.rank_ref(keys, bin_start, n_bins)
    _check_args(keys, bin_start, n_bins)
    n = keys.shape[0]
    rank = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n and uses_lookback(n_bins):
        status = torch.zeros(
            lookback_status_bytes(n, n_bins, SCATTER_TILE) // 8,
            dtype=torch.int64, device=keys.device)
        _build.check(_lib().fs_rank_scatter_lookback(
            keys.data_ptr(), n, bin_start.data_ptr(), rank.data_ptr(),
            n_bins, status.data_ptr(), _build.stream(keys.device)),
            "fractal_rank_scatter_kernel")
        _build.count_launch(fractal_rank_scatter_kernel)
    elif n:
        starts = _scatter_tile_starts(keys, bin_start, n_bins)
        _build.check(_lib().fs_rank_scatter(
            keys.data_ptr(), n, starts.data_ptr(), rank.data_ptr(), n_bins,
            _build.stream(keys.device)), "fractal_rank_scatter_kernel")
        _build.count_launch(fractal_rank_scatter_kernel)
    return rank


fractal_rank_scatter_kernel.launches = 0


def fractal_rank_counts(digit: torch.Tensor, n_bins: int,
                        block: int = DEFAULT_BLOCK,
                        bin_start: Optional[torch.Tensor] = None,
                        engine: Optional[str] = None,
                        counts: Optional[torch.Tensor] = None):
    """Kernel-path rank primitive on an extracted digit stream: the
    digit's counts → exclusive scan → the ``engine``'s rank kernel
    (``None`` and "onehot" → K2, which takes the counts too, "scatter" →
    K3).  The counts are ``counts`` when given (a sort takes every pass's
    counts from one K1 sweep before its pass loop), else one K1 launch on
    ``digit``.

    Returns ``(rank, counts, carry_out)`` with ``carry_out == counts`` —
    the executor's streaming-carry contract; a call starts from zero
    carry.  ``bin_start`` may be supplied when the global histogram is
    already known."""
    if engine not in (None, "onehot", "scatter"):
        raise ValueError(f"unknown kernel rank engine {engine!r}")
    if counts is None:
        counts = fractal_histogram(digit, n_bins)
    if bin_start is None:
        bin_start = exclusive_cumsum(counts)
    if engine == "scatter":
        rank = fractal_rank_scatter_kernel(digit, bin_start, n_bins,
                                           block=block)
    else:
        rank = fractal_rank_kernel(digit, bin_start, n_bins, block=block,
                                   counts=counts)
    return rank, counts, counts


def ranks_key_stream(digit_pass) -> bool:
    """Whether :func:`fractal_rank_digit` hands K2 the key stream for this
    pass (K2's one sweep, at most :data:`LOOKBACK_MAX_BINS` bins, and a
    pass not on K3) rather than an extracted digit."""
    return uses_lookback(digit_pass.n_bins) and digit_pass.engine != "scatter"


def fractal_rank_digit(keys: torch.Tensor, digit_pass,
                       block: int = DEFAULT_BLOCK,
                       bin_start: Optional[torch.Tensor] = None,
                       counts: Optional[torch.Tensor] = None):
    """Stable ranks on one :class:`~repro_torch.core.sort_plan.DigitPass`
    digit of the raw key stream, under the pass's engine hint.  Where
    :func:`ranks_key_stream` holds, K2 reads the key stream and takes the
    digit itself (its counts ``counts``, or one K1 sweep of the key
    stream); otherwise the digit is extracted and ranked.  Returns
    ``(rank, counts)``."""
    dp = digit_pass
    u = as_u32_bits(keys).contiguous()
    if not ranks_key_stream(dp):
        digit = (u >> dp.shift) & (dp.n_bins - 1)
        rank, counts, _ = fractal_rank_counts(digit, dp.n_bins, block=block,
                                              bin_start=bin_start,
                                              engine=dp.engine, counts=counts)
        return rank, counts
    if counts is None:
        (counts,) = fractal_histogram_digits(u, (dp,))
    if bin_start is None:
        bin_start = exclusive_cumsum(counts)
    rank = fractal_rank_kernel(u, bin_start, dp.n_bins, block=block,
                               shift=dp.shift)
    return rank, counts
