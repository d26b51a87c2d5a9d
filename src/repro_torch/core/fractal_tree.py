"""Implicit width-tapered binary-trie histogram — the paper's "fractal" structure.

Port of ``repro.core.fractal_tree``.  Level ``l`` is a flat array of
``2**l`` counters indexed by the key's ``l``-bit MSB prefix (the paper's
computable-location trie built MSB-first, so the leaf index *is* the
numeric prefix; ``bit_reverse`` is kept for the LSB-first equivalence).

Counter-width tapering: a balanced subtree at level ``l`` holds about
``n / 2**l`` keys, so its counter needs ``ceil(log2 n) - l`` bits (paper
§III.D.1).  Per-level storage dtypes taper to the narrowest of
{uint8, uint16, uint32} with a skew margin; counters accumulate as int32
and :func:`taper_levels` reports saturation.

Keys may arrive as int32 storage of uint32 bits (the port's key stream),
as ``torch.uint32`` or as any other integer dtype; :func:`as_u32_bits`
normalizes them.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "as_u32_bits",
    "wrap_int32",
    "u32_to_int64",
    "ceil_log2",
    "exclusive_cumsum",
    "trie_depth",
    "tapered_dtype",
    "tapered_bits",
    "bit_reverse",
    "FractalHistogram",
    "build_histogram",
    "merge_histograms",
    "taper_levels",
    "histogram_nbytes",
    "get_item",
    "get_index",
]

# Skew margin (extra bits) on top of the balanced-subtree width estimate.
_TAPER_MARGIN_BITS = 2

_U32_MASK = 0xFFFFFFFF


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Integer values taken modulo 2**32, as int32 bit patterns (the wrap
    of the reference's int32/uint32 arithmetic)."""
    x = x.to(torch.int64) & _U32_MASK
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def as_u32_bits(keys: torch.Tensor) -> torch.Tensor:
    """The key stream as int32 storage holding each key's uint32 bits
    (what ``keys.astype(uint32)`` gives in the reference: values wrap
    modulo 2**32)."""
    if keys.dtype == torch.int32:
        return keys
    if keys.dtype == torch.uint32:
        return keys.view(torch.int32)
    return wrap_int32(keys)


def u32_to_int64(u: torch.Tensor) -> torch.Tensor:
    """Unsigned value of int32 storage holding uint32 bits, as int64 (for
    logical shifts and compares, which torch lacks on ``uint32``)."""
    return as_u32_bits(u).to(torch.int64) & _U32_MASK


def exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a 1-D int count array (bin starts from bin
    counts), in the counts' dtype."""
    zero = torch.zeros((1,), dtype=counts.dtype, device=counts.device)
    return torch.cat([zero, torch.cumsum(counts, 0, dtype=counts.dtype)[:-1]])


def ceil_log2(n: int) -> int:
    """ceil(log2(n)) for n >= 1 (0 -> 0)."""
    if n <= 1:
        return 0
    return (int(n) - 1).bit_length()


def trie_depth(n: int, p: int, l_max: int = 16) -> int:
    """L = min(p, ceil(log2 n)) (paper §III.B.1), capped at ``l_max``
    (the dense leaf level holds at most ``2**l_max`` counters)."""
    return max(1, min(p, ceil_log2(n), l_max))


def tapered_bits(level: int, log2n: int, margin: int = _TAPER_MARGIN_BITS) -> int:
    """Significant counter bits at ``level``: w_{c,l} = O(ceil(log2 n) - l)."""
    return max(1, log2n - level + margin)


def tapered_dtype(level: int, log2n: int, margin: int = _TAPER_MARGIN_BITS):
    """Narrowest unsigned torch dtype holding ``tapered_bits``."""
    bits = tapered_bits(level, log2n, margin)
    if bits <= 8:
        return torch.uint8
    if bits <= 16:
        return torch.uint16
    return torch.uint32


def bit_reverse(x: torch.Tensor, width: int) -> torch.Tensor:
    """Reverse the low ``width`` bits of ``x`` (Algorithm 5's BitReverse)."""
    x = u32_to_int64(x)
    out = torch.zeros_like(x)
    for i in range(width):
        out = out | (((x >> i) & 1) << (width - 1 - i))
    return out.to(torch.int32)


@dataclasses.dataclass
class FractalHistogram:
    """All trie levels root→leaf.  ``levels[l]`` has ``2**l`` int32
    counters; :func:`taper_levels` produces the tapered storage form."""

    levels: tuple  # tuple[torch.Tensor]; levels[l].shape == (2**l,)
    p: int  # key precision in bits
    depth: int  # leaf level index L (levels has L+1 entries, root=levels[0])

    @property
    def leaf_counts(self) -> torch.Tensor:
        return self.levels[-1]

    @property
    def total(self) -> torch.Tensor:
        return self.levels[0][0]


def build_histogram(keys: torch.Tensor, p: int, depth: int) -> FractalHistogram:
    """Build the full trie bottom-up: the leaf level is a bincount of the
    ``depth``-bit MSB prefixes, level ``l-1`` the pairwise sum of level
    ``l``.  Prefixes outside the leaf range (keys wider than ``p``) are
    dropped, as the reference's scatter drops them."""
    prefix = u32_to_int64(keys) >> (p - depth)
    n_leaf = 1 << depth
    prefix = prefix[prefix < n_leaf]
    leaf = torch.zeros((n_leaf,), dtype=torch.int32, device=keys.device)
    leaf.index_add_(0, prefix, torch.ones_like(prefix, dtype=torch.int32))
    levels = [leaf]
    cur = leaf
    for _ in range(depth):
        cur = cur.reshape(-1, 2).sum(dim=1, dtype=torch.int32)
        levels.append(cur)
    levels.reverse()
    return FractalHistogram(levels=tuple(levels), p=p, depth=depth)


def merge_histograms(a: FractalHistogram, b: FractalHistogram) -> FractalHistogram:
    """Batch-streaming merge (paper §III.D): elementwise add per level."""
    if a.p != b.p or a.depth != b.depth:
        raise ValueError(f"cannot merge histograms of (p, depth) "
                         f"{(a.p, a.depth)} and {(b.p, b.depth)}")
    return FractalHistogram(
        levels=tuple(x + y for x, y in zip(a.levels, b.levels)),
        p=a.p,
        depth=a.depth,
    )


def taper_levels(h: FractalHistogram, n_hint: int | None = None):
    """Tapered storage form: per-level narrow dtypes + saturation flag.

    Returns ``(tapered_levels, saturated)`` where ``saturated`` is a bool
    tensor — True when any counter exceeded its tapered width.
    """
    n = n_hint if n_hint is not None else int(1) << h.depth
    log2n = ceil_log2(n)
    tapered = []
    saturated = torch.zeros((), dtype=torch.bool, device=h.levels[0].device)
    for l, lvl in enumerate(h.levels):
        dt = tapered_dtype(l, log2n)
        limit = min(torch.iinfo(dt).max, torch.iinfo(lvl.dtype).max)
        saturated = saturated | torch.any(lvl > limit)
        tapered.append(torch.clip(lvl, 0, limit).to(dt))
    return tuple(tapered), saturated


def histogram_nbytes(h: FractalHistogram, tapered: bool, n_hint: int | None = None) -> int:
    """Analytic storage footprint (bytes) — feeds the b_eff accounting."""
    n = n_hint if n_hint is not None else int(1) << h.depth
    log2n = ceil_log2(n)
    total = 0
    for l, lvl in enumerate(h.levels):
        if tapered:
            itemsize = tapered_dtype(l, log2n).itemsize
        else:
            itemsize = lvl.dtype.itemsize
        total += int(lvl.shape[0]) * itemsize
    return total


def get_item(h: FractalHistogram, index) -> torch.Tensor:
    """Value (leaf prefix) at sorted ``index`` — Algorithm 2, vectorized:
    walk root→leaf choosing the child by the left-child count."""
    rem = torch.as_tensor(index, dtype=torch.int32, device=h.levels[0].device)
    node = torch.zeros_like(rem, dtype=torch.int64)
    for l in range(1, h.depth + 1):
        left = h.levels[l][2 * node]
        go_right = rem >= left
        rem = torch.where(go_right, rem - left, rem)
        node = 2 * node + go_right.to(torch.int64)
    return node.to(torch.int32)


def get_index(h: FractalHistogram, value) -> torch.Tensor:
    """First sorted index of leaf ``value`` — Algorithm 3, vectorized:
    walk the value's bit path, accumulating left-sibling counts."""
    value = torch.as_tensor(value, dtype=torch.int32, device=h.levels[0].device)
    idx = torch.zeros_like(value)
    node = torch.zeros_like(value, dtype=torch.int64)
    for l in range(1, h.depth + 1):
        bit = ((value >> (h.depth - l)) & 1).to(torch.int64)
        left = h.levels[l][2 * node]
        idx = idx + torch.where(bit == 1, left, torch.zeros_like(left))
        node = 2 * node + bit
    return idx
