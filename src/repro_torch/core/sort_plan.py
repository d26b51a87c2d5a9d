"""SortPlan: digit decomposition of a ``p``-bit sort into bounded passes.

Port of ``repro.core.sort_plan`` (pure Python).  For keys of ``p`` bits a
:class:`SortPlan` is a sequence of stable counting passes, LSD -> MSD:
every pass ranks a digit of at most ``max_bins_log2`` bits, and the final
(MSD) pass is the *fractal* pass — its digit is the trie prefix, entries
carry only the trailing ``p - depth`` bits, and the prefix bits are
rebuilt from bin positions (Algorithm 5).

Each :class:`DigitPass` carries an optional rank-engine hint ("onehot" /
"scatter" / ``None`` = the backend picks).  Hints are execution metadata:
two plans differing only in hints sort identically.  :func:`pass_cost` /
:func:`plan_cost` are the reference's analytic cost model (in bin-column
units) and :func:`pick_engine` its per-pass argmin, kept identical so a
plan means the same thing in both packages.

:func:`convert_plan` carries a plan built by the reference (or any object
with the same fields) over to this package's types.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import fractal_tree as ft

__all__ = [
    "DEFAULT_MAX_BINS_LOG2",
    "DigitPass",
    "SortPlan",
    "convert_plan",
    "make_sort_plan",
    "pass_cost",
    "pick_engine",
    "plan_cost",
    "quantize_sort_bits",
    "rank_chunk_len",
    "scatter_tile_len",
]

# Default per-pass bin-count cap (2**4 = 16 bins): the reference's default,
# kept so both packages build the same plan from the same arguments.
DEFAULT_MAX_BINS_LOG2 = 4

# Floor on the digit width for very small inputs: below this, per-pass
# overhead dominates any one-hot-tile savings.
_MIN_DIGIT_BITS = 4

# Element budget for the rank stage's (chunk x n_bins) one-hot tile.
_RANK_TILE_BUDGET = 1 << 21

# The segment-aware grouped-trailing mode keeps a (2**depth, 2**w) per-
# segment digit table; past this margin (log2) over the key count, or the
# absolute cap, the table dwarfs the key stream.
_GROUPED_TABLE_MARGIN_LOG2 = 4
_GROUPED_TABLE_LOG2_CAP = 20

ENGINES = ("onehot", "scatter")


def quantize_sort_bits(eff: int, width: int, step: int = 8) -> int:
    """Round a partition's effective sort width up to a multiple of
    ``step`` bits, capped at the stored word width.  Safe because the
    rounded-up bits are part of the partition's shared prefix."""
    if eff <= 0:
        return 0
    return min(-(-eff // step) * step, width)


def rank_chunk_len(n_bins: int, base: int = 1024) -> int:
    """Execution hint: rank-stage chunk length for an ``n_bins``-bin pass,
    bounding the materialized one-hot tile at ``_RANK_TILE_BUDGET``."""
    return max(8, min(base, _RANK_TILE_BUDGET // max(n_bins, 1)))


# Scatter-engine tile bounds (elements per sorted tile).
_SCATTER_TILE_MIN = 1 << 11
_SCATTER_TILE_MAX = 1 << 13


def scatter_tile_len(n_bins: int, base: int = 1024) -> int:
    """Execution hint: sorted-tile length for a scatter-engine pass.  It
    grows with ``n_bins`` (so the per-tile (tiles, n_bins) table stays
    small next to the key stream); ``base`` only ever raises the floor."""
    tile = 1 << max(n_bins - 1, 1).bit_length()  # next_pow2(n_bins)
    return max(min(max(tile, _SCATTER_TILE_MIN), _SCATTER_TILE_MAX), base)


# Analytic per-pass cost model: one unit is one elementwise op over an
# n-row one-hot bin column.  The constants are the reference's, so the
# model's engine picks agree across packages.
_SCATTER_BASE_UNITS = 32
_SCATTER_TABLE_UNITS = 8


def pass_cost(n: int, bits: int, engine: str) -> float:
    """Analytic rank cost of one ``bits``-wide pass over ``n`` keys, in
    bin-column units."""
    n_bins = 1 << bits
    if engine == "onehot":
        return float(n) * n_bins
    if engine != "scatter":
        raise ValueError(f"unknown engine {engine!r}")
    tile = scatter_tile_len(n_bins)
    return float(n) * (_SCATTER_BASE_UNITS
                       + _SCATTER_TABLE_UNITS * n_bins / tile)


def pick_engine(n: int, bits: int) -> str:
    """The cost model's per-pass engine argmin (the default a torch-op
    backend applies when a pass carries no hint)."""
    return min(ENGINES, key=lambda e: pass_cost(n, bits, e))


def plan_cost(plan: "SortPlan", engine: Optional[str] = None) -> float:
    """Analytic rank cost of a whole plan: per-pass costs under each
    pass's hint, ``engine`` overriding unhinted passes (``None`` = the
    model's own pick)."""
    return sum(pass_cost(plan.n, d.bits,
                         d.engine or engine or pick_engine(plan.n, d.bits))
               for d in plan.passes)


@dataclasses.dataclass(frozen=True)
class DigitPass:
    """One stable counting pass over key bits ``[shift, shift + bits)``.

    ``engine`` is an execution hint — "onehot", "scatter" or ``None``
    (backend picks).  Hints never change the sorted output."""

    shift: int
    bits: int
    kind: str = "lsd"  # "lsd" = full-key scatter; "msd" = fractal/reconstruct
    engine: Optional[str] = None

    @property
    def n_bins(self) -> int:
        return 1 << self.bits

    def rank_batch(self, base: int = 1024) -> int:
        """Per-pass execution hint: the rank chunk length (one-hot) or
        sorted-tile length (scatter)."""
        if self.engine == "scatter":
            return scatter_tile_len(self.n_bins, base)
        return rank_chunk_len(self.n_bins, base)


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """Pass sequence for a ``p``-bit sort of ``n`` keys, LSD -> MSD."""

    n: int
    p: int
    passes: tuple  # tuple[DigitPass, ...], contiguous, covering bits [0, p)

    @property
    def depth(self) -> int:
        """Trie depth of the final (MSD/fractal) pass (0 for ``p=0``)."""
        return self.passes[-1].bits if self.passes else 0

    @property
    def trailing_bits(self) -> int:
        """Entry payload width of the final pass (bits below the prefix)."""
        return self.passes[-1].shift if self.passes else 0

    @property
    def num_passes(self) -> int:
        return len(self.passes)

    @property
    def grouped_table_log2(self) -> int:
        """log2 size of the (segment, digit) table of the segment-aware
        grouped-trailing mode."""
        lsd_bits = max((d.bits for d in self.passes[:-1]), default=0)
        return self.depth + lsd_bits

    @property
    def supports_grouped_trailing(self) -> bool:
        """Whether the trailing LSD passes can run segment-aware over the
        prefix-grouped array instead of re-running the full plan."""
        cap = min(_GROUPED_TABLE_LOG2_CAP,
                  ft.ceil_log2(max(self.n, 1)) + _GROUPED_TABLE_MARGIN_LOG2)
        return self.trailing_bits > 0 and self.grouped_table_log2 <= cap

    def describe(self) -> str:
        return "+".join(f"{d.bits}b" for d in self.passes) or "identity"


def convert_plan(ref_plan) -> SortPlan:
    """This package's :class:`SortPlan` for any plan-like object with
    ``n``, ``p`` and ``passes[i].{shift, bits, kind, engine}`` — e.g. one
    built by the reference planner or its autotuner."""
    return SortPlan(n=int(ref_plan.n), p=int(ref_plan.p), passes=tuple(
        DigitPass(shift=int(d.shift), bits=int(d.bits), kind=str(d.kind),
                  engine=d.engine)
        for d in ref_plan.passes))


def make_sort_plan(n: int, p: int, l_n: Optional[int] = None,
                   max_bins_log2: Optional[int] = None,
                   engine: Optional[str] = None) -> SortPlan:
    """Decompose a ``p``-bit sort of ``n`` keys into bounded digit passes.

    An explicit ``l_n`` sets the trie depth of the final pass and wins
    over the bin cap; otherwise the depth is the paper's
    L = min(p, ceil(log2 n)), capped.  ``max_bins_log2`` caps every pass's
    bin count (default :data:`DEFAULT_MAX_BINS_LOG2`).  The trailing
    ``p - depth`` bits split into balanced LSD digits no wider than the
    cap and no wider than the trie-depth scale.  ``engine`` stamps every
    pass's rank-engine hint.  ``p = 0`` yields the empty identity plan,
    and a zero-width field never emits a pass.
    """
    if not 0 <= p <= 32:
        raise ValueError(f"p={p} out of range (0..32)")
    if engine not in (None,) + ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if p == 0:
        return SortPlan(n=n, p=0, passes=())
    w_max = DEFAULT_MAX_BINS_LOG2 if max_bins_log2 is None else max_bins_log2
    if not 1 <= w_max <= 16:
        raise ValueError(f"max_bins_log2={w_max} out of range (1..16)")
    if l_n is None:
        depth = max(1, min(ft.trie_depth(n, min(p, 16)), p, w_max))
    else:
        if not 1 <= l_n <= 16:
            raise ValueError(f"l_n={l_n} out of range (1..16)")
        depth = min(l_n, p)
    t = p - depth
    passes = []
    if t > 0:
        w = max(1, min(w_max, max(_MIN_DIGIT_BITS, depth)))
        num = math.ceil(t / w)
        base, extra = divmod(t, num)
        shift = 0
        for i in range(num):
            bits = base + (1 if i < extra else 0)
            if bits > 0:  # a zero-width field is a 1-bin no-op: skip it
                passes.append(DigitPass(shift=shift, bits=bits, kind="lsd",
                                        engine=engine))
            shift += bits
    passes.append(DigitPass(shift=t, bits=depth, kind="msd", engine=engine))
    return SortPlan(n=n, p=p, passes=tuple(passes))
