"""Sort-backed relational operators, every one bottoming out in the
:class:`~repro_torch.core.executor.PlanExecutor`.

Port of ``repro.query.operators``: ``order_by`` (multi-column asc/desc),
``sort_merge_join`` (inner), ``group_by`` (sum/count/min/max over
segments of the sorted key), ``distinct`` and ``top_k``.  The shape is
always the same:

1. **encode**: an order-preserving :mod:`~repro_torch.query.codec` turns
   the key columns into unsigned codes whose bit width sizes the
   :class:`~repro_torch.core.sort_plan.SortPlan`;
2. **sort**: one executor run carries the int32 row ids.  A full-width
   single-word code runs the pairs plan (the MSD pass rebuilds the prefix
   bits from bin positions); other codes chain one stable argsort per
   code word, least significant word first;
3. **gather / segment scan**: payload columns move by one gather of the
   row ids; group and distinct boundaries come from the sorted code
   words; joins probe one sorted run with the other by ``searchsorted``.

The sorts run on the backend of the table's device —
:class:`~repro_torch.core.executor.CudaBackend` (kernels K1–K4) on a
CUDA device, :class:`~repro_torch.core.executor.TorchBackend` on the CPU
— or on the one that the keyword-only ``backend=`` ("cuda" or "torch")
names.  Data-sized work stays on the table's device; the operators bring
only scalars to the host: the used-bits probe (one word each), the group
count, the join's match count and top-k's candidate count.  No operator
grows a pass loop: the plan-pass loop stays in ``core/executor.py``.

``order_by`` / ``group_by`` / ``top_k`` also accept a
:class:`~repro_torch.stream.table_ops.StreamTable` — a chunk-streamed
table larger than its memory budget — and dispatch to the out-of-core
subsystem (:mod:`repro_torch.stream`), which routes each histogram
partition back through these same in-memory primitives; ``placement=``
(a :class:`~repro_torch.stream.chunks.PlacementStore`) holds its working
fragments.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.core import dispatch
from repro_torch.core.autotune import tuned_plan
from repro_torch.core.executor import PlanExecutor
from repro_torch.core.fractal_sort import backend_name, make_backend
from repro_torch.core.fractal_tree import as_u32_bits
from repro_torch.core.sort_plan import SortPlan
from repro_torch.obs import trace
from repro_torch.query.codec import (
    _SIGN,
    Codec,
    ColumnSpec,
    CompositeCodec,
    _u32_bits,
    infer_codec,
    word_widths,
)
from repro_torch.query.table import Table, _gather

__all__ = [
    "order_by",
    "sort_merge_join",
    "group_by",
    "distinct",
    "top_k",
    "active_words",
    "sort_rowids",
    "sort_rowids_fused",
    "sort_rowids_batched",
]

def _stream_ops(table):
    """The streaming-operator module when ``table`` is a StreamTable, else
    None for a Table (imported lazily: the query layer does not pull the
    stream subsystem in at import time)."""
    if isinstance(table, Table):
        return None
    from repro_torch.stream import table_ops

    if isinstance(table, table_ops.StreamTable):
        return table_ops
    raise TypeError(f"expected a repro_torch.query.Table or a "
                    f"repro_torch.stream.StreamTable, got "
                    f"{type(table).__name__}")


def _check_placement(stream, placement, plans) -> None:
    """A StreamTable takes any PlacementStore and no pinned plans; an
    in-memory Table takes no placement."""
    if stream is None:
        if placement is not None:
            raise ValueError(
                "placement is the out-of-core fragment store; an in-memory "
                "Table sorts in place — wrap it in a StreamTable to place it")
        return
    if plans is not None:
        raise ValueError("pinned plans don't apply out-of-core: each "
                         "partition resolves plans for its own length")
    from repro_torch.stream.chunks import PlacementStore

    if placement is not None and not isinstance(placement, PlacementStore):
        raise TypeError(
            f"placement {type(placement).__name__} is not a "
            "repro_torch.stream.PlacementStore (RunStore on disk, or "
            "DeviceShardStore over a process group)")


def _check_in_memory(table, op: str) -> None:
    if not isinstance(table, Table):
        _stream_ops(table)  # a TypeError unless a StreamTable
        raise TypeError(
            f"{op} is in-memory only; stream through order_by/group_by "
            "(repro_torch.stream) or materialize with StreamTable.to_table()")


def _normalize_by(by) -> Tuple[Tuple[str, bool], ...]:
    """``by``: one "col", or a list of "col" / ("col", asc-bool) /
    ("col", "asc"|"desc")."""
    if isinstance(by, str):
        by = [by]
    out = []
    for item in by:
        if isinstance(item, str):
            out.append((item, True))
        else:
            name, asc = item
            if isinstance(asc, str):
                if asc not in ("asc", "desc"):
                    raise ValueError(f"bad direction {asc!r}")
                asc = asc == "asc"
            out.append((name, bool(asc)))
    if not out:
        raise ValueError("need at least one key column")
    return tuple(out)


def _composite_codec(table: Table, by,
                     codecs: Optional[Mapping[str, Codec]]) -> CompositeCodec:
    """The key columns' composite codec: ``codecs[name]`` or the codec of
    the column's dtype, in key order."""
    return CompositeCodec([
        ColumnSpec((codecs or {}).get(name) or infer_codec(table.column(name)),
                   ascending=asc)
        for name, asc in _normalize_by(by)])


def _key_data(table: Table, by, codecs: Optional[Mapping[str, Codec]]):
    """(CompositeCodec, prepared key columns): the fused sort's input.
    ``prepare`` is a bitcast only; the order-preserving encode runs inside
    the sort chain (:func:`sort_rowids_fused`)."""
    codec = _composite_codec(table, by, codecs)
    return codec, codec.prepare(
        [table.column(name) for name, _ in _normalize_by(by)])


def active_words(bits: int, low_bits: Optional[int] = None,
                 ) -> Tuple[Tuple[int, int], ...]:
    """``(word index, undetermined low bits)`` pairs for a ``bits``-wide
    code, MSB word first: the words a sort must actually rank.

    ``low_bits`` narrows to the undetermined low code bits when every row
    provably shares bits ``[low_bits, bits)``: fully-shared words drop
    out and the boundary word keeps only its undetermined low bits.
    ``None`` means all bits undetermined."""
    widths = word_widths(bits)
    low_bits = bits if low_bits is None else int(low_bits)
    if not 0 <= low_bits <= bits:
        raise ValueError(f"low_bits={low_bits} not in 0..{bits}")
    active, lo = [], bits
    for j, wj in enumerate(widths):
        lo -= wj
        eff = min(low_bits - lo, wj)
        if eff > 0:
            active.append((j, eff))
    return tuple(active)


def _resolve_plans(n: int, active, plans, backend: str):
    """Per-active-word plans: caller-pinned, or one autotune-cache consult
    per active word for the pass backend ``backend`` that runs them
    (:func:`~repro_torch.core.autotune.tuned_plan`)."""
    if plans is None:
        plans = tuple(tuned_plan(n, eff, backend=backend)
                      for _, eff in active)
    if len(plans) != len(active):
        raise ValueError(f"{len(active)} active words need {len(active)} "
                         f"plans, got {len(plans)}")
    return tuple(plans)


def _word_chain(words: torch.Tensor, active, plans, rank_word):
    """Stable per-word composition: ``rank_word(word, plan)`` argsorts one
    word (gathered in the current order), least significant active word
    first; stability makes the composition lexicographic.  Returns
    ``(sorted words, row ids)``."""
    perm = torch.arange(words.shape[0], dtype=torch.int32,
                        device=words.device)
    for (j, _), plan in zip(reversed(active), reversed(plans)):
        # plan covers the word's undetermined low bits; higher bits are
        # row-invariant here, so digit passes never see them
        perm = perm[rank_word(words[perm, j], plan)]
    return words[perm], perm


def _pairs_sort(ex: PlanExecutor, keys, n: int, device, plan: SortPlan,
                encode=None):
    """The single full-width word's pairs plan: row ids ride every pass,
    the prefix bits are rebuilt from bin positions."""
    rowids = torch.arange(n, dtype=torch.int32, device=device)
    sorted_keys, rowids = ex.run_pairs(keys, rowids, plan, encode=encode)
    return as_u32_bits(sorted_keys)[:, None], rowids


@functools.lru_cache(maxsize=256)
def _rowid_chain(active: Tuple[Tuple[int, int], ...],
                 plans: Tuple[SortPlan, ...], pairs_path: bool, backend: str):
    """One sort chain per (active words, plans, pairs path, backend)
    configuration over encoded ``(n, W)`` words.  ``pairs_path`` (a
    full-width single-word code only) runs the executor's pairs plan,
    whose MSD reconstruct is valid only when the sort covers every code
    bit."""

    def chain(words):
        ex = PlanExecutor(make_backend(backend, words.device))
        if pairs_path:
            return _pairs_sort(ex, words[:, 0].contiguous(), words.shape[0],
                               words.device, plans[0])
        return _word_chain(words, active, plans, ex.run_argsort)

    return dispatch.wrap("query.chain", chain)


@functools.lru_cache(maxsize=256)
def _fused_chain(codec: CompositeCodec, active: Tuple[Tuple[int, int], ...],
                 plans: Tuple[SortPlan, ...], pairs_path: bool, backend: str):
    """The encode→sort chain from *prepared raw columns*: the pairs path
    hands ``codec.encode_fn`` to the executor's ``encode=`` hook, so pass
    0 reads digits off the encoded stream; the word chain encodes once
    and sorts word by word.  Cached by value on the codec, so equal-typed
    key columns share a chain."""

    def chain(prepped):
        first = prepped[0]
        ex = PlanExecutor(make_backend(backend, first.device))
        if pairs_path:
            return _pairs_sort(
                ex, prepped, first.shape[0], first.device, plans[0],
                encode=lambda pre: codec.encode_fn(pre)[:, 0].contiguous())
        return _word_chain(codec.encode_fn(prepped), active, plans,
                           ex.run_argsort)

    return dispatch.wrap("query.chain", chain)


def _as_words(words: torch.Tensor) -> torch.Tensor:
    """``(n, W)`` code words as int32 storage of their uint32 bits."""
    if words.dtype == torch.uint32:
        return words.view(torch.int32)
    if words.dtype != torch.int32:
        raise TypeError(f"code words must be int32 or uint32, got "
                        f"{words.dtype}")
    return words


def sort_rowids(words: torch.Tensor, bits: int,
                plans: Optional[Tuple[SortPlan, ...]] = None,
                low_bits: Optional[int] = None, *,
                backend: Optional[str] = None):
    """Stably sort ``(n, W)`` code words: ``(sorted_words, rowids)``.

    Full-width single-word codes run one executor pairs plan; everything
    else chains one stable argsort per word, least significant first.
    ``low_bits`` narrows the sort to the undetermined low code bits when
    every row shares bits ``[low_bits, bits)`` (``low_bits == 0`` returns
    arrival order).  ``plans`` pins one plan per *active* word."""
    words = _as_words(words)
    n = words.shape[0]
    if n == 0:
        return words, torch.zeros((0,), dtype=torch.int32,
                                  device=words.device)
    active = active_words(bits, low_bits)
    if not active:
        # every code bit shared: arrival order is the stable sorted order
        return words, torch.arange(n, dtype=torch.int32, device=words.device)
    backend = backend_name(backend, words.device)
    plans = _resolve_plans(n, active, plans, backend)
    widths = word_widths(bits)
    pairs_path = len(widths) == 1 and active[0][1] == widths[0]
    return _rowid_chain(active, plans, pairs_path, backend)(words)


@functools.lru_cache(maxsize=64)
def _mask_probe(codec: CompositeCodec):
    """The used-bits probe, one per codec: per code word, the largest
    ``word ^ word[0]`` across rows as an unsigned value (negative: the top
    bit varies).  Its bit length is the bit length of the OR-mask of the
    bits that vary, which is all the narrowing reads.  One
    ``aminmax`` a word; W scalars come back."""

    def spread(prepped):
        w = codec.encode_fn(prepped)
        lo, hi = torch.aminmax(w ^ w[:1], dim=0)
        return torch.where(lo < 0, lo, hi)

    return dispatch.wrap("query.probe", spread)


def sort_rowids_fused(codec: CompositeCodec, prepped,
                      plans: Optional[Tuple[SortPlan, ...]] = None, *,
                      backend: Optional[str] = None):
    """:func:`sort_rowids` from *prepared raw* key columns
    (``codec.prepare(cols)``), the encode inside the chain: ``(sorted_words,
    rowids)``.  Every in-memory operator sorts through it.

    When ``plans`` is not pinned, the used-bits probe
    (:func:`_mask_probe`) first narrows every word to the bits that vary
    across rows: the skipped bits are row-invariant, so the permutation
    is the full-width sort's while low-entropy keys shed passes.  A
    narrowed single word takes the argsort path (the pairs path's MSD
    reconstruct would zero the shared high bits of the returned words)."""
    first = prepped[0]
    n, device = first.shape[0], first.device
    widths = word_widths(codec.bits)
    if n == 0:
        return (torch.zeros((0, len(widths)), dtype=torch.int32,
                            device=device),
                torch.zeros((0,), dtype=torch.int32, device=device))
    active = active_words(codec.bits)
    if plans is None:
        used = [32 if s < 0 else s.bit_length()
                for s in _mask_probe(codec)(prepped).tolist()]  # host sync
        active = tuple((j, min(eff, used[j])) for j, eff in active if used[j])
    backend = backend_name(backend, device)
    plans = _resolve_plans(n, active, plans, backend)
    pairs_path = (len(widths) == 1 and len(active) == 1
                  and active[0][1] == widths[0])
    return _fused_chain(codec, active, plans, pairs_path, backend)(prepped)


@functools.lru_cache(maxsize=256)
def _segmented_chain(active: Tuple[Tuple[int, int], ...],
                     plans: Tuple[SortPlan, ...], seg_len_log2: int,
                     backend: str):
    """The batched chain: B concatenated equal-length partitions sort
    within their own segments, word by word through
    :meth:`~repro_torch.core.executor.PlanExecutor.run_segmented_argsort`."""

    def chain(words):
        ex = PlanExecutor(make_backend(backend, words.device))
        return _word_chain(words, active, plans, lambda col, plan:
                           ex.run_segmented_argsort(col, plan, seg_len_log2))

    return dispatch.wrap("query.segmented_chain", chain)


def sort_rowids_batched(words: torch.Tensor, bits: int, seg_len_log2: int,
                        plans: Optional[Tuple[SortPlan, ...]] = None,
                        low_bits: Optional[int] = None, *,
                        backend: Optional[str] = None):
    """Batched :func:`sort_rowids`: ``words`` holds ``B`` independent
    partitions of ``L = 2**seg_len_log2`` rows laid end to end; every
    partition sorts stably *within its own segment* in one chain
    (``rowids[b*L:(b+1)*L]`` indexes inside partition ``b``).
    ``low_bits`` and ``plans`` mean what they mean in :func:`sort_rowids`,
    with plans sized for the partition length ``L``."""
    words = _as_words(words)
    n = words.shape[0]
    L = 1 << seg_len_log2
    if n % L:
        raise ValueError(f"batch length {n} not a multiple of L={L}")
    if n == 0:
        return words, torch.zeros((0,), dtype=torch.int32,
                                  device=words.device)
    active = active_words(bits, low_bits)
    if not active:
        return words, torch.arange(n, dtype=torch.int32, device=words.device)
    backend = backend_name(backend, words.device)
    plans = _resolve_plans(L, active, plans, backend)
    return _segmented_chain(active, plans, int(seg_len_log2), backend)(words)


def _op_scope(name: str, rows: int, device: torch.device):
    """Per-operator request scope: a ``query.<name>`` span, device-timed
    on the card; traced, its counts and quantiles land in the registry
    (``span.query.<name>.wall_s`` / ``.device_s``)."""
    return trace.span(f"query.{name}", device, rows=rows)


def order_by(table: Table, by, codecs: Optional[Mapping[str, Codec]] = None,
             plans: Optional[Tuple[SortPlan, ...]] = None,
             placement=None, *, backend: Optional[str] = None) -> Table:
    """Multi-column ORDER BY (stable): rows reordered by one gather of the
    sort's row ids.  ``plans`` pins per-word sort plans.

    A StreamTable input runs out-of-core and returns a StreamTable of
    sorted runs (:func:`~repro_torch.stream.table_ops.stream_order_by`);
    ``placement`` (StreamTable only) holds the working fragments."""
    stream = _stream_ops(table)
    _check_placement(stream, placement, plans)
    if stream is not None:
        return stream.stream_order_by(table, by, codecs, placement=placement,
                                      backend=backend)
    with _op_scope("order_by", len(table), table.device):
        codec, prepped = _key_data(table, by, codecs)
        _, rowids = sort_rowids_fused(codec, prepped, plans, backend=backend)
        return table.take(rowids)


# MSD digit width of the top-k pruning histogram: wide enough that a
# uniform-ish key column prunes hard (1024 bins), narrow enough that the
# histogram is negligible next to one plan pass.
_TOPK_PRUNE_BITS = 10


@functools.lru_cache(maxsize=64)
def _prune_hist(codec: CompositeCodec, top_bits: int, shift: int,
                backend: str):
    """Top-k prune histogram from prepared raw columns: encode → leading
    ``top_bits`` digit → the backend's histogram (K1 on the card), plus
    the per-row prefix the candidate mask reads."""

    def hist(prepped):
        w0 = codec.encode_fn(prepped)[:, 0]
        prefix = ((w0 >> shift) & ((1 << top_bits) - 1)).contiguous()
        counts = make_backend(backend, w0.device).histogram(prefix,
                                                             1 << top_bits)
        return counts, prefix

    return hist


def top_k(table: Table, by, k: int,
          codecs: Optional[Mapping[str, Codec]] = None,
          plans: Optional[Tuple[SortPlan, ...]] = None,
          placement=None, *, backend: Optional[str] = None) -> Table:
    """First ``k`` rows of the stable ORDER BY (ties keep arrival order),
    *without* the full sort: one histogram of the code's leading digit
    finds the smallest digit ``cut`` whose cumulative count reaches ``k``;
    every top-k row has a leading digit ``<= cut``, and only those
    candidate rows (taken in arrival order) enter the sort.  ``plans``
    applies when the sort runs over all rows; a pruned subset resolves
    plans for its own length.  A StreamTable input prunes ahead of
    placement (:func:`~repro_torch.stream.table_ops.stream_top_k`)."""
    stream = _stream_ops(table)
    _check_placement(stream, placement, plans)
    if stream is not None:
        return stream.stream_top_k(table, by, k, codecs, store=placement,
                                   backend=backend)
    if k <= 0:
        return table.head(0)
    with _op_scope("top_k", len(table), table.device):
        return _top_k_mem(table, by, k, codecs, plans, backend)


def _top_k_mem(table: Table, by, k: int, codecs, plans, backend) -> Table:
    codec, prepped = _key_data(table, by, codecs)
    n = len(table)
    if k < n:
        width0 = word_widths(codec.bits)[0]
        top_bits = min(_TOPK_PRUNE_BITS, width0)
        counts, prefix = _prune_hist(
            codec, top_bits, width0 - top_bits,
            backend_name(backend, table.device))(prepped)
        cut = torch.searchsorted(torch.cumsum(counts, 0), torch.full(
            (1,), k, dtype=torch.int64, device=table.device))
        rows = torch.nonzero(prefix <= cut).squeeze(1)  # host sync
        if rows.shape[0] < n:
            # the candidate subset resolves its own plans: caller-pinned
            # plans were sized for n rows
            sub_pre = tuple(_gather(p, rows) for p in prepped)
            _, sub = sort_rowids_fused(codec, sub_pre, backend=backend)
            return table.take(rows[sub[:k]])
    _, rowids = sort_rowids_fused(codec, prepped, plans, backend=backend)
    return table.take(rowids[:k])


def _segment_starts(sorted_words: torch.Tensor) -> torch.Tensor:
    """True at the first row of every run of equal codes."""
    first = torch.ones((sorted_words.shape[0],), dtype=torch.bool,
                       device=sorted_words.device)
    if sorted_words.shape[0] > 1:
        first[1:] = (sorted_words[1:] != sorted_words[:-1]).any(dim=1)
    return first


def distinct(table: Table, by=None,
             codecs: Optional[Mapping[str, Codec]] = None,
             plans: Optional[Tuple[SortPlan, ...]] = None, *,
             backend: Optional[str] = None) -> Table:
    """DISTINCT ON the key columns: the first-arriving row of every
    distinct key combination, output sorted by key (the stable sort makes
    "first" well-defined)."""
    _check_in_memory(table, "distinct")
    by = _normalize_by(by if by is not None else table.column_names)
    with _op_scope("distinct", len(table), table.device):
        codec, prepped = _key_data(table, by, codecs)
        sorted_words, rowids = sort_rowids_fused(codec, prepped, plans,
                                                 backend=backend)
        starts = torch.nonzero(_segment_starts(sorted_words)).squeeze(1)
        return table.take(rowids[starts])


_AGGS = ("sum", "count", "min", "max")


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)
# min/max of these reduce in a wider signed type: torch scatters no
# uint16/uint32, and bool has no iinfo for the identity
_WIDE = {torch.bool: torch.int32, torch.uint16: torch.int32,
         torch.uint32: torch.int64}
# segment reductions keep up to this many partial results a group, one
# for each this many rows, so that a few large groups do not serialize
# the device's atomics onto a few addresses
_MAX_COPIES, _ROWS_PER_COPY = 1024, 256


def _segment_reduce(vals: torch.Tensor, seg: torch.Tensor, groups: int,
                    op: str) -> torch.Tensor:
    """``op`` over each segment of ``vals`` (``seg``: each row's segment),
    in the reference's result dtypes.  Its ``reduceat`` sums integers in
    64 bits and keeps the low 32 (an int32 result for signed and bool
    columns, uint32 for unsigned ones), which an int32 sum reproduces bit
    for bit; float sums keep the column's dtype and add in another order
    than the reference's sequential one; min and max keep the dtype.

    Row ``i`` of a group goes to partial result ``i % copies`` of that
    group (``copies`` from the rows a group), and the partials reduce
    last."""
    n, dev = vals.shape[0], vals.device
    copies = max(1, min(_MAX_COPIES, n // (groups * _ROWS_PER_COPY)))
    slot = seg if copies == 1 else (
        seg * copies + torch.arange(n, device=dev) % copies)
    if op == "sum":
        if vals.is_floating_point():
            part = torch.zeros((groups * copies,), dtype=vals.dtype,
                               device=dev).index_add_(0, slot, vals)
            return part.view(groups, copies).sum(1)
        part = torch.zeros((groups * copies,), dtype=torch.int32,
                           device=dev).index_add_(0, slot, _u32_bits(vals))
        out = part.view(groups, copies).sum(1, dtype=torch.int32)
        return out.view(torch.uint32) if vals.dtype in _UNSIGNED else out
    src = vals.to(_WIDE.get(vals.dtype, vals.dtype))
    if src.is_floating_point():
        ident = float("inf") if op == "min" else float("-inf")
    else:
        info = torch.iinfo(src.dtype)
        ident = info.max if op == "min" else info.min
    part = torch.full((groups * copies,), ident, dtype=src.dtype, device=dev)
    part.scatter_reduce_(0, slot, src, "amin" if op == "min" else "amax")
    part = part.view(groups, copies)
    out = part.amin(1) if op == "min" else part.amax(1)
    return out.to(vals.dtype)


def group_by(table: Table, by, aggs: Mapping[str, Tuple[Optional[str], str]],
             codecs: Optional[Mapping[str, Codec]] = None,
             plans: Optional[Tuple[SortPlan, ...]] = None,
             placement=None, *, backend: Optional[str] = None) -> Table:
    """GROUP BY + aggregation over segments of the sorted key.

    One sort groups equal keys into contiguous segments; every aggregate
    (``aggs``: out name → (column or None, "sum" | "count" | "min" |
    "max")) is a scatter-reduce of the gathered value column over segment
    ids, on the device.  Output: one row per group, sorted by key; key
    columns decoded from the segment-start codes.  A StreamTable input
    aggregates out-of-core, partition by partition
    (:func:`~repro_torch.stream.table_ops.stream_group_by`)."""
    stream = _stream_ops(table)
    _check_placement(stream, placement, plans)
    if stream is not None:
        return stream.stream_group_by(table, by, aggs, codecs,
                                      placement=placement, backend=backend)
    by = _normalize_by(by)
    for col, op in aggs.values():
        if op not in _AGGS:
            raise ValueError(f"bad aggregate {op!r}: one of {_AGGS}")
    with _op_scope("group_by", len(table), table.device):
        return _group_by_mem(table, by, aggs, codecs, plans, backend)


def _group_by_mem(table: Table, by, aggs, codecs, plans, backend) -> Table:
    codec, prepped = _key_data(table, by, codecs)
    sorted_words, rowids = sort_rowids_fused(codec, prepped, plans,
                                             backend=backend)
    first = _segment_starts(sorted_words)
    starts = torch.nonzero(first).squeeze(1)  # host sync: the group count
    groups, n = starts.shape[0], rowids.shape[0]
    if groups:
        key_cols = codec.decode(sorted_words.index_select(0, starts))
    else:
        key_cols = tuple(table.column(name)[:0] for name, _ in by)
    cols = {name: vals for (name, _), vals in zip(by, key_cols)}
    seg = torch.cumsum(first, 0) - 1
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])[:groups]
    rid = rowids.to(torch.int64)
    for out_name, (col, op) in aggs.items():
        if op == "count":
            cols[out_name] = (ends - starts).to(torch.int32)
            continue
        vals = _gather(table.column(col), rid)
        cols[out_name] = (_segment_reduce(vals, seg, groups, op) if groups
                          else vals[:0])
    return Table(cols, device=table.device)


def _packed(words: torch.Tensor) -> torch.Tensor:
    """One- or two-word codes as int64 in the same order: the uint64 code
    with its top bit flipped, read as signed."""
    lo = words[:, -1].to(torch.int64) & 0xFFFFFFFF
    if words.shape[1] == 1:
        return lo
    return ((words[:, 0] ^ _SIGN).to(torch.int64) << 32) | lo


def _words_searchsorted(sorted_words: torch.Tensor, queries: torch.Tensor,
                        bits: int, side: str, backend: Optional[str]):
    """Lexicographic ``searchsorted`` of each query row into a sorted
    ``(m, W)`` word matrix of a ``bits``-wide code.

    Up to two words pack into an order-preserving int64 for
    ``torch.searchsorted``.  Wider codes use the merge trick: sort the
    concatenated (sorted ∪ query) rows stably with a one-bit side flag
    as the least significant code bit (queries before equal sorted rows
    for "left", after them for "right"); a query's insertion index is
    then the count of sorted rows before it."""
    if sorted_words.shape[1] <= 2:
        return torch.searchsorted(_packed(sorted_words), _packed(queries),
                                  side=side)
    m, n = sorted_words.shape[0], queries.shape[0]
    flag_sorted = 1 if side == "left" else 0
    comb = torch.cat([sorted_words, queries])
    flags = torch.cat([
        torch.full((m,), flag_sorted, dtype=torch.int32, device=comb.device),
        torch.full((n,), 1 - flag_sorted, dtype=torch.int32,
                   device=comb.device)])
    if word_widths(bits)[-1] < 32:  # room for the flag in the last word
        comb = torch.cat([comb[:, :-1], ((comb[:, -1] << 1) | flags)[:, None]],
                         dim=1)
    else:
        comb = torch.cat([comb, flags[:, None]], dim=1)
    _, order = sort_rowids(comb, bits + 1, backend=backend)
    order = order.to(torch.int64)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(m + n, device=order.device))
    # a query row never counts itself, so the inclusive prefix at its
    # sorted position is the number of sorted rows before it
    sorted_rows_upto = torch.cumsum(order < m, 0)
    return sorted_rows_upto[rank[m:]]


def sort_merge_join(left: Table, right: Table, on,
                    codecs: Optional[Mapping[str, Codec]] = None,
                    suffixes: Tuple[str, str] = ("_l", "_r"),
                    plans: Optional[Tuple[SortPlan, ...]] = None, *,
                    backend: Optional[str] = None) -> Table:
    """Inner join over two sorted runs.

    Both sides' key columns encode through the same codecs (equal keys
    share a code), each side runs one sort, and two ``searchsorted``
    probes of the left codes into the right run give, per left row, its
    matching right range ``[lo, hi)``, expanded into row-id pairs on the
    device.  Output rows are sorted by key, ties by (left arrival, right
    arrival).  ``plans`` (one per code word) applies to both sides."""
    _check_in_memory(left, "sort_merge_join")
    _check_in_memory(right, "sort_merge_join")
    by = _normalize_by(on)
    for name, asc in by:
        if not asc:
            raise ValueError("join keys have no direction; use plain "
                             "column names")
    with _op_scope("sort_merge_join", len(left) + len(right),
                   left.device):
        return _join_mem(left, right, on, by, codecs, suffixes, plans,
                         backend)


def _join_mem(left: Table, right: Table, on, by, codecs, suffixes, plans,
              backend) -> Table:
    codec_l, pre_l = _key_data(left, on, codecs)
    codec_r, pre_r = _key_data(right, on, codecs)
    if ([(type(s.codec), s.codec.bits) for s in codec_l.specs]
            != [(type(s.codec), s.codec.bits) for s in codec_r.specs]):
        raise ValueError("join key columns must encode identically (same "
                         "codec type and width per column) on both sides; "
                         "pass an explicit shared codec via codecs=")
    lc, lrid = sort_rowids_fused(codec_l, pre_l, plans, backend=backend)
    rc, rrid = sort_rowids_fused(codec_r, pre_r, plans, backend=backend)
    lo = _words_searchsorted(rc, lc, codec_l.bits, "left", backend)
    hi = _words_searchsorted(rc, lc, codec_l.bits, "right", backend)
    cnt = hi - lo
    total = int(cnt.sum())  # host sync: the match count
    lpos = torch.repeat_interleave(cnt, output_size=total)
    # the k-th match of left row i is right row lo[i] + k
    offset = lo - (torch.cumsum(cnt, 0) - cnt)
    rpos = torch.arange(total, device=lo.device) + offset[lpos]
    ltab, rtab = left.take(lrid[lpos]), right.take(rrid[rpos])
    keys = {name for name, _ in by}
    out = {name: ltab.column(name) for name, _ in by}
    for name in left.column_names:
        if name not in keys:
            clash = name in right.column_names
            out[name + suffixes[0] if clash else name] = ltab.column(name)
    for name in right.column_names:
        if name not in keys:
            clash = name in left.column_names
            out[name + suffixes[1] if clash else name] = rtab.column(name)
    return Table(out, device=left.device)
