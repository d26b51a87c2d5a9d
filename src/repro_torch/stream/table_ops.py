"""StreamTable: the query layer over chunked, larger-than-budget tables.

Port of ``repro.stream.table_ops``.  A :class:`StreamTable` is the
out-of-core sibling of :class:`~repro_torch.query.table.Table`: named,
equal-dtype columns arriving as a re-iterable stream of Table chunks
(host tables, typically).  The query operators (``order_by`` /
``group_by`` / ``top_k``) accept one anywhere a Table goes and dispatch
here; each streaming operator is the in-memory operator riding
:func:`~repro_torch.stream.external.stream_sorted_words`:

* **order_by** — key columns encode per chunk on the work device through
  the same order-preserving codecs, the ``(n, W)`` code words
  partition-sort with every payload column riding the spill fragments,
  and the sorted chunks spill as result runs: the returned StreamTable is
  re-iterable, its chunks host tables;
* **group_by** — partitions are disjoint key ranges, so groups never span
  sorted chunks except where recursion exhausted the code; one in-memory
  ``group_by`` per sorted chunk plus a boundary merge of adjacent
  partials is the whole streaming aggregation;
* **top_k** — the partition histogram proves which partitions can reach
  rank k; later partitions are never spilled, never loaded.

The work runs on the device an operator's ``device=`` names, else the
StreamTable's own ``device``; ``None`` means the card (raising without
CUDA) and ``"cpu"`` runs on the host.  Results come back on the host.
"""

from __future__ import annotations

from typing import Callable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fractal_sort import resolve_device
from repro_torch.query.operators import (_composite_codec, _normalize_by,
                                         group_by)
from repro_torch.query.table import Table
from repro_torch.stream.chunks import (
    ChunkSource,
    MemoryBudget,
    PlacementStore,
    RunStore,
    temp_store,
)
from repro_torch.stream.external import row_cost_bytes, stream_sorted_words

__all__ = [
    "StreamTable",
    "stream_group_by",
    "stream_order_by",
    "stream_top_k",
]


def _slice_table(table: Table, lo: int, hi: int) -> Table:
    return Table({n: table.column(n)[lo:hi] for n in table.column_names},
                 device=table.device)


def _host_table(table: Table) -> Table:
    return Table(table.to_numpy(), device="cpu")


class StreamTable:
    """Named columns streamed as budget-sized :class:`Table` chunks.

    ``chunks`` is a sequence of Tables, a zero-argument callable returning
    a fresh Table iterator, or a :class:`ChunkSource` yielding Tables; all
    chunks must share column names and dtypes, and the stream must be
    re-iterable (the external sort reads it twice).  ``store`` ties the
    lifetime of spilled result runs to this table (closed via
    :meth:`close`).  ``device`` is where its operators work by default
    (``None``: the card)."""

    def __init__(self, chunks, budget: MemoryBudget,
                 store: Optional[RunStore] = None, *, device=None):
        self._chunks = chunks
        self.budget = budget
        self._store = store
        self._first: Optional[Table] = None
        self.device = device

    @classmethod
    def from_table(cls, table: Table, budget: MemoryBudget, *,
                   device=None) -> "StreamTable":
        """Budget-sized slices of one in-memory table: as many rows as a
        partition sort of one-word codes with these payload columns may
        hold (:func:`~repro_torch.stream.external.row_cost_bytes`), so a
        chunk, its device copy and one distribute slice fit the budget
        together."""
        rows = budget.rows(row_cost_bytes(1, _table_row_bytes(table)))
        pieces = [_slice_table(table, lo, min(lo + rows, table.num_rows))
                  for lo in range(0, max(table.num_rows, 1), rows)]
        return cls(pieces, budget, device=device)

    def chunk_tables(self) -> Iterator[Table]:
        src = self._chunks
        if isinstance(src, ChunkSource):
            it: Iterator = src.chunks()
        elif callable(src):
            it = iter(src())
        else:
            it = iter(src)
        for t in it:
            if not isinstance(t, Table):
                raise TypeError(
                    f"StreamTable chunks must be Tables, got {type(t)}")
            yield t

    def _peek(self) -> Optional[Table]:
        if self._first is None:
            self._first = next(self.chunk_tables(), None)
        return self._first

    def _schema(self) -> Table:
        first = self._peek()
        if first is None:
            raise ValueError("empty StreamTable has no schema")
        return first

    @property
    def column_names(self) -> tuple:
        return self._schema().column_names

    def column_sample(self, name: str) -> torch.Tensor:
        """First chunk's column (codec inference needs a dtype sample)."""
        return self._schema().column(name)

    def num_rows_streamed(self) -> int:
        """Total rows, by streaming the source once."""
        return sum(t.num_rows for t in self.chunk_tables())

    def to_table(self) -> Table:
        """Materialize every chunk as one host table (the caller asserts
        the data fits in memory)."""
        pieces = list(self.chunk_tables())
        if not pieces:
            raise ValueError("empty StreamTable")
        return Table({
            n: np.concatenate([t.column(n).cpu().numpy() for t in pieces])
            for n in pieces[0].column_names}, device="cpu")

    def close(self) -> None:
        if self._store is not None:
            self._store.close()

    def __repr__(self) -> str:
        first = self._peek()
        cols = "?" if first is None else ", ".join(
            f"{k}:{str(first.column(k).dtype).removeprefix('torch.')}"
            for k in first.column_names)
        return f"StreamTable(budget={self.budget.limit_bytes}B; {cols})"


def _table_row_bytes(table: Table) -> int:
    return sum(table.column(n).element_size() for n in table.column_names)


def _work_device(st: StreamTable, device) -> torch.device:
    return resolve_device(st.device if device is None else device)


def _encoded_stream(st: StreamTable, by, codecs, device: torch.device,
                    store: PlacementStore):
    """(codec, column names, chunks_fn, row_bytes): the (words, payloads)
    adapter the external core consumes — key columns encode on the work
    device through the same order-preserving codecs as the in-memory
    operators (codec resolved once, on the first chunk), and *every*
    column rides the spill as a payload; ``row_bytes`` is ``store``'s row
    cost."""
    first = st._peek()
    if first is None:
        raise ValueError("cannot sort an empty StreamTable")
    by_norm = _normalize_by(by)
    codec = _composite_codec(first, by_norm, codecs)
    names = first.column_names
    row_bytes = store.row_cost_bytes(codec.num_words, _table_row_bytes(first))

    def chunks_fn():
        for t in st.chunk_tables():
            words = codec.encode([t.column(name).to(device)
                                  for name, _ in by_norm])
            yield words, tuple(t.column(n) for n in names)

    return codec, names, chunks_fn, row_bytes


def stream_order_by(st: StreamTable, by, codecs=None,
                    store: Optional[RunStore] = None,
                    placement: Optional[PlacementStore] = None, *,
                    device=None, backend: Optional[str] = None
                    ) -> StreamTable:
    """Streaming multi-column ORDER BY (stable): returns a re-iterable
    StreamTable of sorted runs spilled to ``store`` (an owned temp store
    by default), its chunks host tables.  Peak residency stays within
    ``st.budget``.  ``placement`` holds the *working* partition fragments
    (disk by default)."""
    device = _work_device(st, device)
    own_work = placement is None
    work = temp_store() if placement is None else placement
    out_store = RunStore() if store is None else store
    run_ids = []
    try:
        codec, names, chunks_fn, row_bytes = _encoded_stream(
            st, by, codecs, device, work)
        for _, payloads in stream_sorted_words(
                chunks_fn, codec.bits, st.budget, work, row_bytes,
                device=device, backend=backend):
            run_ids.append(out_store.put(*payloads))
    finally:
        if own_work:
            work.close()
    chunks = _run_tables_fn(out_store, run_ids, names)
    return StreamTable(chunks, st.budget,
                       store=out_store if store is None else None,
                       device=st.device)


def _run_tables_fn(store: RunStore, run_ids, names) -> Callable:
    def chunks():
        for rid in run_ids:
            arrays = store.get(rid)
            yield Table(dict(zip(names, arrays)), device="cpu")
    return chunks


def stream_top_k(st: StreamTable, by, k: int, codecs=None,
                 store: Optional[PlacementStore] = None, *, device=None,
                 backend: Optional[str] = None) -> Table:
    """First ``k`` rows of the streaming stable ORDER BY, as one host
    Table.  The partition histogram prunes ahead of placement: partitions
    that cannot reach rank k are never placed, never loaded.  ``store``
    is the working placement (tests count what was — and wasn't —
    touched)."""
    if k <= 0:
        first = st._peek()
        if first is None:
            raise ValueError("cannot top_k an empty StreamTable")
        return _host_table(first.head(0))
    device = _work_device(st, device)
    own = store is None
    work = temp_store() if store is None else store
    try:
        codec, names, chunks_fn, row_bytes = _encoded_stream(
            st, by, codecs, device, work)
        pieces = [payloads for _, payloads in stream_sorted_words(
            chunks_fn, codec.bits, st.budget, work, row_bytes, limit_rows=k,
            device=device, backend=backend)]
    finally:
        if own:
            work.close()
    if not pieces:
        return _host_table(st._peek().head(0))
    return Table({n: np.concatenate([p[i] for p in pieces])[:k]
                  for i, n in enumerate(names)}, device="cpu")


# aggregate combiners for the partial-merge at sorted-chunk boundaries
_COMBINE = {"sum": np.add, "count": np.add,
            "min": np.minimum, "max": np.maximum}


def stream_group_by(st: StreamTable, by,
                    aggs: Mapping[str, Tuple[Optional[str], str]],
                    codecs=None,
                    placement: Optional[PlacementStore] = None, *,
                    device=None, backend: Optional[str] = None) -> Table:
    """Streaming GROUP BY + aggregation: one in-memory ``group_by`` per
    sorted chunk on the work device, partials merged on the host at chunk
    boundaries.

    A group can only straddle two sorted chunks when the external core
    split one partition; the boundary merge — combine the last group of
    the running result with the first group of the next partial when
    their *codes* match — is exact for sum/count/min/max.  Output: one
    host row per group, key-sorted."""
    device = _work_device(st, device)
    by_norm = _normalize_by(by)
    acc: Optional[dict] = None
    prev_last_code: Optional[np.ndarray] = None
    own_work = placement is None
    work = temp_store() if placement is None else placement
    try:
        codec, names, chunks_fn, row_bytes = _encoded_stream(
            st, by_norm, codecs, device, work)
        for words, payloads in stream_sorted_words(
                chunks_fn, codec.bits, st.budget, work, row_bytes,
                device=device, backend=backend):
            part = group_by(Table(dict(zip(names, payloads)), device=device),
                            by_norm, aggs, codecs, backend=backend)
            partial = part.to_numpy()
            # boundary identity is decided on the ENCODED code words, not
            # decoded values: -0.0 and 0.0 are distinct codes, NaN codes
            # equal themselves — the in-memory operator's segments
            boundary = prev_last_code is not None and np.array_equal(
                words[0], prev_last_code)
            acc = partial if acc is None else \
                _merge_partials(acc, partial, boundary, aggs)
            prev_last_code = np.asarray(words[-1])
    finally:
        if own_work:
            work.close()
    if acc is None:
        raise ValueError("cannot group an empty StreamTable")
    return Table(acc, device="cpu")


def _merge_partials(acc: dict, nxt: dict, boundary: bool, aggs) -> dict:
    """Append ``nxt``'s groups onto ``acc``; ``boundary`` (the chunks'
    adjoining code words were equal) combines the straddling group."""
    out = {}
    for name in acc:
        a, b = acc[name], nxt[name]
        if boundary:
            if name in aggs:
                _, op = aggs[name]
                joined = _COMBINE[op](a[-1], b[0])
                a = np.concatenate([a[:-1], np.asarray([joined], a.dtype)])
            b = b[1:]
        out[name] = np.concatenate([a, b])
    return out
