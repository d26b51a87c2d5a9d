"""External sort: budget-bounded sorting of data sets larger than the
device (and host) budget.

Port of ``repro.stream.external``.  Three streaming passes, the classic
distribution-sort shape driven by the fractal histogram instead of
sampled splitters:

1. **histogram** — one read of the :class:`~repro_torch.stream.chunks.
   ChunkSource`: each chunk goes to the work device, its leading MSD
   field is extracted there, and K1 adds its counts onto the carried
   counts (:func:`~repro_torch.stream.partition.streamed_field_counts`);
2. **distribute** — a second read; each chunk's rows route to their
   budget-fitting partition (:func:`~repro_torch.stream.partition.
   partition_bins`) by a LUT gather on the device and *place* as
   per-partition fragments through the :class:`~repro_torch.stream.
   chunks.PlacementStore` (a counting sort on the partition id by K1 and
   K2, then one copy to the host and a spill), arrival order preserved;
3. **sort-and-emit** — partitions load one at a time (they fit the budget
   by prediction), sort on the device through the store's
   :meth:`~repro_torch.stream.chunks.PlacementStore.sort_rows` (the
   executor's pass chain: K1 and K2 on the card), and stream out.
   Partitions are disjoint key ranges, so concatenation *is* the stable
   total order.

Two placement-independent cuts ride the loop: **narrowed partition
sorts** (a partition's bin range pins the top bits of its field, so each
partition sorts only its undetermined low bits) and **overlapped sort +
spill I/O** (``REPRO_STREAM_WORKERS > 1``: upcoming partitions load and
sort on a thread pool while earlier ones stream out; output is
bit-identical at any worker count).  A partition the histogram predicts
oversized is a single bin, and the sort **recursively re-partitions** it
on the next field down.

Fault tolerance rides the same placement seam: **resumable manifests**
(``journal=``/``resume=``: completed partitions replay from their spilled
result runs and none is recomputed), **failover** to a fresh disk store
for a store that advertises ``failover_to_disk`` when its sort dies
permanently, and **prompt failure** of the worker pool (a raising sort
cancels every pending lookahead).

Everything here operates on ``(n, W)`` uint32 code-word matrices (the
query codec layout; int32 storage on the device), so one core serves
plain ≤ 32-bit keys (:func:`external_sort` / :func:`external_argsort`)
and the StreamTable operators' composite codes.  Fragments and the
emitted chunks live on the host.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.autotune import tuned_plan
from repro_torch.core.executor import CudaBackend, PlanExecutor
from repro_torch.core.faults import StoreError, StorePermanentError
from repro_torch.core.fractal_sort import (backend_name, make_backend,
                                          resolve_device)
from repro_torch.core.fractal_tree import ceil_log2
from repro_torch.core.sort_plan import DigitPass, quantize_sort_bits
from repro_torch.obs import metrics, trace
from repro_torch.query.codec import _mask, word_widths
from repro_torch.stream.chunks import (
    Bytes,
    ChunkSource,
    MemoryBudget,
    PlacementStore,
    _host,
    _host_words,
    _row_bytes,
    _copy_of,
    _work_tensor,
    row_cost_bytes,
    temp_store,
)
from repro_torch.stream.partition import (
    DEFAULT_PARTITION_BITS,
    bin_to_partition,
    partition_bins,
    streamed_field_counts,
)

__all__ = [
    "external_argsort",
    "external_sort",
    "row_cost_bytes",
    "stream_sorted_words",
]


def _emitted(words: np.ndarray, payloads: tuple) -> None:
    """Account one emitted chunk: registry counters always, plus a
    zero-width ``stream.emit`` marker span when tracing (closed before
    the caller yields)."""
    rows = int(words.shape[0])
    nbytes = int(words.nbytes) + sum(int(p.nbytes) for p in payloads)
    metrics.counter("stream.emit.rows").inc(rows)
    metrics.counter("stream.emit.bytes").inc(nbytes)
    if trace.enabled():
        with trace.span("stream.emit", rows=rows, bytes=nbytes):
            pass


def _stream_workers() -> int:
    """Worker threads for the overlapped load+sort path: the
    ``REPRO_STREAM_WORKERS`` env knob, default 1 (fully sequential)."""
    try:
        return max(1, int(os.environ.get("REPRO_STREAM_WORKERS", "1")))
    except ValueError:
        return 1


def _extract_field(words: torch.Tensor, bits: int, shift: int,
                   width: int) -> torch.Tensor:
    """Code bits ``[shift, shift + width)`` (LSB-based) of every row of an
    MSB-first ``(n, W)`` code-word matrix (int32 storage), as int32, on
    the words' device: masked shifts only."""
    if not (0 < width <= 32 and shift + width <= bits):
        raise ValueError(f"field [{shift}, {shift + width}) of {bits} bits")
    out = torch.zeros((words.shape[0],), dtype=torch.int32,
                      device=words.device)
    off = bits  # walking MSB-first, word j covers [off - widths[j], off)
    for j, wj in enumerate(word_widths(bits)):
        off -= wj
        lo = max(shift, off)
        hi = min(shift + width, off + wj)
        if lo >= hi:
            continue
        # the arithmetic shift's sign fill lies above the kept bits
        piece = (words[:, j] >> (lo - off)) & _mask(hi - lo)
        out |= piece << (lo - shift)
    return out


def _load_fragments(store: PlacementStore, frag_ids, n_payloads: int,
                    budget: MemoryBudget):
    """One partition back from its placed fragments, arrival order."""
    pieces = [store.get(rid) for rid in frag_ids]
    words = np.concatenate([p[0] for p in pieces]) if pieces else \
        np.zeros((0, 1), np.uint32)
    payloads = tuple(
        np.concatenate([p[1 + i] for p in pieces])
        for i in range(n_payloads))
    budget.charge(words, *payloads)
    return words, payloads


def _coalesce(pieces, rows: int):
    """Consecutive host ``(words, payloads)`` pieces joined into chunks of
    at most ``rows`` rows (or one piece, if longer), arrival order kept.
    An oversized partition's fragments are one small piece a source
    chunk; its recursion distributes them as a few chunks, so it spills a
    few runs instead of one a fragment."""
    buf, n = [], 0

    def joined():
        if len(buf) == 1:
            return buf[0]
        return (np.concatenate([w for w, _ in buf]),
                tuple(np.concatenate(cols) for cols in
                      zip(*(p for _, p in buf))))

    for words, payloads in pieces:
        m = int(words.shape[0])
        if buf and n + m > rows:
            yield joined()
            buf, n = [], 0
        buf.append((words, payloads))
        n += m
    if buf:
        yield joined()


def _backend_for(executor: Optional[PlanExecutor], backend: Optional[str],
                 device: torch.device) -> str:
    """The pass backend's name: ``backend``, else the executor's, else the
    device's ("cuda" on the card)."""
    if backend is None and executor is not None:
        backend = ("cuda" if isinstance(executor.backend, CudaBackend)
                   else "torch")
    return backend_name(backend, device)


def stream_sorted_words(
    chunks_fn: Callable[[], Iterator[tuple]],
    bits: int,
    budget: MemoryBudget,
    store: PlacementStore,
    row_bytes: int,
    hi: Optional[int] = None,
    executor: Optional[PlanExecutor] = None,
    partition_bits: int = DEFAULT_PARTITION_BITS,
    limit_rows: Optional[int] = None,
    journal: Optional[str] = None,
    resume=None,
    *,
    device=None,
    backend: Optional[str] = None,
) -> Iterator[Tuple[np.ndarray, tuple]]:
    """The recursive external-sort core over ``(words, payloads)`` chunks.

    ``chunks_fn`` is a re-iterable factory yielding ``(words, payloads)``
    tuples — ``words`` an ``(m, W)`` uint32 code matrix (numpy, or a
    tensor of int32/uint32 storage, on the host or the work device),
    ``payloads`` a tuple of equal-length arrays riding along.  Yields host
    numpy ``(words, payloads)`` in global stable code order.

    The work runs on ``device`` (``None``: the card, raising without CUDA)
    through the pass backend ``backend`` ("cuda" or "torch"; default the
    executor's, else the device's); ``executor`` counts the histogram.
    ``store`` is any :class:`~repro_torch.stream.chunks.PlacementStore`.

    ``hi`` is the number of undetermined low code bits (every row already
    shares bits ``[hi, bits)``; level 0 streams arrival order).
    ``limit_rows`` stops after that many rows and prunes ahead of the
    distribution pass: partitions the histogram proves past the limit are
    never placed, let alone loaded.  ``journal`` names a manifest on the
    store's log channel that this call keeps current; ``resume`` is a
    prior run's manifest (the dict, or its journal name) whose completed
    partitions replay with zero recomputation.  Both require a store on a
    durable root and the same budget, and neither composes with
    ``limit_rows``."""
    device = resolve_device(device)
    backend = _backend_for(executor, backend, device)
    if executor is None:
        executor = PlanExecutor(make_backend(backend, device))
    hi = bits if hi is None else hi
    emitted = 0
    if (journal is not None or resume is not None) and limit_rows is not None:
        raise ValueError("journal/resume do not compose with limit_rows")
    manifest = None
    if resume is not None:
        manifest = store.read_log(resume) if isinstance(resume, str) \
            else resume
        if isinstance(resume, str) and journal is None:
            journal = resume  # keep journaling where we resumed from
        if manifest is not None and manifest.get("complete"):
            manifest = None  # finished runs have nothing to replay

    def room() -> Optional[int]:
        return None if limit_rows is None else max(limit_rows - emitted, 0)

    def clip(words, payloads):
        r = room()
        if r is not None and words.shape[0] > r:
            return words[:r], tuple(p[:r] for p in payloads)
        return words, payloads

    if hi == 0:
        # every code fully determined: arrival order is the stable sort
        for words, payloads in chunks_fn():
            budget.charge(words, *payloads)
            words, payloads = clip(_host_words(words),
                                   tuple(_host(p) for p in payloads))
            if words.shape[0]:
                _emitted(words, payloads)
                yield words, payloads
                emitted += int(words.shape[0])
            if room() == 0:
                return
        return

    w = min(partition_bits, hi)
    dp = DigitPass(shift=0, bits=w)
    n_payloads = None
    hist_bytes = [0]  # code-word bytes the histogram pass streamed

    def field_chunks():
        nonlocal n_payloads
        for words, payloads in chunks_fn():
            if n_payloads is None:
                n_payloads = len(payloads)
            hist_bytes[0] += int(words.nbytes)
            on_dev = _work_tensor(words, device)
            field = _extract_field(on_dev, bits, hi - w, w)
            budget.charge(words, *payloads, _copy_of(words, on_dev), field)
            yield field

    if manifest is not None:
        # resume: the histogram pass already ran and was journaled; the
        # partition plan re-derives identically from counts + budget
        if not (manifest["bits"] == bits and manifest["hi"] == hi
                and manifest["w"] == w):
            raise ValueError("resume manifest shape mismatch")
        counts = np.asarray(manifest["counts"], np.int64)
        n_total = int(manifest["n_total"])
        n_payloads = int(manifest["n_payloads"])
        budget_rows = budget.rows(row_bytes)
        if budget_rows != int(manifest["budget_rows"]):
            raise ValueError("resume requires the same memory budget (the "
                             "partition plan derives from it)")
    else:
        with trace.span("stream.histogram", level_bits=hi, width=w) as hsp:
            counts, n_total = streamed_field_counts(field_chunks(), dp,
                                                    executor, device)
            hsp.set(rows=int(n_total), bytes_in=hist_bytes[0])
        if n_total == 0:
            return
        budget_rows = budget.rows(row_bytes)
        if journal is not None:
            manifest = {
                "version": 1, "bits": bits, "hi": hi, "w": w,
                "budget_rows": budget_rows, "n_total": n_total,
                "n_payloads": n_payloads,
                "counts": [int(c) for c in counts],
                "done": {}, "complete": False,
            }
            store.write_log(journal, manifest)
    if manifest is None:
        manifest = {"done": {}}  # uniform access below; never journaled
    done: dict = dict(manifest.get("done", {}))

    if n_total <= budget_rows:
        # the data fit after all: one sort, no placement pass
        pieces = list(chunks_fn())
        words = np.concatenate([_host_words(p[0]) for p in pieces])
        payloads = tuple(np.concatenate([_host(p[1][i]) for p in pieces])
                         for i in range(n_payloads))
        words, payloads = store.sort_rows(words, payloads, bits, hi, budget,
                                          device=device, backend=backend)
        words, payloads = clip(words, payloads)
        if words.shape[0]:
            _emitted(words, payloads)
            yield words, payloads
        if journal is not None:
            manifest["complete"] = True
            store.write_log(journal, manifest)
        return

    partitions = list(partition_bins(counts, budget_rows))
    if limit_rows is not None:
        # histogram pruning: the first partitions whose cumulative count
        # reaches the limit are the only ones top-k rows can live in
        keep, cum = 0, 0
        while keep < len(partitions) and cum < limit_rows:
            cum += partitions[keep].count
            keep += 1
        partitions = partitions[:keep]
    lut = bin_to_partition(tuple(partitions), 1 << w)

    # distribution pass: the store places every row at its partition's
    # fragments.  A chunk longer than a partition distributes in slices of
    # budget_rows rows, so its device working set stays inside the model.
    # A resumed run whose manifest reached this phase reuses the recovered
    # fragments instead.
    if manifest.get("frag_ids") is not None:
        frag_ids = [list(ids) for ids in manifest["frag_ids"]]
        if len(frag_ids) != len(partitions):
            raise ValueError("resume manifest mismatch")
    else:
        frag_ids = [[] for _ in partitions]
        lut_dev = torch.from_numpy(lut.astype(np.int32)).to(device)
        with trace.span("stream.distribute",
                        partitions=len(partitions)) as dsp:
            dist_rows, dist_bytes = 0, 0
            for words, payloads in chunks_fn():
                rows = int(words.shape[0])
                dist_rows += rows
                dist_bytes += int(words.nbytes) + sum(
                    int(p.nbytes) for p in payloads)
                step = min(max(rows, 1), budget_rows)

                def pid_of(lo, end, words=words):
                    # rows [lo, end)'s partitions, by a LUT gather of their
                    # field on the device
                    return lut_dev.index_select(0, _extract_field(
                        _work_tensor(words[lo:end], device), bits, hi - w, w))

                with budget.hold(words, *payloads), budget.hold(Bytes(
                        store.distribute_bytes(rows, step,
                                               int(words.shape[1]),
                                               _row_bytes(payloads)))):
                    # the store splits the chunk budget_rows rows at a time
                    for i, ids in enumerate(store.distribute(
                            words, payloads, pid_of, len(partitions),
                            backend=backend, slice_rows=step)):
                        frag_ids[i].extend(ids)
            # rows/bytes are what the pass *streamed*; the spilled bytes
            # live on the nested store.put spans (no double counting)
            dsp.set(rows=dist_rows, bytes_in=dist_bytes)
        if journal is not None:
            manifest["frag_ids"] = [
                [int(r) for r in ids] for ids in frag_ids]
            store.write_log(journal, manifest)

    # per-call plan hoisting: tuned plans resolve ONCE per (padded
    # length, sort-bits) bucket, not once per partition: the autotune
    # cache is consulted O(buckets) times per external-sort call.
    plan_cache: dict = {}

    def plans_for(padded_len, sort_bits):
        key = (padded_len, sort_bits)
        if key not in plan_cache:
            from repro_torch.query.operators import active_words

            plan_cache[key] = tuple(
                tuned_plan(padded_len, eff, backend=backend)
                for _, eff in active_words(bits, sort_bits))
        return plan_cache[key]

    def part_bucket(part):
        """(padded pow2 length, quantized sort bits) — the bucket a
        partition sorts in (sort bits round up to multiples of 8: the
        rounded-up bits are shared prefix, ranking them reorders
        nothing)."""
        L = 1 << ceil_log2(max(part.count, 1))
        sort_bits = quantize_sort_bits(hi - part.shared_field_bits(w), bits)
        return L, sort_bits

    # `st` is the store partitions currently sort/emit through; it swaps
    # to a disk fallback if the placement dies permanently mid-sort
    st = store
    fallback: Optional[PlacementStore] = None

    def sorted_partition(part, frags):
        # runs on pool worker threads too: the span parents under the
        # submitter's context via trace.wrap_ctx at submit time
        with trace.span("stream.partition_sort", rows=part.count) as sp:
            words, payloads = _load_fragments(st, frags, n_payloads,
                                              budget)
            sp.set(bytes_in=int(words.nbytes) + sum(
                int(p.nbytes) for p in payloads))
            L, sort_bits = part_bucket(part)
            return st.sort_rows(words, payloads, bits, sort_bits, budget,
                                plans=plans_for(L, sort_bits), device=device,
                                backend=backend)

    def fail_over(from_idx):
        """Migrate every not-yet-emitted fragment to a fresh disk store
        and swap ``st``; fragments move whole, in order."""
        nonlocal st, fallback
        fb = temp_store()
        for j in range(from_idx, len(items)):
            pj, fj = items[j]
            moved = []
            for rid in fj:
                arrays = st.get(rid)
                moved.append(fb.put(arrays[0], *arrays[1:]))
                try:
                    st.delete(rid)
                except StoreError:
                    pass  # the dying store's cleanup is best-effort
            items[j] = (pj, moved)
        for i, rid in list(presorted.items()):
            arrays = st.get(rid)
            presorted[i] = fb.put(arrays[0], *arrays[1:])
            try:
                st.delete(rid)
            except StoreError:
                pass
        st = fallback = fb

    # sort-and-emit, partition (= key range) order.  With workers > 1 a
    # lookahead pool loads+sorts upcoming in-budget partitions while the
    # current one streams out; consumption stays strictly in partition
    # order, so output is worker-count-invariant.
    items = list(zip(partitions, frag_ids))
    workers = _stream_workers()
    pool: Optional[ThreadPoolExecutor] = None
    pending: dict = {}
    if workers > 1 and limit_rows is None and store.supports_concurrent_sorts:
        pool = ThreadPoolExecutor(max_workers=workers)

    # batched dispatch: same-bucket partitions small enough that several
    # padded copies fit the budget at once sort as ONE segmented chain.
    # Out-of-order members' sorted rows spill back to the store as one
    # pre-sorted fragment and re-load at their emission turn, so emission
    # order and output stay exactly the serial path's.
    group_of: dict = {}      # head index -> member indices, partition order
    if (pool is None and limit_rows is None and journal is None
            and not done and store.supports_batched_sorts):
        open_heads: dict = {}  # bucket -> open group's head index
        for i, (part, _) in enumerate(items):
            if part.oversized(budget_rows):
                continue
            L, qb = part_bucket(part)
            b_max = budget_rows // L
            if b_max < 2 or qb == 0:
                continue  # batch-ineligible: full-budget load, or no-op sort
            head = open_heads.get((L, qb))
            if head is not None and len(group_of[head]) < b_max:
                group_of[head].append(i)
            else:
                open_heads[(L, qb)] = i
                group_of[i] = [i]
        group_of = {h: g for h, g in group_of.items() if len(g) > 1}
    presorted: dict = {}     # member index -> spilled pre-sorted fragment

    def journal_done(idx, rids):
        """Record partition ``idx`` complete (its sorted output spilled
        as ``rids``) — the crash-resume commit point."""
        done[str(idx)] = [int(r) for r in rids]
        manifest["done"] = done
        store.write_log(journal, manifest)

    try:
        for idx in range(len(items)):
            part, frags = items[idx]
            if str(idx) in done:
                # a previous (crashed) run completed this partition and
                # spilled its sorted output: replay the result runs
                for rid in done[str(idx)]:
                    arrays = store.get(rid)
                    words, payloads = arrays[0], tuple(arrays[1:])
                    budget.charge(words, *payloads)
                    if words.shape[0]:
                        _emitted(words, payloads)
                        yield words, payloads
                        emitted += int(words.shape[0])
                for rid in frags:
                    # fragments a crash left behind between the commit
                    # point and their deletion
                    if rid in store:
                        store.delete(rid)
                continue
            if idx in group_of:
                entries = [items[i] for i in group_of[idx]]
                L, sort_bits = part_bucket(part)
                with trace.span("stream.partition_sort",
                                segments=len(entries)) as bsp:
                    loaded = [
                        _load_fragments(st, fr, n_payloads, budget)
                        for _, fr in entries]
                    bsp.set(rows=sum(int(w_.shape[0])
                                     for w_, _ in loaded),
                            bytes_in=sum(
                                int(w_.nbytes) + sum(int(p.nbytes)
                                                     for p in ps)
                                for w_, ps in loaded))
                    results = st.sort_rows_batched(
                        loaded, bits, sort_bits, budget,
                        plans=plans_for(L, sort_bits), device=device,
                        backend=backend)
                # head emits now; later members spill back pre-sorted and
                # re-load in partition order at their own turn
                for i, (_, fr), (words, payloads) in zip(
                        group_of[idx], entries, results):
                    if i != idx:
                        presorted[i] = st.put(words, *payloads)
                    for rid in fr:
                        st.delete(rid)
                words, payloads = results[0]
                if words.shape[0]:
                    _emitted(words, payloads)
                    yield words, payloads
                    emitted += int(words.shape[0])
                continue
            if idx in presorted:
                rid = presorted.pop(idx)
                arrays = st.get(rid)
                words, payloads = arrays[0], tuple(arrays[1:])
                budget.charge(words, *payloads)
                if words.shape[0]:
                    _emitted(words, payloads)
                    yield words, payloads
                    emitted += int(words.shape[0])
                st.delete(rid)
                continue
            if room() == 0:
                for rid in frags:
                    st.delete(rid)
                continue
            if not part.oversized(budget_rows):
                if pool is not None:
                    j = idx  # keep up to `workers` upcoming sorts in flight
                    while len(pending) < workers and j < len(items):
                        pj, fj = items[j]
                        if (j not in pending and str(j) not in done
                                and not pj.oversized(budget_rows)):
                            pending[j] = pool.submit(
                                trace.wrap_ctx(sorted_partition), pj, fj)
                        j += 1
                    try:
                        words, payloads = pending.pop(idx).result()
                    except BaseException:
                        # a doomed sort must fail the stream promptly:
                        # drop the speculative lookahead, don't wait on it
                        for f in pending.values():
                            f.cancel()
                        raise
                else:
                    try:
                        words, payloads = sorted_partition(part, frags)
                    except StorePermanentError:
                        if not getattr(st, "failover_to_disk", False):
                            raise
                        fail_over(idx)
                        part, frags = items[idx]
                        words, payloads = sorted_partition(part, frags)
                words, payloads = clip(words, payloads)
                if journal is not None:
                    journal_done(idx, [store.put(words, *payloads)]
                                 if words.shape[0] else [])
                if words.shape[0]:
                    _emitted(words, payloads)
                    yield words, payloads
                    emitted += int(words.shape[0])
            else:
                # skew fallback: a single bin outgrew the budget; its keys
                # all share that bin's digit, so recurse on the next field
                # down (sequential — recursion re-enters the store)
                if part.num_bins != 1:
                    raise AssertionError("only single bins can be oversized")
                sub_fn = (lambda fr: lambda: _coalesce(
                    ((a[0], tuple(a[1:])) for a in
                     (st.get(rid) for rid in fr)), budget_rows))(frags)
                rids = []
                for words, payloads in stream_sorted_words(
                        sub_fn, bits, budget, st, row_bytes, hi=hi - w,
                        executor=executor, partition_bits=partition_bits,
                        limit_rows=room(), device=device, backend=backend):
                    if journal is not None:
                        rids.append(store.put(words, *payloads))
                    yield words, payloads
                    emitted += int(words.shape[0])
                if journal is not None:
                    journal_done(idx, rids)
            for rid in items[idx][1]:
                # an oversized partition's recursion may itself have
                # failed over and migrated (deleted) these fragments
                if rid in st:
                    st.delete(rid)
        if journal is not None:
            # complete: drop the result runs and mark the manifest spent
            for rids in done.values():
                for rid in rids:
                    if rid in store:
                        store.delete(rid)
            manifest["complete"] = True
            store.write_log(journal, manifest)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if fallback is not None:
            fallback.close()


def _key_chunks_fn(source: ChunkSource, with_rowids: bool):
    """Adapt a 1-D key ChunkSource to the (words, payloads) protocol; the
    cell records whether the keys are uint32, for the output's dtype."""
    unsigned_cell: list = []

    def chunks_fn():
        offset = 0  # recomputed identically on every streaming pass
        for chunk in source.chunks():
            if isinstance(chunk, torch.Tensor):
                ok = chunk.dtype in (torch.int32, torch.uint32)
                unsigned = chunk.dtype == torch.uint32
            else:
                chunk = np.ascontiguousarray(np.asarray(chunk))
                ok = chunk.dtype.kind in "iu" and chunk.dtype.itemsize == 4
                unsigned = chunk.dtype.kind == "u"
            if chunk.ndim != 1:
                raise ValueError("external_sort streams 1-D key chunks")
            if not ok:
                raise TypeError(
                    f"keys must be 32-bit integers (int32/uint32), got "
                    f"{chunk.dtype} — encode other types through "
                    "repro_torch.query codecs (StreamTable order_by)")
            if not unsigned_cell:
                unsigned_cell.append(unsigned)
            if isinstance(chunk, torch.Tensor):
                words = chunk.contiguous().view(torch.int32).reshape(-1, 1)
            else:
                words = chunk.view(np.uint32).reshape(-1, 1)
            payloads = ()
            if with_rowids:
                payloads = (np.arange(offset, offset + chunk.shape[0],
                                      dtype=np.int64),)
            offset += chunk.shape[0]
            yield words, payloads

    return chunks_fn, unsigned_cell


def _keys_out(words: np.ndarray, unsigned_cell: list) -> torch.Tensor:
    """Sorted ``(m, 1)`` words as host keys: int32 storage, viewed as
    ``torch.uint32`` for uint32 input."""
    out = torch.from_numpy(np.ascontiguousarray(words[:, 0]).view(np.int32))
    return out.view(torch.uint32) if unsigned_cell and unsigned_cell[0] \
        else out


def _check_p(p: int) -> None:
    if not 0 <= p <= 32:
        raise ValueError(f"p={p} out of range (0..32)")


def external_sort(source: ChunkSource, p: int, budget: MemoryBudget,
                  store: Optional[PlacementStore] = None,
                  executor: Optional[PlanExecutor] = None,
                  partition_bits: int = DEFAULT_PARTITION_BITS,
                  journal: Optional[str] = None,
                  resume=None, *, device=None,
                  backend: Optional[str] = None) -> Iterator[torch.Tensor]:
    """Sort a streamed data set of ``p``-bit keys under a byte budget.

    ``source`` yields 1-D int32/uint32 key chunks (numpy or tensors) and
    must be re-iterable — the sort streams it twice.  The work runs on
    ``device``: ``None`` means the card and raises without CUDA; ``"cpu"``
    runs the torch-op backend on the host (``backend="cuda"`` there runs
    the kernel backend's plain versions).  Yields sorted key chunks as
    host tensors in global order (int32 storage, a ``torch.uint32`` view
    for uint32 input); ``budget.peak_bytes`` stays under the limit.
    ``store`` holds the partition fragments — an owned temp disk store by
    default, closed when the generator finishes or is closed.
    ``journal`` / ``resume`` as in :func:`stream_sorted_words`."""
    _check_p(p)
    device = resolve_device(device)
    return _external(source, p, budget, store, executor, partition_bits,
                     journal, resume, device, backend, with_rowids=False)


def external_argsort(source: ChunkSource, p: int, budget: MemoryBudget,
                     store: Optional[PlacementStore] = None,
                     executor: Optional[PlanExecutor] = None,
                     partition_bits: int = DEFAULT_PARTITION_BITS,
                     journal: Optional[str] = None,
                     resume=None, *, device=None,
                     backend: Optional[str] = None,
                     ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Like :func:`external_sort`, but each yielded chunk is ``(sorted
    keys, int64 global arrival indices)`` — the stable permutation, in
    budget-sized pieces.  Row ids ride the placed fragments, and equal
    keys keep arrival order end to end."""
    _check_p(p)
    device = resolve_device(device)
    return _external(source, p, budget, store, executor, partition_bits,
                     journal, resume, device, backend, with_rowids=True)


def _external(source, p, budget, store, executor, partition_bits, journal,
              resume, device, backend, with_rowids: bool):
    own_store = store is None
    store = temp_store() if store is None else store
    try:
        chunks_fn, unsigned_cell = _key_chunks_fn(source, with_rowids)
        row_bytes = store.row_cost_bytes(1, 8 if with_rowids else 0)
        for words, payloads in stream_sorted_words(
                chunks_fn, p, budget, store, row_bytes, executor=executor,
                partition_bits=partition_bits, journal=journal,
                resume=resume, device=device, backend=backend):
            keys = _keys_out(words, unsigned_cell)
            yield (keys, torch.from_numpy(np.ascontiguousarray(
                payloads[0]))) if with_rowids else keys
    finally:
        if own_store:
            store.close()
