"""Chunk streams, the byte budget, and the fragment placement stores.

Port of ``repro.stream.chunks``.  The out-of-core sort never holds more
than a budgeted number of bytes of key/payload data resident: inputs
arrive as a :class:`ChunkSource` (a re-iterable stream of budget-sized
pieces), intermediate partition fragments and sorted runs go to a
:class:`PlacementStore`, and every sizing decision comes from one
:class:`MemoryBudget`.

The work runs on a device (the card, or the CPU for tests), the
fragments on the host: a store's :meth:`~PlacementStore.distribute`
takes one chunk's rows *on the work device*, ranks them by partition
there (K1's counts and K2's stable rank on the card: a counting sort on
the partition id), scatters them once and brings them to the host in one
copy; its :meth:`~PlacementStore.sort_rows` pads a partition on the
host, copies it to the device (through pinned memory for the card), sorts
it with :func:`~repro_torch.query.operators.sort_rowids`, gathers the
payloads there and brings back only the real rows.  The budget counts
host and device bytes alike: :func:`partition_sort_bytes` and
:func:`distribute_bytes` are the working sets those two steps hold.

:class:`RunStore` keeps the reference's on-disk format: one ``.npy`` per
array, a commit record ``run<id>.meta.json`` with each array's CRC32,
atomic ``os.replace`` staging, the ``slices`` log and the verified log
channel, so either package reopens the other's root.  It adds one record
the reference ignores: each slice fragment's own CRC32s
(``slice_crc32`` in the ``slices`` log), so a slice read verifies the
rows it returns instead of the whole base run.  A base run written by a
distribute is read once per partition, and verifying it whole each time
would read the data set once per partition.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import shutil
import tempfile
import threading
import time
import weakref
import zlib
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.faults import CorruptFragmentError
from repro_torch.core.fractal_sort import make_backend, resolve_device
from repro_torch.core.fractal_tree import ceil_log2
from repro_torch.obs import metrics, trace
from repro_torch.query.operators import sort_rowids, sort_rowids_batched
from repro_torch.query.table import _gather

__all__ = [
    "ArraySource",
    "ChunkSource",
    "GeneratorSource",
    "MemoryBudget",
    "PlacementStore",
    "RunSource",
    "RunStore",
    "distribute_bytes",
    "partition_sort_bytes",
    "row_cost_bytes",
    "temp_store",
]

# the disk store's injection sites — the same names as the reference's,
# so one fault plan hits the same boundaries in both packages
_SITE_PUT = faults.register_site("run_store.put")
_SITE_GET = faults.register_site("run_store.get")
_SITE_DELETE = faults.register_site("run_store.delete")
_SITE_DISTRIBUTE = faults.register_site("run_store.distribute")
_SITE_SORT = faults.register_site("run_store.sort_rows")

#: the all-ones code a padded row carries: sorts after every real row
_SENTINEL = -1


def temp_store() -> "PlacementStore":
    """A fresh private disk-backed store — the default placement when a
    caller doesn't supply one, and the failover target when a placement
    dies mid-sort."""
    return RunStore()


@dataclasses.dataclass(frozen=True)
class Bytes:
    """A byte count that :meth:`MemoryBudget.hold` and
    :meth:`MemoryBudget.charge` accept beside arrays: the working set of a
    device step that allocates inside a call, with no array to point at."""

    nbytes: int


def partition_sort_bytes(padded_rows: int, rows: int, num_words: int,
                         payload_bytes: int) -> int:
    """Bytes one partition sort holds at once, host and device: ``rows``
    real rows padded to ``padded_rows``, ``num_words`` code words and
    ``payload_bytes`` of payload columns a row.

    Per padded row: the host's padded matrix (pinned for the card), its
    device copy and the sorted words (``4 * num_words`` each), the int32
    row ids (4) and the executor's per-pass buffers (32: key stream,
    index, digit, rank, the scattered key and index, and the int32 → int64
    index copy of the scatter).  Per real row: the loaded words and the
    sorted words back on the host (``4 * num_words`` each), the payloads
    loaded, on the device, gathered there and back on the host
    (``payload_bytes`` each), and the int64 row ids of the gather (8)."""
    return (padded_rows * (12 * num_words + 36)
            + rows * (8 * num_words + 4 * payload_bytes + 8))


def row_cost_bytes(num_words: int, payload_bytes: int = 0) -> int:
    """Per-row byte cost the budget's ``rows()`` divides by, modeling the
    partition-sort moment, the subsystem's residency peak
    (:func:`partition_sort_bytes`: host and device copies at once).  A
    partition holds at most ``budget.rows(cost) = limit / (2 cost)`` rows
    and pads to under twice that, so the moment holds at most ``2 rows``
    padded rows of ``pad`` bytes and ``rows`` real rows of ``real``
    bytes: the cost ``pad + real / 2`` keeps it within the limit.  A
    distribute slice of as many rows holds less
    (:func:`distribute_bytes`)."""
    pad = partition_sort_bytes(1, 0, num_words, payload_bytes)
    real = partition_sort_bytes(0, 1, num_words, payload_bytes)
    return pad + -(-real // 2)


def distribute_bytes(rows: int, slice_rows: int, num_words: int,
                     payload_bytes: int) -> int:
    """Bytes one distribute of a ``rows``-row chunk holds beside the chunk,
    splitting ``slice_rows`` rows at a time on the device.  Per slice row
    on the device: the words and payloads, the partition field and id, the
    id's rank and the rank's int64 copy of the scatter (20), and the
    scattered words and payloads; with several slices, also the slice's
    host copy.  Per chunk row: the host copy of the split."""
    row = 4 * num_words + payload_bytes
    return (slice_rows * (2 * row + 20 + (row if slice_rows < rows else 0))
            + rows * row)


def _nbytes(a) -> int:
    return 0 if a is None else int(a.nbytes)


@dataclasses.dataclass
class MemoryBudget:
    """Byte cap on resident key/payload data, plus the peak tracker.

    ``rows(bytes_per_row)`` is how every consumer sizes chunks and
    partitions: the cap divided by the per-row byte cost, with a
    ``headroom`` divisor (default 2) reserving room for the power-of-two
    padding of a partition sort, so the total stays under ``limit_bytes``
    even then.

    ``charge(*arrays)`` records one moment's resident arrays; ``hold``
    keeps bytes accounted for an operation's whole duration and *always*
    releases, so a partition sort that raises mid-flight leaves no phantom
    residency behind.  Concurrent holds sum, and both paths fold the live
    held total into ``peak_bytes``.  Numpy arrays, tensors (host or
    device) and :class:`Bytes` all count by their ``nbytes``.  Charging
    never raises — the budget is a contract the subsystem keeps by
    construction and tests verify by reading the peak."""

    limit_bytes: int
    headroom: int = 2
    peak_bytes: int = dataclasses.field(default=0, compare=False)
    _held: int = dataclasses.field(default=0, compare=False, repr=False)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, compare=False, repr=False)

    def __post_init__(self):
        if self.limit_bytes < 1:
            raise ValueError(f"budget {self.limit_bytes} bytes")
        if self.headroom < 1:
            raise ValueError(f"headroom {self.headroom}")

    def rows(self, bytes_per_row: int) -> int:
        """Rows of ``bytes_per_row`` data a chunk/partition may hold."""
        return max(1, self.limit_bytes
                   // (self.headroom * max(int(bytes_per_row), 1)))

    @property
    def held_bytes(self) -> int:
        """Bytes currently held by in-flight operations (0 when idle,
        including after an operation failed)."""
        return self._held

    @contextlib.contextmanager
    def hold(self, *arrays):
        """Account ``arrays`` as resident for the duration of the ``with``
        block; released on every exit path."""
        b = sum(_nbytes(a) for a in arrays)
        with self._lock:
            self._held += b
            self.peak_bytes = max(self.peak_bytes, self._held)
        metrics.gauge("budget.peak_bytes").set_max(self.peak_bytes)
        try:
            yield b
        finally:
            with self._lock:
                self._held -= b

    def charge(self, *arrays) -> int:
        """Record simultaneously-resident arrays; returns the moment's byte
        total and updates :attr:`peak_bytes` (folding in whatever
        concurrent operations currently hold).  Thread-safe."""
        resident = sum(_nbytes(a) for a in arrays)
        with self._lock:
            self.peak_bytes = max(self.peak_bytes, resident + self._held)
        metrics.gauge("budget.peak_bytes").set_max(self.peak_bytes)
        return resident


class ChunkSource:
    """A re-iterable stream of chunks (numpy arrays or tensors, or whatever
    item type the consumer expects — :class:`~repro_torch.stream.table_ops.
    StreamTable` streams Tables).

    ``chunks()`` must return a *fresh* iterator each call: the external
    sort streams a source twice (histogram pass, then distribution pass).
    """

    def chunks(self) -> Iterator:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ArraySource(ChunkSource):
    """Budget-sized views over one in-memory array or tensor (slices are
    views, nothing is copied)."""

    array: object
    rows_per_chunk: int

    def __post_init__(self):
        if self.rows_per_chunk < 1:
            raise ValueError(f"rows_per_chunk={self.rows_per_chunk}")

    def chunks(self) -> Iterator:
        a = self.array
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        for lo in range(0, a.shape[0], self.rows_per_chunk):
            yield a[lo:lo + self.rows_per_chunk]


@dataclasses.dataclass(frozen=True)
class GeneratorSource(ChunkSource):
    """Chunks from a zero-argument callable returning a fresh iterator —
    the dataset is produced, not stored (each ``chunks()`` call re-invokes
    the factory)."""

    factory: Callable[[], Iterator]

    def chunks(self) -> Iterator:
        return iter(self.factory())


def _host(a) -> np.ndarray:
    """A fragment array on the host, as numpy (a tensor is copied to the
    host first)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _host_words(words) -> np.ndarray:
    """``(m, W)`` code words on the host as uint32."""
    w = _host(words)
    return w.view(np.uint32) if w.dtype == np.int32 else w


def _work_tensor(a, device: torch.device) -> torch.Tensor:
    """An array as a tensor on the work device (uint32 code words as their
    int32 storage)."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32 and a.ndim == 2:
            a = a.view(np.int32)
        a = torch.from_numpy(a)
    elif a.dtype == torch.uint32 and a.dim() == 2:
        a = a.view(torch.int32)
    return a.to(device)


def _copy_of(src, t: torch.Tensor) -> Optional[torch.Tensor]:
    """``t`` when it is a copy of ``src``, None when it is ``src`` or shares
    its memory (a tensor made from a host array on the CPU): the budget
    counts a copy once."""
    ptr = (src.data_ptr() if isinstance(src, torch.Tensor)
           else np.asarray(src).__array_interface__["data"][0])
    return None if t.data_ptr() == ptr else t


def _row_bytes(arrays) -> int:
    """Bytes a row of the 1-D ``arrays``."""
    return sum(a.element_size() if isinstance(a, torch.Tensor)
               else a.dtype.itemsize for a in arrays)


def _staging(shape, device: torch.device) -> torch.Tensor:
    """A host int32 buffer to fill and copy to ``device``: pinned for the
    card, so the copy runs without a pageable bounce."""
    return torch.empty(shape, dtype=torch.int32,
                       pin_memory=device.type == "cuda")


def _gather_to_host(payloads, rid: torch.Tensor, device) -> tuple:
    """Each payload column gathered at ``rid`` on ``device``, back on the
    host as numpy."""
    return tuple(_gather(_work_tensor(p, device), rid).cpu().numpy()
                 for p in payloads)


class PlacementStore:
    """Where partition fragments live — the placement contract of the
    external sort's one partition loop.

    * :meth:`put` / :meth:`get` / :meth:`delete` — one fragment (a tuple
      of equal-length arrays, keys first) in, out, and dropped; every
      access logged (:attr:`put_log` / :attr:`get_log`) so tests count
      what was — and crucially, was *never* — touched;
    * :meth:`distribute` — one chunk's rows, on the work device, routed
      to their partitions' fragments (a counting sort on the partition
      id by the backend's histogram and stable rank, one scatter, one
      copy to the host);
    * :meth:`sort_rows` — one partition's stable in-budget sort on the
      work device;
    * :meth:`owner` / :meth:`nbytes` — capacity accounting;
    * :meth:`write_log` / :meth:`read_log` — the store's named log
      channel (verified on the disk store): the external sort journals
      its crash-resume partition manifest here.

    Failure is part of the contract: every boundary raises the typed
    errors of :mod:`repro_torch.core.faults` and polls the
    fault-injection registry."""

    #: prefix of this store's fault-injection site names
    site_prefix: str = "store"

    #: whether the external sort may fail this store's remaining
    #: partitions over to a fresh disk store when a *permanent* fault
    #: hits mid-sort.  The disk store says False: when disk itself is
    #: gone there is nowhere left to degrade to.
    failover_to_disk: bool = False

    put_log: List[int]
    get_log: List[int]

    #: whether :meth:`sort_rows` may be called from several worker
    #: threads at once
    supports_concurrent_sorts: bool = True

    #: whether :meth:`sort_rows_batched` may fuse several partitions into
    #: one padded dispatch
    supports_batched_sorts: bool = True

    def _site(self, op: str) -> str:
        return f"{self.site_prefix}.{op}"

    def put(self, *arrays, partition: Optional[int] = None):
        """Store one fragment (≥ 1 equal-length arrays, keys first);
        returns its fragment id.  Tensors are copied to the host."""
        raise NotImplementedError

    def get(self, rid: int, mmap: bool = False):
        raise NotImplementedError

    def delete(self, rid: int) -> None:
        raise NotImplementedError

    def __contains__(self, rid: int) -> bool:
        raise NotImplementedError

    def owner(self, partition: int, num_partitions: int) -> Optional[int]:
        """Placement slot (device index) ``partition`` maps to, or None
        when the store has a single placement (disk)."""
        return None

    def nbytes(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def row_cost_bytes(self, num_words: int, payload_bytes: int = 0) -> int:
        """Per-row byte cost the external loop sizes this store's
        partitions by (:func:`row_cost_bytes`, the work-device partition
        sort of :meth:`sort_rows`)."""
        return row_cost_bytes(num_words, payload_bytes)

    def distribute_bytes(self, rows: int, slice_rows: int, num_words: int,
                         payload_bytes: int) -> int:
        """Bytes one :meth:`distribute` of a ``rows``-row chunk holds beside
        the chunk (:func:`distribute_bytes`)."""
        return distribute_bytes(rows, slice_rows, num_words, payload_bytes)

    # -- the log channel ------------------------------------------------------

    def write_log(self, name: str, payload: dict) -> None:
        """Journal a named JSON-serializable record next to the fragments
        (round-tripped through JSON so every store normalizes types
        alike)."""
        logs = self.__dict__.setdefault("_mem_logs", {})
        logs[name] = json.loads(json.dumps(payload))

    def read_log(self, name: str) -> Optional[dict]:
        return self.__dict__.get("_mem_logs", {}).get(name)

    # -- distribution and partition sorts -------------------------------------

    @staticmethod
    def _pid_slice(pid, lo: int, hi: int, num_partitions: int):
        """Rows ``[lo, hi)``'s partition ids as int32, the pruned rows
        (``pid < 0``) in one extra bin, ``num_partitions``."""
        p = pid(lo, hi) if callable(pid) else pid[lo:hi]
        if not isinstance(p, torch.Tensor):
            p = torch.from_numpy(np.ascontiguousarray(p))
        return torch.where(p < 0, num_partitions, p).to(torch.int32)

    @staticmethod
    def _split_slice(words, payloads, pid: torch.Tensor, n_bins: int, be):
        """The stable split of rows by partition id (``n_bins`` bins, the
        extra bin last), on the device ``pid`` lies on: the backend ranks
        the ids (K1's counts and K2's stable rank on the card), one scatter
        moves the rows, and only the rows outside the extra bin come back
        to the host, in one copy an array.  Returns ``(host arrays, counts
        of the kept bins)``."""
        device = pid.device
        rank, counts, _ = be.rank(pid.contiguous(), n_bins)
        moved = be.scatter(rank, _work_tensor(words, device),
                           *(_work_tensor(p, device) for p in payloads))
        counts = counts.cpu().numpy().astype(np.int64)
        keep = int(pid.shape[0] - counts[-1])  # the extra bin is last
        return [a[:keep].cpu().numpy() for a in moved], counts[:-1]

    @classmethod
    def _split(cls, words, payloads, pid, num_partitions: int,
               backend: Optional[str], slice_rows: Optional[int] = None):
        """The stable split of one chunk by partition id, ``slice_rows``
        rows at a time on the device (all at once by default).  ``pid`` is
        the chunk's partition ids, or a callable ``pid(lo, hi)`` giving
        rows ``[lo, hi)``'s on the work device.  With several slices the
        chunk's counts come first (K1 adding each slice onto the carried
        counts), so each slice's split lands in its partitions' places in
        one host buffer.  Returns ``(host words, host payloads, bounds)``:
        partition ``i`` is rows ``[bounds[i], bounds[i + 1])``."""
        n = int(words.shape[0])
        step = n if slice_rows is None else max(1, int(slice_rows))
        los = range(0, max(n, 1), step)
        first = cls._pid_slice(pid, 0, min(step, n), num_partitions)
        be = make_backend(backend, first.device)
        if len(los) == 1:
            host, counts = cls._split_slice(words, payloads, first,
                                            num_partitions + 1, be)
            bounds = np.concatenate([[0], np.cumsum(counts)])
            return host[0].view(np.uint32), tuple(host[1:]), bounds
        total = None
        for lo in los:
            total = be.histogram(cls._pid_slice(pid, lo, lo + step,
                                                num_partitions),
                                 num_partitions + 1, init=total)
        counts = total.cpu().numpy().astype(np.int64)[:-1]
        bounds = np.concatenate([[0], np.cumsum(counts)])
        filled = bounds[:-1].copy()
        out = None
        for lo in los:
            host, c = cls._split_slice(
                words[lo:lo + step], tuple(p[lo:lo + step] for p in payloads),
                cls._pid_slice(pid, lo, lo + step, num_partitions),
                num_partitions + 1, be)
            if out is None:
                out = [np.empty((int(bounds[-1]),) + h.shape[1:], h.dtype)
                       for h in host]
            starts = np.concatenate([[0], np.cumsum(c)])
            for i in np.flatnonzero(c):
                for o, h in zip(out, host):
                    o[filled[i]:filled[i] + c[i]] = h[starts[i]:starts[i + 1]]
                filled[i] += c[i]
        return out[0].view(np.uint32), tuple(out[1:]), bounds

    def distribute(self, words, payloads: tuple, pid, num_partitions: int,
                   *, backend: Optional[str] = None,
                   slice_rows: Optional[int] = None) -> list:
        """Route one chunk's rows to their partitions, preserving arrival
        order within each partition; returns a per-partition list of the
        fragment ids written.  Rows with ``pid < 0`` (pruned partitions)
        are dropped.  ``words``, ``payloads`` and ``pid`` lie on the work
        device (numpy arrays work on the CPU; ``pid`` may also be a
        callable ``pid(lo, hi)`` giving rows ``[lo, hi)``'s ids);
        ``backend`` names the pass backend that ranks ("cuda" or "torch";
        default from the device); ``slice_rows`` bounds the rows split on
        the device at once.  This default puts one fragment per non-empty
        partition."""
        site = self._site("distribute")
        # the injection point sits before any mutation, so a transient
        # retry re-enters a clean distribute
        faults.with_retries(site, lambda: faults.poll(site))
        frag_ids: list = [[] for _ in range(num_partitions)]
        w, pays, bounds = self._split(words, payloads, pid, num_partitions,
                                      backend, slice_rows)
        for i in range(num_partitions):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if hi > lo:
                frag_ids[i].append(self.put(
                    w[lo:hi], *(p[lo:hi] for p in pays), partition=i))
        return frag_ids

    def sort_rows(self, words: np.ndarray, payloads: tuple, bits: int,
                  sort_bits: int, budget: MemoryBudget, plans=None, *,
                  device=None, backend: Optional[str] = None):
        """Stable sort of one partition's rows on their low ``sort_bits``
        undetermined code bits, on ``device`` (``backend`` as in
        :meth:`distribute`; ``device=None`` is the card).  Rows are padded
        to the power-of-two ceiling
        with all-ones codes (after every real row, arriving later → stably
        last).  ``plans`` pins per-active-word sort plans.  Transient
        faults retry the whole (pure, deterministic) sort.  Returns
        ``(sorted_words, payloads in sorted order)`` on the host."""
        m = int(words.shape[0])
        if m <= 1 or sort_bits == 0:
            return words, payloads
        site = self._site("sort_rows")
        device = resolve_device(device)
        return faults.with_retries(
            site, lambda: self._sort_rows_once(
                site, words, payloads, bits, sort_bits, budget, plans,
                device, backend))

    def _sort_rows_once(self, site, words, payloads, bits, sort_bits,
                        budget, plans, device, backend):
        m, num_words = int(words.shape[0]), int(words.shape[1])
        target = 1 << ceil_log2(m)
        with budget.hold(Bytes(partition_sort_bytes(
                target, m, num_words, _row_bytes(payloads)))):
            faults.poll(site)
            padded = _staging((target, num_words), device)
            host = padded.numpy()
            host[:m] = words.view(np.int32)
            host[m:] = _SENTINEL
            on_dev = padded.to(device, non_blocking=True)
            sorted_words, rowids = sort_rowids(
                on_dev, bits, plans=plans, low_bits=sort_bits,
                backend=backend)
            del on_dev
            rid = rowids[:m].to(torch.int64)
            # all-ones sentinels sort after every real row, so the first m
            # sorted slots hold exactly the real rows
            if m < target and int(rid.max()) >= m:
                raise AssertionError("a padding row sorted among the real "
                                     "rows")
            gathered = _gather_to_host(payloads, rid, device)
            sorted_words = sorted_words[:m].cpu().numpy().view(np.uint32)
        budget.charge(words, sorted_words, *payloads, *gathered)
        return sorted_words, gathered

    def sort_rows_batched(self, parts, bits: int, sort_bits: int,
                          budget: MemoryBudget, plans=None, *, device=None,
                          backend: Optional[str] = None):
        """Sort several partitions through ONE padded dispatch: each is
        padded to the shared power-of-two length ``L`` with all-ones rows
        and the ``(B*L, W)`` matrix ranks through the executor's segmented
        mode (:func:`~repro_torch.query.operators.sort_rowids_batched`).
        Output is bit-identical to ``B`` serial :meth:`sort_rows` calls.
        Returns a list of ``(sorted_words, gathered payloads)``."""
        parts = list(parts)
        if (not self.supports_batched_sorts or len(parts) <= 1
                or sort_bits == 0):
            return [self.sort_rows(w, p, bits, sort_bits, budget, plans=plans,
                                   device=device, backend=backend)
                    for w, p in parts]
        site = self._site("sort_rows")
        device = resolve_device(device)
        return faults.with_retries(
            site, lambda: self._sort_rows_batched_once(
                site, parts, bits, sort_bits, budget, plans, device,
                backend))

    def _sort_rows_batched_once(self, site, parts, bits, sort_bits, budget,
                                plans, device, backend):
        seg_log2 = ceil_log2(max(max(w.shape[0] for w, _ in parts), 2))
        L = 1 << seg_log2
        num_words = int(parts[0][0].shape[1])
        rows = sum(int(w.shape[0]) for w, _ in parts)
        all_payloads = [p for _, pays in parts for p in pays]
        pay_bytes = _row_bytes(parts[0][1])
        with budget.hold(Bytes(partition_sort_bytes(
                len(parts) * L, rows, num_words, pay_bytes))):
            faults.poll(site)
            padded = _staging((len(parts) * L, num_words), device)
            host = padded.numpy()
            host[:] = _SENTINEL
            for b, (w, _) in enumerate(parts):
                host[b * L:b * L + w.shape[0]] = w.view(np.int32)
            sorted_words, rowids = sort_rowids_batched(
                padded.to(device, non_blocking=True), bits, seg_log2,
                plans=plans, low_bits=sort_bits, backend=backend)
            out = []
            for b, (w, pays) in enumerate(parts):
                m = int(w.shape[0])
                rid = rowids[b * L:b * L + m].to(torch.int64) - b * L
                # sentinels sort last per segment: the first m slots of
                # segment b hold exactly partition b's real rows
                if m < L and int(rid.max()) >= m:
                    raise AssertionError("a padding row sorted among the "
                                         "real rows")
                sw = sorted_words[b * L:b * L + m].cpu().numpy()
                out.append((sw.view(np.uint32),
                            _gather_to_host(pays, rid, device)))
        budget.charge(*(w for w, _ in parts), *all_payloads,
                      *(a for w, g in out for a in (w, *g)))
        return out

    def __enter__(self) -> "PlacementStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _crc_file(path: str) -> int:
    """CRC32 of a file's bytes, streamed in bounded blocks."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _corrupt_file(path: str, offset: int = -1) -> None:
    """Flip one byte in place (the last by default) — the injection
    registry's stand-in for a torn write / bit rot."""
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END if offset < 0 else os.SEEK_SET)
        pos = f.tell()
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def _crc_rows(a: np.ndarray) -> int:
    """CRC32 of a C-contiguous array's bytes."""
    return zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"))


class RunStore(PlacementStore):
    """Numpy-backed on-disk store of runs (each a tuple of arrays).

    A *run* is whatever one spill wrote: a partition fragment (keys [+
    payload columns]) or a finished sorted run.  Runs live as one ``.npy``
    file per array under ``root`` (a private temp dir by default, removed
    on :meth:`close`).  ``get(..., mmap=True)`` returns memory-maps, which
    is how the k-way merge keeps k open runs resident only block by block.

    Durability contract: :meth:`put` stages each array to a tmp file and
    ``os.replace``\\ s it into place, then commits the run by atomically
    writing its meta record (array count + per-array CRC32) — a run
    without its meta record does not exist.  :meth:`get` verifies the
    bytes it returns against a recorded CRC and raises
    :class:`~repro_torch.core.faults.CorruptFragmentError` on mismatch.
    Transient I/O failures retry with bounded backoff
    (``REPRO_STORE_RETRIES``); swallowed/retried events are counted in
    :attr:`events`.

    A store constructed on a caller-provided ``root`` *recovers* on
    construction: committed runs come back, torn leftovers are swept and
    counted.  Slice fragments (chunk-level spill views) are persisted to
    the ``slices`` log on every mutation for the same reason.
    """

    site_prefix = "run_store"

    def __init__(self, root: Optional[str] = None):
        self._own_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="repro-runstore-")
        os.makedirs(self.root, exist_ok=True)
        self._next_id = 0
        self._id_lock = threading.Lock()  # overlapped workers also spill
        self._widths: dict = {}  # run id -> number of arrays
        self._crcs: dict = {}    # run id -> tuple of per-array CRC32
        # slice fragments: slice id -> (base run id, lo, hi); a base run
        # holding live slices is refcounted and deleted with its last slice
        self._slices: dict = {}
        self._base_refs: dict = {}
        #: slice id -> per-array CRC32 of the slice's rows (absent for a
        #: root written by the reference: those verify the whole base)
        self._slice_crcs: dict = {}
        #: base run id -> its arrays memory-mapped (slice reads)
        self._maps: dict = {}
        self.put_log: list = []
        self.get_log: list = []
        #: bytes physically written/read per successful put/get (slice
        #: entries write 0 new bytes); a get that finally failed appends 0
        self.put_log_bytes: list = []
        self.get_log_bytes: list = []
        #: counters of swallowed / retried / recovered I/O events
        self.events: collections.Counter = collections.Counter()
        if self._own_root:  # a private temp dir never outlives the store
            self._cleanup = weakref.finalize(
                self, shutil.rmtree, self.root, True)
        else:
            self._recover()

    # -- recovery (caller-provided roots) -------------------------------------

    def _recover(self) -> None:
        """Rebuild committed state from an existing root: runs with meta
        records are live; data files without one are a torn put and are
        swept (counted).  The persisted ``slices`` log restores slice
        fragments and the id watermark."""
        metas, data_files = {}, {}
        for name in os.listdir(self.root):
            path = os.path.join(self.root, name)
            if name.endswith(".tmp"):
                os.remove(path)
                self.events["recover.tmp_swept"] += 1
            elif name.endswith(".meta.json"):
                try:
                    rid = int(name[len("run"):-len(".meta.json")])
                    with open(path) as f:
                        metas[rid] = json.load(f)
                except (ValueError, OSError):
                    self.events["recover.torn_meta"] += 1
                    os.remove(path)
            elif name.startswith("run") and name.endswith(".npy"):
                try:
                    rid = int(name[len("run"):].split("_")[0])
                    data_files.setdefault(rid, []).append(path)
                except ValueError:
                    pass
        for rid, meta in metas.items():
            self._widths[rid] = int(meta["width"])
            self._crcs[rid] = tuple(int(c) for c in meta["crc32"])
        for rid, paths in data_files.items():
            if rid not in self._widths:  # data without a commit record
                for p in paths:
                    os.remove(p)
                self.events["recover.torn_run"] += 1
        slices = self.read_log("slices")
        if slices is not None:
            self._slices = {int(k): tuple(v)
                            for k, v in slices["slices"].items()}
            self._base_refs = {int(k): int(v)
                               for k, v in slices["base_refs"].items()}
            self._slice_crcs = {
                int(k): tuple(int(c) for c in v)
                for k, v in slices.get("slice_crc32", {}).items()
                if int(k) in self._slices}
            self._next_id = int(slices["next_id"])
        ids = list(self._widths) + list(self._slices)
        self._next_id = max([self._next_id] + [i + 1 for i in ids])

    def _persist_slices(self) -> None:
        """Journal the slice table (durable roots only)."""
        if self._own_root:
            return
        self.write_log("slices", {
            "next_id": self._next_id,
            "slices": {str(k): list(v) for k, v in self._slices.items()},
            "base_refs": {str(k): int(v)
                          for k, v in self._base_refs.items()},
            "slice_crc32": {str(k): list(v)
                            for k, v in self._slice_crcs.items()},
        })

    # -- fragment put/get ------------------------------------------------------

    def _new_id(self) -> int:
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        return rid

    def put(self, *arrays, partition: Optional[int] = None) -> int:
        """Spill one run (≥ 1 arrays, tensors copied to the host first);
        returns its run id.  ``partition`` is irrelevant on disk and
        accepted for protocol compatibility.  Atomic: every array stages
        to a tmp file and ``os.replace``\\ s into place, and the run only
        exists once its meta record (array count + CRC32s) lands."""
        if not arrays:
            raise ValueError("a run holds at least one array")
        arrays = tuple(_host(a) for a in arrays)
        rid = self._new_id()

        def attempt():
            kind = faults.poll(_SITE_PUT)
            crcs = []
            for j, a in enumerate(arrays):
                buf = io.BytesIO()
                np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
                data = buf.getbuffer()
                crcs.append(zlib.crc32(data))
                path = self._path(rid, j)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            self._write_json_atomic(self._meta_path(rid), {
                "width": len(arrays), "crc32": crcs})
            if kind == "corrupt":
                # a torn write the commit record doesn't know about —
                # get's CRC verification must catch it
                _corrupt_file(self._path(rid, len(arrays) - 1))
            return tuple(crcs)

        nbytes = sum(int(a.nbytes) for a in arrays)
        with trace.span("store.put", store=self.site_prefix, rid=rid,
                        bytes=nbytes, arrays=len(arrays)):
            crcs = faults.with_retries(
                _SITE_PUT, attempt,
                on_retry=lambda: self._count("put.retry"))
        self._widths[rid] = len(arrays)
        self._crcs[rid] = crcs
        self.put_log.append(rid)
        self.put_log_bytes.append(nbytes)
        metrics.counter(f"store.{self.site_prefix}.put.calls").inc()
        metrics.counter(f"store.{self.site_prefix}.put.bytes").inc(nbytes)
        return rid

    def get(self, rid: int, mmap: bool = False):
        """Load one run back as a tuple of arrays (memory-maps with
        ``mmap=True``).  A run's bytes verify against the CRCs recorded at
        put; a slice fragment's rows verify against the slice's own CRCs
        (or, for a root whose slices have none, its whole base run) and
        come back as an array of their own.  A mismatch raises
        :class:`~repro_torch.core.faults.CorruptFragmentError`."""
        crc_s = [0.0]  # CRC-verify wall, summed across retry attempts
        if rid in self._slices:
            base, lo, hi = self._slices[rid]
            self.get_log.append(rid)
            want = self._slice_crcs.get(rid)

            def attempt_slice():
                kind = faults.poll(_SITE_GET)
                maps = self._base_maps(base)
                if kind == "corrupt":
                    # the damage lands in the rows this read returns
                    a = maps[0]
                    _corrupt_file(self._path(base, 0),
                                  a.offset + hi * a.strides[0] - 1)
                t0 = time.perf_counter()
                if want is None:
                    self._verify(base)
                out = tuple(np.array(a[lo:hi]) for a in maps)
                if want is not None:
                    got = tuple(_crc_rows(a) for a in out)
                    if got != want:
                        raise CorruptFragmentError(
                            _SITE_GET, f"slice {rid} (run {base} rows "
                            f"[{lo}, {hi})): CRC32 {got} != recorded {want}")
                crc_s[0] += time.perf_counter() - t0
                return out

            return self._traced_get(rid, attempt_slice, crc_s)
        if rid not in self._widths:
            raise KeyError(f"no run {rid} in store")
        self.get_log.append(rid)

        def attempt():
            kind = faults.poll(_SITE_GET)
            if kind == "corrupt":
                _corrupt_file(self._path(rid, self._widths[rid] - 1))
            t0 = time.perf_counter()
            if mmap:
                self._verify(rid)
                out = tuple(np.load(self._path(rid, j), mmap_mode="r",
                                    allow_pickle=False)
                            for j in range(self._widths[rid]))
            else:
                # one read: verify the bytes, then parse those same bytes
                out = tuple(self._read_verified(rid, j)
                            for j in range(self._widths[rid]))
            crc_s[0] += time.perf_counter() - t0
            return out

        return self._traced_get(rid, attempt, crc_s)

    def _base_maps(self, base: int) -> tuple:
        """A base run's arrays memory-mapped, opened once per base (a
        distribute's base is read once per partition)."""
        maps = self._maps.get(base)
        if maps is None:
            try:
                maps = tuple(np.load(self._path(base, j), mmap_mode="r",
                                     allow_pickle=False)
                             for j in range(self._widths[base]))
            except ValueError as e:  # an unparseable header
                raise CorruptFragmentError(
                    _SITE_GET, f"run {base}: {e}") from e
            self._maps[base] = maps
        return maps

    def _read_verified(self, rid: int, j: int) -> np.ndarray:
        path = self._path(rid, j)
        with open(path, "rb") as f:
            data = f.read()
        got, want = zlib.crc32(data), self._crcs[rid][j]
        if got != want:
            raise CorruptFragmentError(
                _SITE_GET, f"run {rid} array {j}: CRC32 {got:#010x} != "
                f"recorded {want:#010x} ({path})")
        return np.load(io.BytesIO(data), allow_pickle=False)

    def _traced_get(self, rid: int, attempt, crc_s: list):
        """Run one get attempt under the retry contract, a ``store.get``
        span (bytes returned + CRC-verify wall) and the byte ledger."""
        with trace.span("store.get", store=self.site_prefix,
                        rid=rid) as sp:
            try:
                out = faults.with_retries(
                    _SITE_GET, attempt,
                    on_retry=lambda: self._count("get.retry"))
            except BaseException:
                self.get_log_bytes.append(0)
                raise
            nbytes = sum(int(a.nbytes) for a in out)
            sp.set(bytes=nbytes, crc_s=crc_s[0])
        self.get_log_bytes.append(nbytes)
        metrics.counter(f"store.{self.site_prefix}.get.calls").inc()
        metrics.counter(f"store.{self.site_prefix}.get.bytes").inc(nbytes)
        return out

    def _verify(self, rid: int) -> None:
        for j, crc in enumerate(self._crcs.get(rid, ())):
            path = self._path(rid, j)
            got = _crc_file(path)
            if got != crc:
                raise CorruptFragmentError(
                    _SITE_GET,
                    f"run {rid} array {j}: CRC32 {got:#010x} != recorded "
                    f"{crc:#010x} ({path})")

    def delete(self, rid: int) -> None:
        """Drop one run or slice.  A file already missing is swallowed —
        but counted (``delete.missing``); transient removal failures
        retry, anything else surfaces as the typed permanent error."""
        if rid in self._slices:
            base, _, _ = self._slices.pop(rid)
            self._slice_crcs.pop(rid, None)
            self._base_refs[base] -= 1
            last = self._base_refs[base] == 0
            if last:  # last slice: drop the base run
                del self._base_refs[base]
                # the journal must never name a deleted base.  A slice
                # dropped while its base lives need not be journaled: only
                # a finished partition's slices are dropped, and a resume
                # drops those again (``rid in store``), counting down the
                # base as here — and rewriting the whole table at every
                # slice would cost the slice count squared
                self._persist_slices()
                self.delete(base)
            return
        width = self._widths[rid]
        self._maps.pop(rid, None)

        def attempt():
            faults.poll(_SITE_DELETE)
            for j in range(width):
                try:
                    os.remove(self._path(rid, j))
                except FileNotFoundError:
                    self._count("delete.missing")
            try:
                os.remove(self._meta_path(rid))
            except FileNotFoundError:
                self._count("delete.missing")

        faults.with_retries(
            _SITE_DELETE, attempt,
            on_retry=lambda: self._count("delete.retry"))
        self._widths.pop(rid)
        self._crcs.pop(rid, None)

    def distribute(self, words, payloads: tuple, pid, num_partitions: int,
                   *, backend: Optional[str] = None,
                   slice_rows: Optional[int] = None) -> list:
        """Chunk-level spill: ONE partition-ordered run for the whole
        chunk (the device split of :meth:`PlacementStore._split`), and
        per-partition *slice* fragments referencing row ranges of it —
        O(chunks) ``.npy`` files instead of O(chunks × partitions).  Rows
        with ``pid < 0`` never reach disk.  Each slice records the CRC32
        of its own rows, so its read verifies what it returns."""
        site = _SITE_DISTRIBUTE
        with trace.span("store.distribute", store=self.site_prefix,
                        partitions=num_partitions,
                        rows=int(words.shape[0])):
            faults.with_retries(
                site, lambda: faults.poll(site),
                on_retry=lambda: self._count("distribute.retry"))
            frag_ids: list = [[] for _ in range(num_partitions)]
            w, pays, bounds = self._split(words, payloads, pid,
                                          num_partitions, backend, slice_rows)
            if w.shape[0] == 0:
                return frag_ids
            base = self.put(w, *pays)
            refs = 0
            for i in range(num_partitions):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                if hi > lo:
                    sid = self._new_id()
                    self._slices[sid] = (base, lo, hi)
                    self._slice_crcs[sid] = tuple(
                        _crc_rows(a[lo:hi]) for a in (w, *pays))
                    refs += 1
                    self.put_log.append(sid)
                    # a slice writes no new bytes: its rows live in the
                    # base run whose put just accounted them
                    self.put_log_bytes.append(0)
                    frag_ids[i].append(sid)
            self._base_refs[base] = refs
            self._persist_slices()
            return frag_ids

    # -- the log channel -------------------------------------------------------

    def write_log(self, name: str, payload: dict) -> None:
        """Atomically journal a named JSON record (tmp + ``os.replace``)
        with a CRC32 over the canonical payload encoding."""
        data = json.dumps(payload, sort_keys=True).encode()
        rec = {"crc32": zlib.crc32(data), "payload": payload}

        def attempt():
            faults.poll(_SITE_PUT)
            self._write_json_atomic(self._log_path(name), rec)

        faults.with_retries(
            _SITE_PUT, attempt, on_retry=lambda: self._count("log.retry"))

    def read_log(self, name: str) -> Optional[dict]:
        path = self._log_path(name)
        try:
            with open(path) as f:
                rec = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            raise CorruptFragmentError(
                _SITE_GET, f"log {name!r} unreadable: {e}") from e
        payload = rec.get("payload")
        data = json.dumps(payload, sort_keys=True).encode()
        if zlib.crc32(data) != rec.get("crc32"):
            raise CorruptFragmentError(
                _SITE_GET, f"log {name!r}: CRC mismatch ({path})")
        return payload

    # -- accounting ------------------------------------------------------------

    def run_ids(self) -> tuple:
        return tuple(sorted(self._widths))

    def __contains__(self, rid: int) -> bool:
        return rid in self._widths or rid in self._slices

    def nbytes(self) -> int:
        """Total on-disk footprint of live runs.  A missing file is
        counted (``nbytes.missing``) and skipped."""

        def attempt():
            total = 0
            for rid, width in self._widths.items():
                for j in range(width):
                    try:
                        total += os.path.getsize(self._path(rid, j))
                    except FileNotFoundError:
                        self._count("nbytes.missing")
            return total

        return faults.with_retries(
            "run_store.nbytes", attempt,
            on_retry=lambda: self._count("nbytes.retry"))

    def close(self) -> None:
        """Drop every run (and the store dir, if this store created it)."""
        self._widths.clear()
        self._crcs.clear()
        self._slices.clear()
        self._slice_crcs.clear()
        self._base_refs.clear()
        self._maps.clear()
        if self._own_root:
            self._cleanup()

    def _count(self, event: str) -> None:
        self.events[event] += 1
        metrics.counter(f"store.{self.site_prefix}.events.{event}").inc()

    def _write_json_atomic(self, path: str, payload: dict) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def _path(self, rid: int, j: int) -> str:
        return os.path.join(self.root, f"run{rid:08d}_{j}.npy")

    def _meta_path(self, rid: int) -> str:
        return os.path.join(self.root, f"run{rid:08d}.meta.json")

    def _log_path(self, name: str) -> str:
        if not name.replace("-", "").replace("_", "").isalnum():
            raise ValueError(f"bad log name {name!r}")
        return os.path.join(self.root, f"{name}.log.json")

    def __len__(self) -> int:
        return len(self._widths)

    def __enter__(self) -> "RunStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass(frozen=True)
class RunSource(ChunkSource):
    """Chunks from stored runs, in the given order.  Single-array runs
    yield the bare array; multi-array runs yield the tuple (keys first)."""

    store: RunStore
    ids: Sequence[int]

    def chunks(self) -> Iterator:
        for rid in self.ids:
            arrays = self.store.get(rid)
            yield arrays[0] if len(arrays) == 1 else arrays
