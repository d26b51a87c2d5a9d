"""DeviceShardStore: partition fragments placed over a process group —
the device implementation of :class:`~repro_torch.stream.chunks.
PlacementStore`.

Port of ``repro.stream.device_store``.  "Shards are runs": the external
sort's histogram → partition → sort loop is placement-agnostic, and this
store swaps the disk run store's spill for collectives while the loop
stays the same:

* :meth:`distribute` routes each chunk's rows to their partition's
  *owner rank* through the bucketed ``all_to_all_single`` of
  :func:`~repro_torch.core.distributed.make_fragment_placer`.  The
  partition → rank map is the contiguous, order-preserving ``owner(i) =
  i * D // P``, so the top-k prune (which keeps only a partition prefix)
  leaves tail ranks fragment-free;
* :meth:`sort_rows` runs each partition through the
  :class:`~repro_torch.core.executor.DistributedBackend` pairs path
  (:func:`~repro_torch.core.distributed.make_distributed_sort_pairs`):
  one stable distributed pass chain per active code word, least
  significant first, the row permutation riding the buckets as the
  payload — wide 16-bit digits by default.

The group is SPMD, one process a rank (NCCL on the card, gloo on the
CPU), and every rank runs the same external loop on the same source:

* :meth:`distribute` hands rank r its equal slice of the chunk (padded to
  a multiple of D) for the placement collective.  Each rank checks the
  words that landed on it against the chunk rows addressed to it (the
  wire-parity check; the verdict is all-reduced, so every rank raises
  together), and the landed tags are all-gathered: every rank's store
  then holds the same fragments, ids, CRCs and ``device_log``, as the
  reference's one process does;
* :meth:`sort_rows` sorts each rank's shard of the padded partition
  collectively and all-gathers the permutation; the words and payloads
  gather on the host by it, so the outputs are the same on every rank.

Fragments live on the host with CRC32s (the failover to disk needs host
mirrors anyway); payload columns of any dtype follow the permutation
there.  The store's device working set (buckets, landing buffers, the
rank kernels' tables) is counted by :meth:`row_cost_bytes` and
:meth:`distribute_bytes`, which size the external loop's partitions and
hold its budget.  Group sizes must be powers of two, so power-of-two
padded partitions shard evenly.
"""

from __future__ import annotations

import time
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import faults
from repro_torch.core.distributed import (group_device, make_fragment_placer,
                                          make_distributed_sort_pairs)
from repro_torch.core.faults import CorruptFragmentError, StorePermanentError
from repro_torch.core.fractal_sort import resolve_device
from repro_torch.core.fractal_tree import ceil_log2
from repro_torch.kernels.fractal_rank import (SCATTER_TILE,
                                              scatter_table_entries,
                                              wide_rank_scratch_bytes)
from repro_torch.obs import metrics, trace
from repro_torch.query.codec import word_widths
from repro_torch.stream.chunks import (Bytes, MemoryBudget, PlacementStore,
                                       _host, _host_words)

__all__ = ["DeviceShardStore", "shard_placement_bytes", "shard_sort_bytes"]

#: padding sentinel rows (all-ones words sort stably after every real row)
_SENTINEL = np.uint32(0xFFFFFFFF)

# the device store's injection sites (chaos-matrix enumerable), the same
# names as the reference's
_SITE_PUT = faults.register_site("device_store.put")
_SITE_GET = faults.register_site("device_store.get")
_SITE_DELETE = faults.register_site("device_store.delete")
_SITE_DISTRIBUTE = faults.register_site("device_store.distribute")
_SITE_SORT = faults.register_site("device_store.sort_rows")


def shard_sort_bytes(padded_rows: int, rows: int, num_words: int,
                     payload_bytes: int, group_size: int = 1) -> int:
    """Bytes one distributed partition sort holds at once on a rank, host
    and device: ``rows`` real rows padded to ``padded_rows``, sharded over
    ``group_size`` ranks.

    Per padded row: the host's padded words (``4 * num_words``), the
    gathered int32 permutation (4) and the word column on the device (4).
    Per shard row on the device, 48: the pass's key and payload, digit,
    rank, destination, slot and bucket position, the int64 bucket index
    and the send and receive buckets, live at once as the pass runs
    (the most of them at once, with a margin).  The local rank's scratch
    at 2**16 bins: K3's (tiles, 2**16) count table and its scan, or K2's
    two-level scratch, whichever is larger.  Per real row: the loaded and
    the sorted words on the host (``4 * num_words`` each), the payloads
    loaded and gathered (``payload_bytes`` each) and the int64 row ids
    (8)."""
    shard = -(-padded_rows // max(group_size, 1))
    table = max(8 * scatter_table_entries(shard, 1 << 16),
                wide_rank_scratch_bytes(shard, 1 << 16)) if shard else 0
    return (padded_rows * (4 * num_words + 8) + shard * 48 + table
            + rows * (8 * num_words + 2 * payload_bytes + 8))


def shard_placement_bytes(rows: int, slice_rows: int, num_words: int,
                          payload_bytes: int, group_size: int = 1) -> int:
    """Bytes one :meth:`DeviceShardStore.distribute` of a ``rows``-row
    chunk holds beside the chunk, placing ``slice_rows`` rows at a time.
    Per slice row (padded to the group): the host's padded words, ids
    and tags (``4 * num_words + 8``); on the device the rank's slice of
    them, the bucket ranks and the int64 bucket index (``4 * num_words +
    41``, the whole slice on one rank at most), the send and receive
    buckets of words and tags (``2 * (4 * num_words + 4)``) and the
    gathered tags on the device and the host (``8 * group_size``).  Per
    chunk row on the host: the landed rows' tags (8), the words checked
    against the wire (``4 * num_words``) and the fragment's words and
    payloads (``4 * num_words + payload_bytes``)."""
    D = max(group_size, 1)
    t = -(-max(slice_rows, 1) // D) * D
    w = 4 * num_words
    return (t * ((w + 8) + (w + 41) + 2 * (w + 4) + 8 * D)
            + rows * (8 + 2 * w + payload_bytes))


def _array_crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _flip_byte(a: np.ndarray) -> np.ndarray:
    """A copy with its last byte flipped — the injection registry's
    stand-in for a corrupted host mirror; CRC verification must catch
    it.  (An empty array has no byte to damage and passes through.)"""
    if a.nbytes == 0:
        return a
    b = np.ascontiguousarray(a).copy()
    b.reshape(-1).view(np.uint8)[-1] ^= 0xFF
    return b


class DeviceShardStore(PlacementStore):
    """Partition fragments placed over a process group; partition sorts
    run distributed.

    ``group`` is a ``torch.distributed`` process group of a power-of-two
    size (``None``: the default group; raises when none is initialised).
    ``device`` is where the collectives and kernels run: ``None`` means
    the card, whose group must be NCCL; ``"cpu"`` needs a gloo group.
    :meth:`distribute` and :meth:`sort_rows` take the local pass backend
    ("cuda": the kernels, or "torch"; default from the device) as every
    store does.  Every rank constructs the store
    and runs the same external loop; :meth:`get` hands fragments back as
    host arrays, so the loop's fragment handling is placement-blind."""

    #: partition sorts are collectives — dispatching them from several
    #: host threads at once would interleave them, so the external loop
    #: keeps this store sequential.
    supports_concurrent_sorts = False

    #: each partition sort already spans the group; batching partitions
    #: would re-shard them for no new parallelism, so batched dispatch
    #: falls back to the serial per-partition loop here.
    supports_batched_sorts = False

    site_prefix = "device_store"

    #: fragments keep host mirrors, so when the group fails permanently
    #: mid-sort the external loop can migrate the remaining partitions to
    #: a disk store and finish bit-exact.
    failover_to_disk = True

    def __init__(self, group=None, device=None, batch: int = 1024,
                 max_bins_log2: int = 16):
        want = resolve_device(device)
        have = group_device(group)
        if want.type != have.type:
            raise ValueError(
                f"device {want.type!r} but the process group's collectives "
                f"run on {have.type!r} (NCCL: the card, gloo: the CPU)")
        self.group = group
        self.device = have
        self.batch = batch
        self.max_bins_log2 = max_bins_log2
        self._D = dist.get_world_size(group)
        self._rank = dist.get_rank(group)
        if self._D & (self._D - 1):
            raise ValueError(f"group size {self._D} must be a power of two "
                             "so power-of-two padded partitions shard evenly")
        self._next_id = 0
        self._frags: dict = {}       # rid -> tuple of host arrays
        self._crcs: dict = {}        # rid -> per-array CRC32 at put time
        self._frag_dev: dict = {}    # rid -> landing rank (None: direct put)
        self.put_log: list = []
        self.get_log: list = []
        #: bytes per successful put/get, aligned with the logs (same
        #: contract as :class:`~repro_torch.stream.chunks.RunStore`)
        self.put_log_bytes: list = []
        self.get_log_bytes: list = []
        #: (fragment id, rank) per placed fragment — the counting record
        #: for "pruned ranks receive zero fragments"
        self.device_log: list = []
        # the collectives, built once a shape: the store pads every slice
        # and partition to the group itself, so they skip the shard check
        self._placers: dict = {}     # (num_words, backend) -> placer
        self._pair_sorts: dict = {}  # (bits, backend) -> pairs sort

    def _placer(self, num_words: int, backend: Optional[str]):
        key = (num_words, backend)
        if key not in self._placers:
            self._placers[key] = make_fragment_placer(
                self.group, num_words, batch=self.batch, backend=backend,
                check_shards=False)
        return self._placers[key]

    def _pair_sort(self, bits: int, backend: Optional[str]):
        key = (bits, backend)
        if key not in self._pair_sorts:
            self._pair_sorts[key] = make_distributed_sort_pairs(
                self.group, bits, num_payloads=1, batch=self.batch,
                max_bins_log2=self.max_bins_log2, backend=backend,
                check_shards=False)
        return self._pair_sorts[key]

    # -- capacity accounting --------------------------------------------------

    @property
    def num_devices(self) -> int:
        return self._D

    def owner(self, partition: int, num_partitions: int) -> Optional[int]:
        """Contiguous, order-preserving partition → rank map: rank ``d``
        owns partitions ``[ceil(d*P/D), ceil((d+1)*P/D))``.  Order
        preservation is what makes the top-k prune a *device* prune — a
        kept partition prefix maps onto a rank prefix."""
        if not 0 <= partition < num_partitions:
            raise ValueError(f"partition {partition} of {num_partitions}")
        return partition * self._D // max(num_partitions, 1)

    def row_cost_bytes(self, num_words: int, payload_bytes: int = 0) -> int:
        """Per-row byte cost the budget sizes this store's partitions by:
        :func:`shard_sort_bytes` with one rank holding the whole shard
        (the most a rank holds), per padded row over whole K3 tiles (its
        table grows a tile at a time), at 2x padding as
        :func:`~repro_torch.stream.chunks.row_cost_bytes` reckons."""
        pad = shard_sort_bytes(SCATTER_TILE, 0, num_words,
                               payload_bytes) // SCATTER_TILE
        real = shard_sort_bytes(0, 1, num_words, payload_bytes)
        return pad + -(-real // 2)

    def distribute_bytes(self, rows: int, slice_rows: int, num_words: int,
                         payload_bytes: int) -> int:
        return shard_placement_bytes(rows, slice_rows, num_words,
                                     payload_bytes, self._D)

    def nbytes(self) -> int:
        return sum(int(a.nbytes) for arrays in self._frags.values()
                   for a in arrays)

    # -- fragment put/get -----------------------------------------------------

    def put(self, *arrays, partition: Optional[int] = None) -> int:
        """Store one fragment on the host (tensors copied there first); the
        landing rank is recorded by :meth:`distribute` — direct puts
        (result runs, failover) have none.  Per-array CRC32s let
        :meth:`get` detect a damaged mirror as the disk store detects a
        torn spill."""
        if not arrays:
            raise ValueError("a fragment holds at least one array")
        rid = self._next_id
        self._next_id += 1

        def attempt():
            kind = faults.poll(_SITE_PUT)
            held = tuple(np.ascontiguousarray(_host(a)) for a in arrays)
            crcs = tuple(_array_crc(a) for a in held)
            if kind == "corrupt":  # CRCs record the intended bytes
                held = held[:-1] + (_flip_byte(held[-1]),)
            return held, crcs

        nbytes = sum(int(a.nbytes) for a in arrays)
        with trace.span("store.put", store=self.site_prefix, rid=rid,
                        bytes=nbytes, arrays=len(arrays)):
            held, crcs = faults.with_retries(_SITE_PUT, attempt)
        self._frags[rid] = held
        self._crcs[rid] = crcs
        self._frag_dev[rid] = None
        self.put_log.append(rid)
        self.put_log_bytes.append(nbytes)
        metrics.counter(f"store.{self.site_prefix}.put.calls").inc()
        metrics.counter(f"store.{self.site_prefix}.put.bytes").inc(nbytes)
        return rid

    def get(self, rid: int, mmap: bool = False):
        if rid not in self._frags:
            raise KeyError(f"no fragment {rid} in store")
        self.get_log.append(rid)
        crc_s = [0.0]  # CRC-verify wall, summed across retry attempts

        def attempt():
            kind = faults.poll(_SITE_GET)
            if kind == "corrupt":
                arrays = self._frags[rid]
                self._frags[rid] = arrays[:-1] + (_flip_byte(arrays[-1]),)
            arrays = self._frags[rid]
            t0 = time.perf_counter()
            for j, crc in enumerate(self._crcs.get(rid, ())):
                got = _array_crc(arrays[j])
                if got != crc:
                    raise CorruptFragmentError(
                        _SITE_GET,
                        f"fragment {rid} array {j}: CRC32 {got:#010x} != "
                        f"recorded {crc:#010x}")
            crc_s[0] += time.perf_counter() - t0
            return arrays

        with trace.span("store.get", store=self.site_prefix,
                        rid=rid) as sp:
            try:
                out = faults.with_retries(_SITE_GET, attempt)
            except BaseException:
                self.get_log_bytes.append(0)
                raise
            nbytes = sum(int(a.nbytes) for a in out)
            sp.set(bytes=nbytes, crc_s=crc_s[0])
        self.get_log_bytes.append(nbytes)
        metrics.counter(f"store.{self.site_prefix}.get.calls").inc()
        metrics.counter(f"store.{self.site_prefix}.get.bytes").inc(nbytes)
        return out

    def delete(self, rid: int) -> None:
        faults.with_retries(
            _SITE_DELETE, lambda: faults.poll(_SITE_DELETE))
        self._frags.pop(rid)
        self._crcs.pop(rid, None)
        self._frag_dev.pop(rid, None)

    def __contains__(self, rid: int) -> bool:
        return rid in self._frags

    def run_ids(self) -> tuple:
        return tuple(sorted(self._frags))

    def close(self) -> None:
        self._frags.clear()
        self._crcs.clear()
        self._frag_dev.clear()

    def fragment_device(self, rid: int) -> Optional[int]:
        """Rank a placed fragment landed on (None for direct puts)."""
        return self._frag_dev.get(rid)

    def __len__(self) -> int:
        return len(self._frags)

    # -- the placement collective ---------------------------------------------

    def _check_device(self, device) -> None:
        if device is not None and resolve_device(device).type \
                != self.device.type:
            raise ValueError(f"the store works on {self.device.type}, the "
                             f"caller asked for {resolve_device(device)}")

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        """Every rank's ``t`` (equal shapes), rank order, on the host."""
        if self._D == 1:
            return t.cpu().numpy()[None]
        every = [torch.empty_like(t) for _ in range(self._D)]
        dist.all_gather(every, t, group=self.group)
        return torch.stack(every).cpu().numpy()

    def distribute(self, words, payloads: tuple, pid, num_partitions: int,
                   *, backend: Optional[str] = None,
                   slice_rows: Optional[int] = None) -> list:
        """Place one chunk's rows on their partitions' owner ranks through
        the placement collective, ``slice_rows`` rows at a time (all at
        once by default).  Pruned rows (``pid < 0``) drop on the wire; per
        chunk each partition lands at most one fragment (its owner is
        unique), rows in arrival order.  ``pid`` may be a callable
        ``pid(lo, hi)``, and ``backend`` names the local pass backend, as
        for every store."""
        words = _host_words(words)
        n = int(words.shape[0])
        frag_ids: list = [[] for _ in range(num_partitions)]
        if n == 0:
            return frag_ids
        # byte attribution stays with the nested store.put spans: this
        # span carries placement shape only
        with trace.span("store.distribute", store=self.site_prefix,
                        partitions=num_partitions, rows=n, devices=self._D):
            return self._distribute(words, payloads, pid, num_partitions,
                                    frag_ids, backend, slice_rows)

    def _distribute(self, words, payloads, pid, num_partitions, frag_ids,
                    backend, slice_rows):
        n, num_words = int(words.shape[0]), int(words.shape[1])
        D = self._D
        # the injection point sits before the collective fires, so a
        # transient retry re-enters a clean distribute (the per-fragment
        # puts retry inside put itself)
        faults.with_retries(
            _SITE_DISTRIBUTE, lambda: faults.poll(_SITE_DISTRIBUTE))
        pid = _host(pid(0, n) if callable(pid) else pid).astype(np.int64)
        payloads = tuple(_host(p) for p in payloads)
        owner_lut = np.asarray(
            [self.owner(i, num_partitions) for i in range(num_partitions)],
            np.int32)
        dest = np.where(pid >= 0, owner_lut[np.clip(pid, 0, None)],
                        -1).astype(np.int32)
        placer = self._placer(num_words, backend)
        step = n if slice_rows is None else max(1, int(slice_rows))
        landed = [[] for _ in range(D)]  # each rank's chunk rows, in order
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            # pad to the group (dropped rows), rank r takes its equal slice
            t = -(-(hi - lo) // D) * D
            shard = t // D
            part_w = np.full((t, num_words), _SENTINEL, np.uint32)
            part_w[:hi - lo] = words[lo:hi]
            part_d = np.full((t,), -1, np.int32)
            part_d[:hi - lo] = dest[lo:hi]
            part_t = np.full((t,), -1, np.int32)
            part_t[:hi - lo] = np.arange(lo, hi, dtype=np.int32)
            mine = slice(self._rank * shard, (self._rank + 1) * shard)
            lw, lt = placer(
                torch.from_numpy(part_w[mine].view(np.int32)).to(self.device),
                torch.from_numpy(part_d[mine]).to(self.device),
                torch.from_numpy(part_t[mine]).to(self.device))
            # the wire must have carried exactly the rows addressed to this
            # rank, in arrival order — the device data IS the fragment
            tags = lt.cpu().numpy()
            valid = tags >= 0
            ok = np.array_equal(lw.cpu().numpy()[valid].view(np.uint32),
                                words[tags[valid]])
            flag = torch.tensor([0 if ok else 1], dtype=torch.int32,
                                device=self.device)
            if D > 1:
                dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
            if int(flag[0]):
                raise CorruptFragmentError(
                    _SITE_DISTRIBUTE,
                    "fragment placement parity violation: landed words "
                    "differ from the chunk rows addressed to a rank")
            for d, tag_d in enumerate(self._gather(lt)):
                landed[d].append(tag_d[tag_d >= 0])
            del lw, lt
        for d in range(D):
            tags = np.concatenate(landed[d]).astype(np.int64)
            if not tags.size:
                continue
            # group the landed rows by partition, arrival order kept
            pids_d = pid[tags]
            order = np.argsort(pids_d, kind="stable")
            parts, starts = np.unique(pids_d[order], return_index=True)
            for i, lo, hi in zip(parts, starts,
                                 np.append(starts[1:], tags.size)):
                sel = tags[order[lo:hi]]
                rid = self.put(words[sel], *(p[sel] for p in payloads),
                               partition=int(i))
                self._frag_dev[rid] = d
                self.device_log.append((rid, d))
                frag_ids[int(i)].append(rid)
        return frag_ids

    # -- the distributed partition sort ---------------------------------------

    def sort_rows(self, words: np.ndarray, payloads: tuple, bits: int,
                  sort_bits: int, budget: MemoryBudget, plans=None, *,
                  device=None, backend: Optional[str] = None):
        """Stable distributed sort of one partition on its undetermined
        low ``sort_bits``: per active code word (least significant first)
        one DistributedBackend pairs run places the word column at its
        exact global ranks with the accumulated row permutation riding as
        the payload — stability across shard boundaries is the backend's
        (rank, arrival) tie-break.  The words and payloads gather on the
        host by the final permutation.  ``plans`` (the external loop's
        hoisted local plans) is accepted for protocol compatibility and
        ignored: the distributed sort fixes its own wide per-word passes
        (``max_bins_log2``).  ``device`` must be the store's, when given;
        ``backend`` names the local pass backend."""
        m = int(words.shape[0])
        if m <= 1 or sort_bits == 0:
            return words, payloads
        self._check_device(device)
        return faults.with_retries(
            _SITE_SORT, lambda: self._sort_rows_once(
                _host_words(words), tuple(_host(p) for p in payloads), bits,
                sort_bits, budget, backend))

    def _sort_rows_once(self, words, payloads, bits, sort_bits, budget,
                        backend):
        m, num_words = int(words.shape[0]), int(words.shape[1])
        widths = word_widths(bits)
        # word j covers code bits [lo_j, lo_j + widths[j]); only bits
        # below sort_bits are undetermined.  The width quantizes UP to a
        # multiple of 8: the extra low bits are shared-prefix bits, equal
        # in every row of the partition, so sorting on them changes
        # nothing (the reference's choice, which caps its compiled
        # programs; here it keeps the plans to 8-bit and 16-bit fields)
        active, lo = [], bits
        for j, wj in enumerate(widths):
            lo -= wj
            eff = min(sort_bits - lo, wj)
            if eff > 0:
                active.append((j, min(-(-eff // 8) * 8, wj)))
        if not active:
            return words, payloads
        D = self._D
        t = max(D, 1 << ceil_log2(m))
        padded = words
        if t > m:
            padded = np.concatenate(
                [words, np.full((t - m, num_words), _SENTINEL, np.uint32)])
        pay_bytes = sum(p.dtype.itemsize for p in payloads)
        # held for the sort's duration, so a mid-collective failure
        # releases it
        with budget.hold(Bytes(shard_sort_bytes(t, m, num_words, pay_bytes,
                                                D))):
            faults.poll(_SITE_SORT)
            shard = t // D
            perm = torch.arange(self._rank * shard, (self._rank + 1) * shard,
                                dtype=torch.int32, device=self.device)
            for j, eff in reversed(active):
                col = torch.from_numpy(np.ascontiguousarray(
                    padded[:, j]).view(np.int32)).to(self.device)
                key = col[perm]  # the word under the current permutation
                del col
                _, perm, overflow = self._pair_sort(eff, backend)(key, perm)
                del key
                if bool(overflow):
                    # worst-case capacity was provisioned; overflowing it
                    # means the collective itself misbehaved — retrying
                    # the same sort is futile
                    raise StorePermanentError(
                        _SITE_SORT,
                        "distributed partition sort overflowed its "
                        "all_to_all buckets despite worst-case capacity")
            rowids = self._gather(perm).reshape(-1)[:m].astype(np.int64)
            del perm
            # all-ones sentinels sort after every real row (stability:
            # they also arrive after), so the first m slots are real rows
            if m < t and int(rowids.max(initial=-1)) >= m:
                raise AssertionError("a padding row sorted among the real "
                                     "rows")
            sorted_words = padded[rowids]
            gathered = tuple(p[rowids] for p in payloads)
        budget.charge(padded, sorted_words, rowids, *payloads, *gathered)
        return sorted_words, gathered
