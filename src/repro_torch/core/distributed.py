"""Multi-rank FractalSort over ``torch.distributed``: the paper's
local → global histogram merge (§III.A/B) mapped onto collectives.

Port of ``repro.core.distributed``.  The reference is one process over a
jax mesh (``shard_map`` programs); this port is SPMD: one process a rank,
each holding its shard, every rank calling the same entry point with its
own shard (NCCL on the card, gloo on the CPU).  On a group of D ranks
one pass on a ``<= 16``-bit field is:

1. the local histogram of the rank's shard (the local backend's: K1 on
   the card);
2. ``all_reduce`` of the histograms (the reference's ``psum``), and an
   ``all_gather`` of every rank's counts for its arrival offset inside
   each bin (ranks are ordered, so the sort is stable across them); the
   gathered counts travel as the bytes of uint16 counts when a shard
   holds fewer than 2**16 keys (the reference's tapered wire; neither
   gloo nor NCCL gathers uint16);
3. the local stable rank with bin starts ``global_start + before_me``, so
   one launch (K2, or K3 by the pass's engine hint) gives every key its
   exact global slot;
4. the destination rank and the slot inside it; a stable rank over the D
   destinations (K2) gives each key its place in a fixed-capacity send
   bucket, and two ``all_to_all_single`` exchanges (slots, then keys; one
   more a payload column) move every key once into equal output shards.

A pass ranks a full field, so placement is exact; ``p <= 16`` is one pass
and ``p <= 32`` two (:data:`DISTRIBUTED_MAX_BINS_LOG2`).  Bucket capacity
is ``min(int(cf * (n // D) / D) + 1, n // D)`` with ``cf =
capacity_factor`` (default D: no overflow is possible); entries past it
drop, their output slots stay 0, and the returned overflow flag (equal on
every rank) says so — the reference's drop rule, bit for bit.

Pass sequencing lives in :class:`~repro_torch.core.executor.PlanExecutor`;
this module provides the per-pass collective (:func:`_distributed_pass`)
that :class:`~repro_torch.core.executor.DistributedBackend` wraps.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.executor import (DistributedBackend, PassBackend,
                                       PlanExecutor, _like_keys, _signed)
from repro_torch.core.fractal_sort import make_backend
from repro_torch.core.fractal_tree import exclusive_cumsum
from repro_torch.core.sort_plan import (make_sort_plan, pick_engine,
                                        scatter_tile_len)

__all__ = [
    "DISTRIBUTED_MAX_BINS_LOG2",
    "distributed_fractal_argsort",
    "distributed_fractal_sort",
    "group_device",
    "make_distributed_argsort",
    "make_distributed_sort",
    "make_distributed_sort_pairs",
    "make_fragment_placer",
]

#: Distributed plans default to the paper's wide two-field scheme: every
#: extra pass costs one more exchange round, so 16-bit digits (<= 2 passes
#: for p <= 32) win on the wire.
DISTRIBUTED_MAX_BINS_LOG2 = 16

def group_device(group=None) -> torch.device:
    """The device a process group's collectives run on: the current card
    for NCCL, the CPU for gloo.  Raises without an initialised group."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is "
                           "initialised; call init_process_group first")
    name = str(dist.get_backend(group))
    if name == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if name == "gloo":
        return torch.device("cpu")
    raise ValueError(f"process group backend {name!r}: nccl (the card) or "
                     "gloo (the CPU)")


def _check_tensors(device: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != device.type:
            raise ValueError(f"a {t.device.type} tensor on a process group "
                             f"whose collectives run on {device.type}")


def _equal_shards(n_local: int, group, device: torch.device) -> None:
    """Raise unless every rank holds ``n_local`` rows."""
    D = dist.get_world_size(group)
    mine = torch.tensor([n_local], dtype=torch.int64, device=device)
    every = [torch.empty_like(mine) for _ in range(D)]
    dist.all_gather(every, mine, group=group)
    sizes = [int(s) for s in every]
    if len(set(sizes)) != 1:
        raise ValueError(f"shards must be equal; the ranks hold {sizes} rows")


def _put(src: torch.Tensor, at: torch.Tensor, rows: int,
         fill=0) -> torch.Tensor:
    """``src[i]`` at row ``at[i]`` of ``rows`` rows filled with ``fill``,
    in ``src``'s dtype; ``at[i] == rows`` drops it (the reference's
    ``mode="drop"``: a spare last row takes it and is cut off)."""
    s = _signed(src)
    out = torch.full((rows + 1,) + tuple(s.shape[1:]), fill, dtype=s.dtype,
                     device=s.device)
    out[at] = s
    return out[:rows].view(src.dtype)


def _route(vals: torch.Tensor, at: torch.Tensor, rows: int, fill,
           group) -> torch.Tensor:
    """One bucketed ``all_to_all_single``: ``vals`` put into a ``rows``-row
    send buffer (D equal buckets, one a rank; :func:`_put`).  Returns the
    buffer received."""
    send = _signed(_put(vals, at, rows, fill))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.view(vals.dtype)


def _distributed_pass(u: torch.Tensor, shift: int, bits: int, group,
                      capacity: int, batch: int, taper_wire: bool,
                      payloads: tuple = (), engine: Optional[str] = None, *,
                      backend: PassBackend):
    """One stable distributed counting pass on key bits [shift, shift+bits).

    ``u`` is this rank's shard (int32 storage of uint32 bits); returns the
    re-shuffled shard ``(u, *payloads)`` (keys at their exact global rank
    for this field, payloads through the same buckets) and the overflow
    flag, a 0-dim bool tensor equal on every rank.  ``backend`` is the
    local pass backend (histogram and rank of the shard); ``engine`` the
    pass's local rank engine hint (``None``: the cost model)."""
    n_local = u.shape[0]
    D = dist.get_world_size(group)
    me = dist.get_rank(group)
    dev = u.device
    n_bins = 1 << bits
    field = (u >> shift) & (n_bins - 1)

    # (1) local histogram
    local_counts = backend.histogram(field, n_bins)

    # (2) global merge, and (3) every rank's counts for my arrival offset:
    # the tapered wire is a uint16 count's two bytes (a shard of < 2**16
    # keys holds no more in a bin)
    global_counts = local_counts.clone()
    dist.all_reduce(global_counts, group=group)
    taper = taper_wire and n_local < (1 << 16)
    wire = local_counts.to(torch.int16).view(torch.uint8) if taper \
        else local_counts
    every = [torch.empty_like(wire) for _ in range(D)]
    dist.all_gather(every, wire, group=group)
    before_me = torch.zeros((n_bins,), dtype=torch.int32, device=dev)
    for c in every[:me]:
        before_me += (c.view(torch.int16).to(torch.int32) & 0xFFFF) if taper \
            else c
    del every, wire

    # the local stable rank from bin starts global_start + before_me: each
    # key's exact global slot in one rank launch
    if engine is None:
        engine = pick_engine(n_local, bits)
    rank_batch = scatter_tile_len(n_bins, batch) if engine == "scatter" \
        else batch
    global_rank, _, _ = backend.rank(
        field, n_bins, batch_hint=rank_batch,
        bin_start=exclusive_cumsum(global_counts) + before_me, engine=engine,
        counts=local_counts)
    del field

    # (4) route each key to the rank owning its output slot (equal shards)
    dest = torch.clamp(global_rank // n_local, 0, D - 1)
    slot = global_rank - dest * n_local
    del global_rank
    pos, dest_counts, _ = backend.rank(
        dest, D, batch_hint=batch,
        bin_start=torch.zeros((D,), dtype=torch.int32, device=dev),
        engine="onehot")
    flag = (dest_counts > capacity).any().to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    # fixed-capacity buckets: entries past the capacity drop (flagged)
    rows = D * capacity
    at = torch.where(pos < capacity, dest.to(torch.int64) * capacity + pos,
                     rows)
    del dest, pos
    recv_slot = _route(slot, at, rows, -1, group)
    del slot
    # empty bucket slots (-1) drop too
    into = torch.where(recv_slot >= 0, recv_slot, n_local).to(torch.int64)
    del recv_slot
    out = tuple(_put(_route(vals, at, rows, 0, group), into, n_local)
                for vals in (u,) + tuple(payloads))
    return out, flag[0] > 0


def _overflow(backend: DistributedBackend, like: torch.Tensor):
    return (backend.overflow if backend.overflow is not None
            else torch.zeros((), dtype=torch.bool, device=like.device))


def _sort_body(keys, *, plan, group, capacity: int, batch: int,
               taper_wire: bool, local: PassBackend):
    """Executor over the DistributedBackend: every plan pass is exact
    placement on its field (``reconstructs = False``), so the composition
    is a stable full-precision sort."""
    backend = DistributedBackend(group, local, capacity, batch=batch,
                                 taper_wire=taper_wire)
    out = PlanExecutor(backend).run(keys, plan)
    return _like_keys(out, keys), _overflow(backend, keys)


def _make_distributed(body_fn, group, p: int,
                      capacity_factor: Optional[float], batch: int,
                      taper_wire: bool, max_bins_log2: Optional[int],
                      num_payloads: int = 0, backend: Optional[str] = None,
                      check_shards: bool = True):
    """Shared scaffolding of the distributed entry points: the group's
    device and local backend, the plan, and the capacity/overflow rule —
    so sort, argsort and the pairs sort can never diverge on them.
    ``body_fn`` runs on each rank's shard, ``1 + num_payloads`` tensors
    (keys first); ``check_shards`` gathers the shard sizes and raises
    unless they are equal."""
    device = group_device(group)
    D = dist.get_world_size(group)
    cf = float(D) if capacity_factor is None else capacity_factor
    if max_bins_log2 is None:
        max_bins_log2 = DISTRIBUTED_MAX_BINS_LOG2
    local = make_backend(backend, device, batch=batch)

    def fn(keys, *payloads):
        if len(payloads) != num_payloads:
            raise ValueError(f"expected {num_payloads} payload columns, got "
                             f"{len(payloads)}")
        _check_tensors(device, keys, *payloads)
        n_local = int(keys.shape[0])
        if any(int(pv.shape[0]) != n_local for pv in payloads):
            raise ValueError("payload columns must match the key shard")
        if check_shards:
            _equal_shards(n_local, group, device)
        n = n_local * D
        plan = make_sort_plan(n, p, max_bins_log2=max_bins_log2)
        cap = min(int(cf * (n // D) / D) + 1, n // D)
        return body_fn(keys, *payloads, plan=plan, group=group, capacity=cap,
                       batch=batch, taper_wire=taper_wire, local=local)

    return fn


def make_distributed_sort(group, p: int,
                          capacity_factor: Optional[float] = None,
                          batch: int = 1024, taper_wire: bool = True,
                          max_bins_log2: Optional[int] = None,
                          backend: Optional[str] = None):
    """Build a distributed sort over the process ``group`` (``None``: the
    default group).

    Returns ``fn(local_keys) -> (local_sorted, overflow)``, which every
    rank calls collectively with its shard: rank r holds global rows
    ``[r*n/D, (r+1)*n/D)`` of keys in ``[0, 2**p)``, ``p <= 32`` (int32 or
    uint32), shards equal, on the group's device (the card for NCCL, the
    CPU for gloo).  ``overflow`` is a 0-dim bool tensor, equal on every
    rank.  ``capacity_factor`` defaults to the group size
    (worst-case-safe); ``max_bins_log2`` bounds the digit width (default
    :data:`DISTRIBUTED_MAX_BINS_LOG2`); ``backend`` names the local pass
    backend ("cuda" or "torch"; default from the device)."""
    return _make_distributed(_sort_body, group, p, capacity_factor, batch,
                             taper_wire, max_bins_log2, backend=backend)


def distributed_fractal_sort(keys, group, p: int, **kw):
    """One-shot convenience wrapper around :func:`make_distributed_sort`."""
    return make_distributed_sort(group, p, **kw)(keys)


def _argsort_body(keys, *, plan, group, capacity: int, batch: int,
                  taper_wire: bool, local: PassBackend):
    """Pairs run with the *global* arrival index as the payload: every
    pass is exact placement, so the payload lands at its key's global
    rank — the stable permutation, sharded like the keys."""
    n_local = keys.shape[0]
    idx = dist.get_rank(group) * n_local + torch.arange(
        n_local, dtype=torch.int32, device=keys.device)
    backend = DistributedBackend(group, local, capacity, batch=batch,
                                 taper_wire=taper_wire)
    _, perm = PlanExecutor(backend).run_pairs(keys, idx, plan)
    return perm, _overflow(backend, keys)


def make_distributed_argsort(group, p: int,
                             capacity_factor: Optional[float] = None,
                             batch: int = 1024, taper_wire: bool = True,
                             max_bins_log2: Optional[int] = None,
                             backend: Optional[str] = None):
    """Build a distributed *argsort* over ``group``: ``fn(local_keys) ->
    (local_perm, overflow)`` with ``keys[perm]`` stably sorted (global
    int32 indices, sharded like the keys) — the contract of
    :func:`~repro_torch.core.fractal_sort.fractal_argsort`, the sharding
    and capacity rules of :func:`make_distributed_sort`."""
    return _make_distributed(_argsort_body, group, p, capacity_factor, batch,
                             taper_wire, max_bins_log2, backend=backend)


def distributed_fractal_argsort(keys, group, p: int, **kw):
    """One-shot convenience wrapper around :func:`make_distributed_argsort`."""
    return make_distributed_argsort(group, p, **kw)(keys)


def _pairs_body(keys, *payloads, plan, group, capacity: int, batch: int,
                taper_wire: bool, local: PassBackend):
    """Executor pairs run: keys *and* every payload column ride the same
    buckets through every pass, so the outputs are the keys at their
    exact global ranks with each payload next to its key."""
    backend = DistributedBackend(group, local, capacity, batch=batch,
                                 taper_wire=taper_wire)
    out_keys, out_payloads = PlanExecutor(backend).run_pairs(
        keys, tuple(payloads), plan)
    return (_like_keys(out_keys, keys), *out_payloads,
            _overflow(backend, keys))


def make_distributed_sort_pairs(group, p: int, num_payloads: int = 1,
                                capacity_factor: Optional[float] = None,
                                batch: int = 1024, taper_wire: bool = True,
                                max_bins_log2: Optional[int] = None,
                                backend: Optional[str] = None,
                                check_shards: bool = True):
    """Build a distributed key–value sort over ``group``: ``fn(local_keys,
    *local_payloads) -> (sorted_keys, *payloads_in_sorted_key_order,
    overflow)``, each payload column (any dtype) routed through one more
    ``all_to_all_single`` a pass beside the keys.  Same sharding and
    capacity rules as :func:`make_distributed_sort`; stability is (rank,
    arrival) order, so an int32 arrival-index payload comes back as the
    stable permutation.  ``check_shards=False`` skips the collective that
    checks the shards are equal, for a caller that made them equal
    itself."""
    return _make_distributed(_pairs_body, group, p, capacity_factor, batch,
                             taper_wire, max_bins_log2,
                             num_payloads=num_payloads, backend=backend,
                             check_shards=check_shards)


def make_fragment_placer(group, num_words: int, batch: int = 1024,
                         backend: Optional[str] = None,
                         check_shards: bool = True):
    """Build the chunk → rank fragment-placement collective of the
    distributed external sort.

    Returns ``fn(words (t, num_words) int32/uint32, dest (t,) int32, tag
    (t,) int32) -> (landed_words (D*t, num_words), landed_tags (D*t,))``,
    called collectively with each rank's equal slice of a chunk: every row
    travels to rank ``dest[i]`` in one bucketed ``all_to_all_single`` for
    the words and one for the tags.  Rows with ``dest < 0`` (pruned
    partitions) are dropped on the wire.  A rank's landing buffer holds
    one bucket from every source rank; slots with ``tag < 0`` are empty,
    and valid rows arrive in (source rank, arrival) order, the chunk's
    arrival order.  Bucket capacity is the full local slice, so placement
    never overflows.  The local rank over the D + 1 destinations (the
    last: dropped) is the local backend's (K2 on the card).
    ``check_shards`` as for :func:`make_distributed_sort_pairs`."""
    device = group_device(group)
    D = dist.get_world_size(group)
    local = make_backend(backend, device, batch=batch)

    def fn(words, dest, tag):
        if words.dim() != 2 or words.shape[1] != num_words:
            raise ValueError(f"words must be (t, {num_words}), got "
                             f"{tuple(words.shape)}")
        _check_tensors(device, words, dest, tag)
        n_local = int(dest.shape[0])
        if check_shards:
            _equal_shards(n_local, group, device)
        # dest < 0 -> bucket D, past the send buffer: dropped
        safe = torch.where(dest >= 0, dest, D).to(torch.int32)
        pos, _, _ = local.rank(
            safe, D + 1, batch_hint=batch,
            bin_start=torch.zeros((D + 1,), dtype=torch.int32, device=device),
            engine="onehot")
        at = torch.clamp(safe.to(torch.int64) * n_local + pos,
                         max=D * n_local)
        rows = D * n_local
        return (_route(words, at, rows, 0, group),
                _route(tag, at, rows, -1, group))

    return fn
