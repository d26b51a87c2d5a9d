"""FractalSort: histogram → rank → reconstruct (paper Algorithms 1–5).

Port of ``repro.core.fractal_sort``.  A ``p``-bit sort executes a
:class:`~repro_torch.core.sort_plan.SortPlan`: stable LSD digit passes
over the trailing bits, then one MSD *fractal* pass over the
``depth``-bit prefix whose bits are rebuilt from bin positions
(Algorithm 5) instead of being moved.

This module holds

* the analytic DRAM-traffic model :func:`fractal_sort_stats` (the
  reference's arithmetic, unchanged);
* the torch-op rank engines — :func:`fractal_rank` (chunk-parallel
  one-hot), :func:`fractal_rank_scatter` (sorted-tile scatter) and
  :func:`fractal_rank_serial` (the scan-over-chunks oracle) — all with
  the ``(rank, counts, carry_out)`` streaming contract and
  ``carry_in``/``bin_start`` injection;
* :func:`reconstruct` (Algorithm 5 with torch ops);
* the public sorts :func:`fractal_sort`, :func:`fractal_sort_pairs`,
  :func:`fractal_argsort` and the streaming :func:`fractal_sort_batched`.
  Each resolves a plan (with all defaults, the autotune cache's winner
  for the pass backend, else the static plan) and hands it to a
  :class:`~repro_torch.core.executor.PlanExecutor` over
  :class:`~repro_torch.core.executor.CudaBackend` (the hand-written
  kernels) on a CUDA device or
  :class:`~repro_torch.core.executor.TorchBackend` (torch ops) on the
  CPU; ``backend="torch"``/``"cuda"`` picks one explicitly.

Entry points run on the card: ``device=None`` means ``"cuda"`` and
raises when CUDA is unavailable.  Pass ``device="cpu"`` to run on the
CPU.  Keys travel as int32 storage of their uint32 bits; a p = 32 result
is a ``torch.uint32`` view, a p <= 31 result int32 (the reference's
``keys_dtype``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import fractal_tree as ft
from repro_torch.core.autotune import tuned_plan
from repro_torch.core.executor import CudaBackend, PlanExecutor, TorchBackend
from repro_torch.core.sort_plan import SortPlan, make_sort_plan, rank_chunk_len

__all__ = [
    "PassStats",
    "SortStats",
    "backend_name",
    "fractal_rank",
    "fractal_rank_scatter",
    "fractal_rank_serial",
    "fractal_sort",
    "fractal_argsort",
    "fractal_sort_batched",
    "fractal_sort_pairs",
    "fractal_sort_stats",
    "keys_dtype",
    "make_backend",
    "rank_engine",
    "reconstruct",
    "to_device",
]


@dataclasses.dataclass(frozen=True)
class PassStats:
    """Analytic DRAM traffic of one plan pass (bytes)."""

    shift: int
    bits: int
    kind: str
    bytes_read: int
    bytes_written: int

    @property
    def n_bins(self) -> int:
        return 1 << self.bits


@dataclasses.dataclass(frozen=True)
class SortStats:
    """Analytic DRAM-traffic model for one sort call (bytes)."""

    n: int
    p: int
    l_n: int
    passes: int
    bytes_read: int
    bytes_written: int
    histogram_bytes: int  # tapered trie footprint (on-chip resident)
    pass_stats: tuple = ()  # tuple[PassStats], LSD -> MSD

    @property
    def bytes_total(self) -> int:
        return self.bytes_read + self.bytes_written

    @property
    def bytes_per_key(self) -> float:
        return self.bytes_total / max(self.n, 1)


def _key_bytes(p: int) -> int:
    return 4 if p > 16 else 2


def fractal_sort_stats(n: int, p: int, l_n: Optional[int] = None,
                       with_index: bool = False,
                       plan: Optional[SortPlan] = None) -> SortStats:
    """Analytic traffic of a plan execution (the b_eff model).

    Per LSD pass: one streaming read of the keys and one full-key scatter
    write.  The MSD pass reads the keys once, writes trailing-bit entry
    payloads (whole bytes; none when the trie covers the field) and the
    output rebuilt from bin positions.  The tapered trie is counted once
    in ``histogram_bytes``.  ``plan`` defaults to the paper's 16-bit-field
    plan; ``with_index`` adds the payload index of pairs/argsort.
    """
    if plan is None:
        plan = make_sort_plan(n, p, l_n=l_n, max_bins_log2=16)
    kb = _key_bytes(p)
    if with_index:
        idx_bytes = 2 if (plan.depth >= ft.ceil_log2(n) - 16) else 4
    else:
        idx_bytes = 0
    per_pass = []
    for dpass in plan.passes:
        rd = n * kb + n * idx_bytes
        if dpass.kind == "msd":
            trailing_bytes = (dpass.shift + 7) // 8 if dpass.shift else 0
            wr = n * trailing_bytes + n * kb + n * idx_bytes
        else:
            wr = n * kb + n * idx_bytes
        per_pass.append(PassStats(shift=dpass.shift, bits=dpass.bits,
                                  kind=dpass.kind,
                                  bytes_read=rd, bytes_written=wr))
    h_bytes = sum(
        (1 << l) * ft.tapered_dtype(l, ft.ceil_log2(n)).itemsize
        for l in range(plan.depth + 1)
    )
    return SortStats(
        n=n, p=p, l_n=plan.depth, passes=len(per_pass),
        bytes_read=sum(ps.bytes_read for ps in per_pass),
        bytes_written=sum(ps.bytes_written for ps in per_pass),
        histogram_bytes=int(h_bytes),
        pass_stats=tuple(per_pass),
    )


# ---------------------------------------------------------------------------
# Rank engines (torch ops): stable ranks with a streaming per-bin carry
# ---------------------------------------------------------------------------


def _zeros(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.int32, device=like.device)


def _rank_chunks(prefix: torch.Tensor, n: int, n_bins: int,
                 batch: int) -> torch.Tensor:
    """Pad with the sentinel bin ``n_bins`` (matches no column, counted
    nowhere) to whole chunks of the per-pass chunk length, and reshape."""
    batch = min(rank_chunk_len(n_bins, batch), max(n, 1))
    pad = (-n) % batch
    if pad:
        prefix = torch.cat([prefix, torch.full((pad,), n_bins,
                                               dtype=torch.int32,
                                               device=prefix.device)])
    return prefix.reshape(-1, batch)


def _rank_finish(prefix, ranks, counts, carry_in, bin_start, n_bins):
    """Shared tail: derive bin starts, add them, emit the carry triple."""
    carry_out = carry_in + counts
    if bin_start is None:
        bin_start = ft.exclusive_cumsum(counts)
    rank = bin_start[prefix.clamp(0, n_bins - 1).long()] + ranks
    return rank.to(torch.int32), counts, carry_out


def _prepare(prefix, n_bins, carry_in):
    prefix = prefix.to(torch.int32)
    if carry_in is None:
        carry_in = _zeros(n_bins, prefix)
    return prefix, carry_in


def _rank_empty(prefix, n_bins, carry_in):
    return _zeros(0, prefix), _zeros(n_bins, prefix), carry_in


# Per-group cap on the materialized (chunks x chunk x n_bins) one-hot
# footprint of the chunk-parallel rank, in int32 elements (the
# reference's value).
_RANK_GROUP_ELEMS = 1 << 19


def fractal_rank(prefix: torch.Tensor, n_bins: int, batch: int = 1024,
                 carry_in: Optional[torch.Tensor] = None,
                 bin_start: Optional[torch.Tensor] = None):
    """Stable output position for each key given its bin id ``prefix``:
    ``rank[i] = bin_start[k] + carry[k] + arrivals of k before i``, by the
    two-phase chunk-parallel one-hot engine.  Within a group of chunks
    every chunk's histogram and intra-chunk arrivals come from one one-hot
    cumulative sum, and every chunk's carry from one exclusive scan over
    the (chunks, n_bins) histogram matrix; only the ``(n_bins,)`` carry
    crosses groups.  Returns ``(rank, counts, carry_out)``."""
    n = prefix.shape[0]
    prefix, carry_in = _prepare(prefix, n_bins, carry_in)
    if n == 0:
        return _rank_empty(prefix, n_bins, carry_in)
    chunks = _rank_chunks(prefix, n, n_bins, batch)
    num_chunks, chunk_len = chunks.shape
    group = min(num_chunks,
                max(1, _RANK_GROUP_ELEMS // (chunk_len * n_bins)))
    gpad = (-num_chunks) % group
    if gpad:  # sentinel chunks: contribute nothing, ranks sliced off
        chunks = torch.cat([chunks, torch.full(
            (gpad, chunk_len), n_bins, dtype=torch.int32,
            device=prefix.device)])
    bins = torch.arange(n_bins, dtype=torch.int32, device=prefix.device)
    carry = carry_in
    ranks = []
    for gchunks in chunks.reshape(-1, group, chunk_len):
        onehot = (gchunks[..., None] == bins).to(torch.int32)
        cum = torch.cumsum(onehot, 1, dtype=torch.int32)
        safe = gchunks.clamp(0, n_bins - 1).long()
        intra = torch.gather(cum - onehot, 2, safe[..., None])[..., 0]
        hists = cum[:, -1, :]
        chunk_carry = (carry[None, :] + torch.cumsum(hists, 0, dtype=torch.int32)
                       - hists)
        ranks.append(torch.gather(chunk_carry, 1, safe) + intra)
        carry = carry + hists.sum(0, dtype=torch.int32)
    ranks = torch.cat(ranks).reshape(-1)[:n]
    return _rank_finish(prefix, ranks, carry - carry_in, carry_in,
                        bin_start, n_bins)


def fractal_rank_serial(prefix: torch.Tensor, n_bins: int, batch: int = 1024,
                        carry_in: Optional[torch.Tensor] = None,
                        bin_start: Optional[torch.Tensor] = None):
    """Serial-scan rank engine: a loop over chunks threading the running
    per-bin histogram.  Same contract as :func:`fractal_rank`; kept as
    the oracle of the parallel engines."""
    n = prefix.shape[0]
    prefix, carry_in = _prepare(prefix, n_bins, carry_in)
    if n == 0:
        return _rank_empty(prefix, n_bins, carry_in)
    bins = torch.arange(n_bins, dtype=torch.int32, device=prefix.device)
    carry = carry_in
    ranks = []
    for chunk in _rank_chunks(prefix, n, n_bins, batch):
        onehot = (chunk[:, None] == bins).to(torch.int32)
        running = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
        safe = chunk.clamp(0, n_bins - 1).long()
        intra = torch.gather(running, 1, safe[:, None])[:, 0]
        ranks.append(carry[safe] + intra)
        carry = carry + onehot.sum(0, dtype=torch.int32)
    ranks = torch.cat(ranks)[:n]
    return _rank_finish(prefix, ranks, carry - carry_in, carry_in,
                        bin_start, n_bins)


def fractal_rank_scatter(prefix: torch.Tensor, n_bins: int, batch: int = 1024,
                         carry_in: Optional[torch.Tensor] = None,
                         bin_start: Optional[torch.Tensor] = None):
    """Sorted-tile rank engine: O(n log tile) per pass, independent of the
    digit width.  Each power-of-two tile packs ``digit << log2(tile) |
    position`` into one word and sorts it (stable by construction); the
    per-tile digit table comes from boundary probes of the sorted
    composites (narrow digits) or one scatter-add (wide digits); the
    cross-tile carry is one exclusive scan over the (tiles, n_bins) table;
    one scatter returns ranks to arrival order.  Same contract as
    :func:`fractal_rank`."""
    n = prefix.shape[0]
    prefix, carry_in = _prepare(prefix, n_bins, carry_in)
    if n == 0:
        return _rank_empty(prefix, n_bins, carry_in)
    dev = prefix.device
    bits = max(n_bins - 1, 1).bit_length()
    tlog = max(3, batch.bit_length() - 1)       # floor pow2 of the hint
    tlog = min(tlog, ft.ceil_log2(max(n, 8)),   # no tile wider than the data
               31 - bits)                       # composite packing headroom
    tile = 1 << tlog
    num_tiles = (n + tile - 1) // tile
    pad = num_tiles * tile - n
    if pad:  # pad digit n_bins: sorts to the tile tail, dropped from counts
        prefix = torch.cat([prefix, torch.full((pad,), n_bins,
                                               dtype=torch.int32, device=dev)])
    tiles = prefix.reshape(num_tiles, tile).to(torch.int64)
    pos = torch.arange(tile, dtype=torch.int64, device=dev)
    sc = torch.sort((tiles << tlog) | pos[None, :], dim=1).values
    ds = sc >> tlog                               # digits, sorted order
    orig = sc & (tile - 1)
    if num_tiles * (n_bins + 1) <= 2 * n:
        probes = torch.arange(n_bins + 1, dtype=torch.int64, device=dev) << tlog
        bounds = torch.searchsorted(
            sc, probes.expand(num_tiles, -1).contiguous()).to(torch.int32)
        lower, table = bounds[:, :-1], torch.diff(bounds, dim=1)
    else:
        flat = prefix.to(torch.int64)
        valid = (flat >= 0) & (flat < n_bins)
        tile_id = torch.arange(num_tiles * tile, device=dev) // tile
        table = torch.zeros((num_tiles * n_bins,), dtype=torch.int32,
                            device=dev)
        sel = (tile_id * n_bins + flat)[valid]
        table.index_add_(0, sel, torch.ones_like(sel, dtype=torch.int32))
        table = table.reshape(num_tiles, n_bins)
        lower = torch.cumsum(table, 1, dtype=torch.int32) - table
    counts = table.sum(0, dtype=torch.int32)
    tile_carry = (carry_in[None, :] + torch.cumsum(table, 0, dtype=torch.int32)
                  - table)
    safe = ds.clamp(0, n_bins - 1)
    if bin_start is None:
        bin_start = ft.exclusive_cumsum(counts)
    rank_sorted = (bin_start[safe]
                   + torch.gather(tile_carry, 1, safe)
                   + pos.to(torch.int32)[None, :]
                   - torch.gather(lower, 1, safe))
    rank = torch.zeros((num_tiles, tile), dtype=torch.int32, device=dev)
    rank.scatter_(1, orig, rank_sorted.to(torch.int32))
    return rank.reshape(-1)[:n], counts, carry_in + counts


#: The rank engines (one contract, three arithmetics): "onehot" is the
#: chunk-parallel one-hot tile, "scatter" the sorted-tile engine, "serial"
#: the scan-over-chunks oracle.
RANK_ENGINES = {
    "onehot": fractal_rank,
    "scatter": fractal_rank_scatter,
    "serial": fractal_rank_serial,
}


def rank_engine(name: Optional[str]):
    """Resolve an engine hint to its rank function (None = "onehot")."""
    fn = RANK_ENGINES.get(name or "onehot")
    if fn is None:
        raise ValueError(f"unknown rank engine {name!r}: one of "
                         f"{sorted(RANK_ENGINES)}")
    return fn


# ---------------------------------------------------------------------------
# Reconstruction (Algorithm 5)
# ---------------------------------------------------------------------------


def keys_dtype(p: int) -> torch.dtype:
    """The dtype a p-bit sort returns: int32 up to 31 bits, else uint32."""
    return torch.int32 if p <= 31 else torch.uint32


def _as_keys_dtype(bits: torch.Tensor, p: int) -> torch.Tensor:
    """int32 storage of uint32 bits, viewed as :func:`keys_dtype`."""
    return bits.view(torch.uint32) if p == 32 else bits


def reconstruct(counts: torch.Tensor, trailing: torch.Tensor, l_n: int, p: int,
                lsb_tree_order: bool = False) -> torch.Tensor:
    """Algorithm 5 (FractalSortCPUA) with torch ops: each output key is
    ``bin << t | trailing`` where the bin comes from the output position
    against the counts' CDF.  ``lsb_tree_order=True`` reads bins in the
    paper's LSB-first tree-walk order and un-reverses them."""
    n = trailing.shape[0]
    ends = torch.cumsum(counts.to(torch.int64), 0)
    slots = torch.arange(n, dtype=torch.int64, device=trailing.device)
    slot_bin = torch.searchsorted(ends, slots, right=True)
    if lsb_tree_order:
        slot_bin = ft.bit_reverse(slot_bin, l_n).to(torch.int64)
    out = ft.wrap_int32((slot_bin << (p - l_n)) | ft.u32_to_int64(trailing))
    return _as_keys_dtype(out, p)


# ---------------------------------------------------------------------------
# Public sorts — resolve a SortPlan, hand it to a PlanExecutor
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"`` and
    raises when CUDA is unavailable (entry points never fall back to the
    CPU on their own)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return device


def to_device(keys, device) -> torch.Tensor:
    """``keys`` as a tensor on ``device`` (see :func:`resolve_device`)."""
    return torch.as_tensor(keys).to(resolve_device(device))


def backend_name(backend: Optional[str], device: torch.device) -> str:
    """``None`` → ``"cuda"`` on a CUDA device, ``"torch"`` on the CPU;
    ``"cuda"`` / ``"torch"`` pick explicitly."""
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}: 'torch' or 'cuda'")
    return backend


def make_backend(backend: Optional[str], device: torch.device, batch: int = 1024):
    """:class:`CudaBackend` or :class:`TorchBackend`, as
    :func:`backend_name` resolves ``backend`` on ``device``."""
    if backend_name(backend, device) == "torch":
        return TorchBackend(batch=batch)
    return CudaBackend()


def _resolve_plan(n: int, p: int, l_n: Optional[int],
                  max_bins_log2: Optional[int], plan: Optional[SortPlan],
                  backend: str) -> SortPlan:
    """Plan resolution shared by every entry point: an explicit ``plan``
    wins; explicit ``l_n``/``max_bins_log2`` build the static plan;
    all-defaults consults the autotune cache for ``backend``, the pass
    backend that runs the plan (:func:`~repro_torch.core.autotune.
    tuned_plan`: never measures, and the static plan until a sweep has
    recorded a winner)."""
    if plan is not None:
        if plan.p != p:
            raise ValueError(f"plan is for p={plan.p}, sort asked p={p}")
        return plan
    if l_n is None and max_bins_log2 is None:
        return tuned_plan(n, p, backend=backend)
    return make_sort_plan(n, p, l_n=l_n, max_bins_log2=max_bins_log2)


def fractal_sort(keys, p: int, l_n: Optional[int] = None, batch: int = 1024,
                 max_bins_log2: Optional[int] = None,
                 plan: Optional[SortPlan] = None, *, device=None,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Sort integer keys in [0, 2**p) by executing a :class:`SortPlan`:
    bounded-width stable LSD digit passes plus one fractal MSD pass.
    ``max_bins_log2`` caps per-pass bins; ``plan`` pins an exact plan."""
    keys = to_device(keys, device)
    plan = _resolve_plan(keys.shape[0], p, l_n, max_bins_log2, plan,
                         backend_name(backend, keys.device))
    out = PlanExecutor(make_backend(backend, keys.device, batch)).run(keys, plan)
    return out if out is keys else _as_keys_dtype(out, p)


def fractal_sort_pairs(keys, values, p: int, l_n: Optional[int] = None,
                       batch: int = 1024, max_bins_log2: Optional[int] = None,
                       plan: Optional[SortPlan] = None, *, device=None,
                       backend: Optional[str] = None):
    """Key–value sort: ``(sorted_keys, values_in_sorted_key_order)`` for
    keys in [0, 2**p) and one payload column of equal length.  The payload
    rides every pass, including the fractal MSD pass whose key prefix is
    rebuilt from bin positions.  Stable: equal keys keep arrival order."""
    keys = to_device(keys, device)
    values = torch.as_tensor(values).to(keys.device)
    plan = _resolve_plan(keys.shape[0], p, l_n, max_bins_log2, plan,
                         backend_name(backend, keys.device))
    out, vals = PlanExecutor(make_backend(backend, keys.device, batch)
                             ).run_pairs(keys, values, plan)
    return (out if out is keys else _as_keys_dtype(out, p)), vals


def fractal_argsort(keys, p: int, batch: int = 1024,
                    max_bins_log2: Optional[int] = None,
                    plan: Optional[SortPlan] = None, *, device=None,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Stable int32 permutation ``perm`` with ``keys[perm]`` sorted: every
    plan pass is a payload-carrying LSD pass (the permutation is the
    payload)."""
    if p > 32:
        raise ValueError("argsort covers p <= 32 via the digit plan")
    keys = to_device(keys, device)
    plan = _resolve_plan(keys.shape[0], p, None, max_bins_log2, plan,
                         backend_name(backend, keys.device))
    return PlanExecutor(make_backend(backend, keys.device, batch)
                        ).run_argsort(keys, plan)


def fractal_sort_batched(keys, p: int, num_batches: int,
                         l_n: Optional[int] = None, batch: int = 1024,
                         max_bins_log2: Optional[int] = None,
                         plan: Optional[SortPlan] = None, *, device=None,
                         backend: Optional[str] = None):
    """Streaming variant (paper §III.C/D): the input arrives in
    ``num_batches`` slices whose trie histograms are built and merged;
    ranks stream through the shared per-bin carry, one scatter groups the
    entries by the plan's MSD prefix, and the executor's segment-aware
    grouped-trailing passes order the trailing bits in place.  Returns
    ``(sorted_keys, per-slice histograms)``."""
    keys = to_device(keys, device)
    plan = _resolve_plan(keys.shape[0], p, l_n, max_bins_log2, plan,
                         backend_name(backend, keys.device))
    return PlanExecutor(make_backend(backend, keys.device, batch)
                        ).run_streaming(keys, plan, num_batches)
