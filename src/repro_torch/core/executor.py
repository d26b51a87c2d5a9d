"""PlanExecutor: the one pass loop every FractalSort entry point runs.

Port of ``repro.core.executor``.  The executor owns the pass loop and
delegates the per-pass primitives to a pluggable :class:`PassBackend`:

* :class:`TorchBackend` — torch-op primitives (the reference's
  ``JnpBackend``): the chunk-parallel one-hot, sorted-tile scatter and
  serial rank engines of :mod:`repro_torch.core.fractal_sort`, on any
  device;
* :class:`CudaBackend` — the hand-written Hopper kernels (histogram K1,
  one-hot rank K2, scatter rank K3, reconstruct K4) from
  :mod:`repro_torch.kernels` (the reference's ``PallasBackend``).  On CPU
  tensors the kernel wrappers compute their plain versions;
* :class:`DistributedBackend` — one collective pass per plan digit over a
  ``torch.distributed`` group, each rank ranking its shard on a local
  backend (:mod:`repro_torch.core.distributed`).

Executor responsibilities (backend-independent): digit extraction, pass
sequencing (stable LSD digit passes, then the fractal MSD pass), payload
carry (full keys through LSD passes, the argsort permutation, or only the
trailing-bit entries into the MSD scatter), the final Algorithm-5
reconstruct, and the empty-input guard.

Keys travel as int32 storage of their uint32 bits.  A digit is
``(u >> shift) & (n_bins - 1)`` on int32: the arithmetic shift fills sign
bits above bit ``31 - shift``, which the mask drops.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fractal_tree import (as_u32_bits, exclusive_cumsum,
                                          u32_to_int64)
from repro_torch.core.sort_plan import DigitPass, SortPlan
from repro_torch.obs import trace

__all__ = [
    "PassBackend",
    "TorchBackend",
    "CudaBackend",
    "DistributedBackend",
    "PlanExecutor",
]


_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _signed(t: torch.Tensor) -> torch.Tensor:
    """``t``, or for uint16/32/64 its bits as the signed type of the same
    width: torch has no index_put for them, and the collectives no wire
    type."""
    signed = _SIGNED_VIEW.get(t.dtype)
    return t if signed is None else t.view(signed)


# Cells of a segment table one histogram call counts: K1's widest
# histogram, so a wider table takes one K1 launch per slice.
_TABLE_SLICE = 1 << 16


def _digit_of(u: torch.Tensor, dp: DigitPass) -> torch.Tensor:
    """The ``dp.bits``-wide digit of each key (int32 storage of uint32
    bits) at ``dp.shift``."""
    return (u >> dp.shift) & (dp.n_bins - 1)


def _as_key_stream(keys: torch.Tensor, encode) -> torch.Tensor:
    """The key stream a run ranks on: ``keys`` directly, or the
    order-preserving transform ``encode(keys)`` of a raw input column, as
    int32 storage of uint32 bits."""
    return as_u32_bits(keys if encode is None else encode(keys))


def _like_keys(out: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Sorted key bits in the input's dtype (the reference's
    ``.astype(keys.dtype)``)."""
    if out.dtype == keys.dtype:
        return out
    if keys.dtype == torch.uint32:
        return as_u32_bits(out).view(torch.uint32)
    if keys.dtype == torch.int64:
        return u32_to_int64(out)
    return as_u32_bits(out).to(keys.dtype)


class PassBackend:
    """Per-pass primitives a :class:`PlanExecutor` composes into a sort:
    stable digit ranking, histogram, scatter and Algorithm-5
    reconstruction."""

    #: base chunk length the per-pass ``rank_batch`` hints derive from
    rank_base: int = 1024

    #: whether the MSD pass rebuilds its prefix bits from bin positions
    #: (Algorithm 5); a backend that places every digit exactly runs the
    #: MSD digit as one more LSD pass instead
    reconstructs: bool = True

    def begin_run(self) -> None:
        """Called by the executor at the start of every run."""

    def rank(self, digit: torch.Tensor, n_bins: int, *,
             batch_hint: Optional[int] = None,
             carry_in: Optional[torch.Tensor] = None,
             bin_start: Optional[torch.Tensor] = None,
             engine: Optional[str] = None,
             counts: Optional[torch.Tensor] = None):
        """Stable output slot per key for one digit stream.  Returns
        ``(rank, counts, carry_out)``; ``engine`` is the pass's hint;
        ``counts`` are the digit's counts when :meth:`plan_counts` gave
        them."""
        raise NotImplementedError

    def plan_counts(self, u: torch.Tensor, plan: SortPlan):
        """Every pass's digit counts of the key stream ``u``, plan order,
        taken once before the pass loop (a digit's histogram does not
        change when the keys are permuted), or None: then each pass's
        :meth:`rank` counts its own digit.  None by default."""
        return None

    def histogram(self, digit: torch.Tensor, n_bins: int,
                  init: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Bin counts of one digit stream added onto ``init``; values
        outside ``[0, n_bins)`` (e.g. the ``n_bins`` padding sentinel)
        contribute nothing."""
        out = (torch.zeros((n_bins,), dtype=torch.int32, device=digit.device)
               if init is None else init.clone())
        valid = digit[(digit >= 0) & (digit < n_bins)].long()
        out.index_add_(0, valid, torch.ones_like(valid, dtype=torch.int32))
        return out

    def scatter(self, rank: torch.Tensor, *arrays: torch.Tensor):
        """Place each array's elements at their ranks (payload carry)."""
        idx = rank.long()
        outs = []
        for a in arrays:
            src = _signed(a)
            out = torch.zeros_like(src)
            out[idx] = src
            outs.append(out.view(a.dtype))
        return tuple(outs)

    def lsd_pass_pairs(self, u: torch.Tensor, payloads: tuple,
                       dp: DigitPass,
                       counts: Optional[torch.Tensor] = None) -> tuple:
        """One stable counting pass moving the keys and every payload to
        the digit's rank order (``counts``: the digit's counts from
        :meth:`plan_counts`, if any).  Returns ``(u, *payloads)``."""
        rank, _, _ = self.rank(_digit_of(u, dp), dp.n_bins,
                               batch_hint=dp.rank_batch(self.rank_base),
                               engine=dp.engine, counts=counts)
        return self.scatter(rank, u, *payloads)

    def reconstruct(self, counts: torch.Tensor, trailing: torch.Tensor,
                    plan: SortPlan) -> torch.Tensor:
        """Algorithm 5: sorted keys from bin counts + permuted trailing
        entries; prefix bits recovered from bin position."""
        raise NotImplementedError


class TorchBackend(PassBackend):
    """Torch-op primitives.  Engine selection: an explicit per-pass hint
    wins; without one the analytic cost model
    (:func:`~repro_torch.core.sort_plan.pick_engine`) picks — narrow
    digits run the one-hot engine, wide digits the scatter engine."""

    def __init__(self, batch: int = 1024):
        self.batch = batch
        self.rank_base = batch  # the user batch knob feeds the pass hints

    def rank(self, digit, n_bins, *, batch_hint=None, carry_in=None,
             bin_start=None, engine=None, counts=None):
        # the torch-op engines count as they rank; plan_counts gives none
        from repro_torch.core.fractal_sort import rank_engine
        from repro_torch.core.sort_plan import pick_engine, scatter_tile_len

        if engine is None:
            bits = max(n_bins - 1, 1).bit_length()
            engine = pick_engine(digit.shape[0], bits)
            # a hint computed for the other engine's tile shape must not
            # leak in: re-derive it for the picked engine.
            if engine == "scatter":
                batch_hint = scatter_tile_len(n_bins, self.batch)
        batch = self.batch if batch_hint is None else batch_hint
        return rank_engine(engine)(digit, n_bins, batch=batch,
                                   carry_in=carry_in, bin_start=bin_start)

    def reconstruct(self, counts, trailing, plan):
        from repro_torch.core.fractal_sort import reconstruct

        return reconstruct(counts, trailing, plan.passes[-1].bits, plan.p)


class CudaBackend(PassBackend):
    """Hand-written kernel primitives: K1 histogram (every pass's counts in
    one sweep before the pass loop when the plan fits it), K2/K3 rank (by
    the pass's engine hint; ``None`` → the one-hot kernel K2, and so is a
    "scatter" hint whose K3 count table would pass
    :data:`~repro_torch.kernels.fractal_rank.TABLE_CAP`; K2 takes the
    pass's counts, which its two-level path above 256 bins needs), K4
    reconstruct.  ``block`` is the reference's rank block (the kernels
    tile for themselves).  A streaming ``carry_in`` is folded into the bin
    starts the rank kernel takes (rank = bin start + carry + arrival)."""

    def __init__(self, block: int = 1024):
        self.block = block

    def rank(self, digit, n_bins, *, batch_hint=None, carry_in=None,
             bin_start=None, engine=None, counts=None):
        from repro_torch.kernels.fractal_rank import (fractal_rank_counts,
                                                      scatter_table_fits)

        if engine == "scatter" and not scatter_table_fits(digit.shape[0],
                                                          n_bins):
            # K3's count table would pass its cap at this shape; K2 keeps
            # no count table and gives the same ranks
            engine = "onehot"
        if carry_in is not None:
            if bin_start is None:
                if counts is None:
                    counts = self.histogram(digit, n_bins)
                bin_start = exclusive_cumsum(counts)
            bin_start = bin_start + carry_in
        rank, counts, carry = fractal_rank_counts(
            digit, n_bins, block=self.block, bin_start=bin_start,
            engine=engine, counts=counts)
        return rank, counts, carry if carry_in is None else carry_in + counts

    def plan_counts(self, u, plan):
        """One K1 sweep over the key stream when the plan's bins fit it
        (the 4- and 8-bit plans); wider plans (16b+16b) return None, so
        each pass launches K1 on its own digit."""
        from repro_torch.kernels.fractal_histogram import (
            fractal_histogram_digits, sweep_eligible)

        if not sweep_eligible(plan.passes):
            return None
        return fractal_histogram_digits(u, plan.passes)

    def histogram(self, digit, n_bins, init=None):
        from repro_torch.kernels.fractal_histogram import fractal_histogram

        return fractal_histogram(digit, n_bins, init=init)

    def reconstruct(self, counts, trailing, plan):
        from repro_torch.kernels.fractal_reconstruct import (
            fractal_reconstruct_plan)

        return fractal_reconstruct_plan(counts, trailing, plan)


class DistributedBackend(PassBackend):
    """One collective pass per plan digit over a ``torch.distributed``
    process group; every rank runs the executor on its own shard.

    Every pass is *exact* global placement on its field (the local
    backend's histogram and rank, the group's merged counts for the
    global bin starts and each rank's arrival offset, then bucketed
    ``all_to_all_single`` routing), so there is nothing to reconstruct:
    the MSD digit runs as one more exact pass (``reconstructs = False``).
    ``local`` ranks and counts each shard (:class:`CudaBackend` on the
    card, :class:`TorchBackend` on the CPU).  Bucket-overflow flags (0-dim
    bool tensors, equal on every rank) accumulate across the passes of
    one run; :meth:`begin_run` resets them, so read :attr:`overflow`
    after the run."""

    reconstructs = False

    def __init__(self, group, local: PassBackend, capacity: int,
                 batch: int = 1024, taper_wire: bool = True):
        self.group = group
        self.local = local
        self.capacity = capacity
        self.batch = batch
        self.taper_wire = taper_wire
        self.overflow: Optional[torch.Tensor] = None

    def begin_run(self) -> None:
        self.overflow = None

    def rank(self, digit, n_bins, *, batch_hint=None, carry_in=None,
             bin_start=None, engine=None, counts=None):
        raise NotImplementedError(
            "the distributed pass fuses rank and placement; use "
            "lsd_pass_pairs")

    def lsd_pass_pairs(self, u, payloads, dp, counts=None):
        from repro_torch.core.distributed import _distributed_pass

        out, ov = _distributed_pass(
            u, dp.shift, dp.bits, self.group, self.capacity, self.batch,
            self.taper_wire, payloads=payloads, engine=dp.engine,
            backend=self.local)
        self.overflow = ov if self.overflow is None else self.overflow | ov
        return out


class PlanExecutor:
    """Runs a :class:`SortPlan` against one :class:`PassBackend` — the
    only pass loop of this package."""

    def __init__(self, backend: PassBackend):
        self.backend = backend

    # -- per-pass tracing ---------------------------------------------------

    def _pass_stats(self, u, plan: SortPlan, with_index: bool):
        """Per-pass analytic byte ledger for the pass spans, or None when
        tracing is off.  The spans pair these bytes with measured wall."""
        if not trace.enabled():
            return None
        from repro_torch.core.fractal_sort import fractal_sort_stats

        return fractal_sort_stats(int(u.shape[0]), plan.p,
                                  with_index=with_index, plan=plan).pass_stats

    @staticmethod
    def _pass_span(pass_stats, index: int, dp: DigitPass):
        if pass_stats is None:
            return trace.NULL
        ps = pass_stats[index]
        return trace.span(
            "executor.pass", index=index, kind=ps.kind, shift=dp.shift,
            bits=dp.bits, bytes_read=ps.bytes_read,
            bytes_written=ps.bytes_written)

    @staticmethod
    def _sync(*arrays: torch.Tensor) -> None:
        """Wait for queued device work so a pass span's wall covers it."""
        if any(a.is_cuda for a in arrays):
            torch.cuda.synchronize()

    def _msd_rank(self, u: torch.Tensor, last: DigitPass,
                  counts: Optional[torch.Tensor]):
        return self.backend.rank(
            _digit_of(u, last), last.n_bins,
            batch_hint=last.rank_batch(self.backend.rank_base),
            engine=last.engine, counts=counts)

    def _plan_counts(self, u: torch.Tensor, plan: SortPlan) -> tuple:
        """Each pass's counts from the backend's hook, or Nones."""
        counts = self.backend.plan_counts(u, plan)
        return (None,) * len(plan.passes) if counts is None else counts

    # -- plain sort ---------------------------------------------------------

    def run(self, keys: torch.Tensor, plan: SortPlan,
            encode=None) -> torch.Tensor:
        """Sorted keys, rebuilt by the backend's Algorithm 5.

        ``encode`` (here and on every ``run*`` mode) is an order-preserving
        transform applied to ``keys`` inside the run, so raw columns enter
        and pass 0 extracts digits from the encoded stream.  A backend
        that does not reconstruct returns the key stream of its last exact
        pass."""
        self.backend.begin_run()
        u = _as_key_stream(keys, encode)
        if u.shape[0] == 0 or not plan.passes:
            # empty input, or the p=0 identity plan
            return u if encode is not None else keys
        pass_stats = self._pass_stats(u, plan, with_index=False)
        pass_counts = self._plan_counts(u, plan)
        for i, dp in enumerate(plan.passes[:-1]):
            with self._pass_span(pass_stats, i, dp):
                u, = self.backend.lsd_pass_pairs(u, (), dp, pass_counts[i])
                if pass_stats is not None:
                    self._sync(u)
        last = plan.passes[-1]
        with self._pass_span(pass_stats, len(plan.passes) - 1, last):
            if not self.backend.reconstructs:
                out, = self.backend.lsd_pass_pairs(u, (), last,
                                                   pass_counts[-1])
                if pass_stats is not None:
                    self._sync(out)
                return out
            rank, counts, _ = self._msd_rank(u, last, pass_counts[-1])
            if last.shift:
                # compressed entries: only the trailing bits travel; the
                # prefix is rebuilt from bin positions.
                (trailing,) = self.backend.scatter(
                    rank, u & ((1 << last.shift) - 1))
            else:
                # zero-payload regime: output from bin positions alone.
                trailing = torch.zeros_like(u)
            out = self.backend.reconstruct(counts, trailing, plan)
            if pass_stats is not None:
                self._sync(out)
        return out

    # -- key–value (pairs) sort ---------------------------------------------

    def run_pairs(self, keys: torch.Tensor, values, plan: SortPlan,
                  encode=None):
        """Sort key–payload pairs by key: every LSD pass carries the
        payload with the keys, and the fractal MSD pass scatters it next to
        the trailing-bit entries.  ``values`` is one payload tensor or a
        tuple of them (tuple in, tuple out).  Stable: ties keep arrival
        order."""
        single = not isinstance(values, tuple)
        payloads = (values,) if single else tuple(values)
        self.backend.begin_run()
        u = _as_key_stream(keys, encode)
        if u.shape[0] == 0 or not plan.passes:
            return (u if encode is not None else keys), values
        pass_stats = self._pass_stats(u, plan, with_index=True)
        pass_counts = self._plan_counts(u, plan)
        for i, dp in enumerate(plan.passes[:-1]):
            with self._pass_span(pass_stats, i, dp):
                u, *payloads = self.backend.lsd_pass_pairs(
                    u, tuple(payloads), dp, pass_counts[i])
                if pass_stats is not None:
                    self._sync(u, *payloads)
        last = plan.passes[-1]
        with self._pass_span(pass_stats, len(plan.passes) - 1, last):
            if not self.backend.reconstructs:
                keys_out, *payloads = self.backend.lsd_pass_pairs(
                    u, tuple(payloads), last, pass_counts[-1])
                if pass_stats is not None:
                    self._sync(keys_out, *payloads)
                return keys_out, (payloads[0] if single else tuple(payloads))
            rank, counts, _ = self._msd_rank(u, last, pass_counts[-1])
            if last.shift:
                trailing, *payloads = self.backend.scatter(
                    rank, u & ((1 << last.shift) - 1), *payloads)
            else:
                payloads = self.backend.scatter(rank, *payloads)
                trailing = torch.zeros_like(u)
            keys_out = self.backend.reconstruct(counts, trailing, plan)
            if pass_stats is not None:
                self._sync(keys_out, *payloads)
        return keys_out, (payloads[0] if single else tuple(payloads))

    # -- argsort ------------------------------------------------------------

    def run_argsort(self, keys: torch.Tensor, plan: SortPlan,
                    encode=None) -> torch.Tensor:
        """Stable int32 permutation with ``keys[perm]`` sorted: every pass
        is a payload-carrying LSD pass (the permutation is the payload)."""
        self.backend.begin_run()
        u = _as_key_stream(keys, encode)
        n = u.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=u.device)
        if n == 0 or not plan.passes:
            return idx  # p=0: all keys equal, stable perm is the identity
        pass_stats = self._pass_stats(u, plan, with_index=True)
        pass_counts = self._plan_counts(u, plan)
        for i, dp in enumerate(plan.passes):
            with self._pass_span(pass_stats, i, dp):
                u, idx = self.backend.lsd_pass_pairs(u, (idx,), dp,
                                                     pass_counts[i])
                if pass_stats is not None:
                    self._sync(u, idx)
        return idx

    # -- segment-aware re-ranking (grouped-trailing and batched modes) --------

    def _segment_rank(self, u: torch.Tensor, dp: DigitPass, seg: torch.Tensor,
                      seg_start: torch.Tensor, nseg: int) -> torch.Tensor:
        """Stable rank of ``dp``'s digit *within* each segment (``seg``:
        each slot's segment, ``seg_start``: each slot's segment start).
        The backend ranks with zero bin starts, so its rank is the arrival
        among equal digits in array (= segment-major) order; a
        ``(segments, n_bins)`` digit table converts it to the slot inside
        the segment.  The table is the backend's histogram of the
        (segment, digit) cells, taken :data:`_TABLE_SLICE` cells at a time
        (the histogram drops cells outside the slice); its column sums are
        the digit's counts the rank takes."""
        digit = _digit_of(u, dp)
        cells = nseg * dp.n_bins
        cell = seg * dp.n_bins + digit
        table = torch.cat([
            self.backend.histogram(cell - base if base else cell,
                                   min(_TABLE_SLICE, cells - base))
            for base in range(0, cells, _TABLE_SLICE)]).view(nseg, dp.n_bins)
        arr_g, _, _ = self.backend.rank(
            digit, dp.n_bins, batch_hint=dp.rank_batch(self.backend.rank_base),
            bin_start=torch.zeros((dp.n_bins,), dtype=torch.int32,
                                  device=u.device),
            engine=dp.engine, counts=table.sum(0, dtype=torch.int32))
        before_seg = torch.cumsum(table, 0, dtype=torch.int32) - table
        lower = torch.cumsum(table, 1, dtype=torch.int32) - table
        return (seg_start + lower.view(-1)[cell] + arr_g
                - before_seg.view(-1)[cell])

    def run_segmented_argsort(self, keys: torch.Tensor, plan: SortPlan,
                              seg_len_log2: int,
                              encode=None) -> torch.Tensor:
        """Stable int32 argsort *within* equal-length power-of-two segments.

        ``keys`` is ``B`` independent arrays of length ``2**seg_len_log2``
        laid end to end; the returned permutation sorts each segment in
        place (``perm[b*L:(b+1)*L]`` stays inside ``[b*L, (b+1)*L)``).
        Segment membership is positional (``slot >> seg_len_log2``), so
        ranks never cross segments."""
        u = _as_key_stream(keys, encode)
        n = u.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=u.device)
        if n == 0 or not plan.passes:
            return idx  # empty batch, or p=0: identity within each segment
        seg = idx >> seg_len_log2
        seg_start = seg << seg_len_log2
        for dp in plan.passes:
            rank = self._segment_rank(u, dp, seg, seg_start, n >> seg_len_log2)
            u, idx = self.backend.scatter(rank, u, idx)
        return idx

    def run_grouped_trailing(self, entries: torch.Tensor,
                             counts: torch.Tensor,
                             plan: SortPlan) -> torch.Tensor:
        """Finish a sort whose array is already grouped by the MSD prefix.

        ``entries`` holds, per slot, the ``plan.trailing_bits`` trailing
        bits of a key whose prefix is implied by its segment (the slot's
        bin, from ``counts``); each trailing LSD pass re-ranks *within*
        segments, so the MSD pass never re-runs.  Returns the
        reconstructed sorted keys."""
        n = entries.shape[0]
        last = plan.passes[-1]
        if n == 0 or last.shift == 0:
            return self.backend.reconstruct(counts, torch.zeros_like(
                as_u32_bits(entries)), plan)
        counts = counts.to(torch.int32)
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        # slot -> segment; ranks never cross segments, so this map holds
        # across every trailing pass (computed once)
        seg = torch.searchsorted(
            ends, torch.arange(n, dtype=torch.int32, device=entries.device),
            right=True).to(torch.int32)
        seg_start = (ends - counts)[seg.long()]
        u = as_u32_bits(entries)
        for dp in plan.passes[:-1]:
            rank = self._segment_rank(u, dp, seg, seg_start, last.n_bins)
            (u,) = self.backend.scatter(rank, u)
        return self.backend.reconstruct(counts, u, plan)

    # -- streaming (batched) mode -------------------------------------------

    def run_streaming(self, keys: torch.Tensor, plan: SortPlan,
                      num_batches: int):
        """Streaming sort (paper §III.C/D): the input arrives in
        ``num_batches`` slices; the trie histogram is built per slice and
        merged, ranks stream through the shared carry, and one scatter
        groups entries by the plan's MSD prefix.  The trailing bits then
        sort segment-aware (:meth:`run_grouped_trailing`) when the plan
        supports it, else through a full :meth:`run`.  Returns
        ``(sorted_keys, per-slice histograms)``."""
        from repro_torch.core import fractal_tree as ft

        if not plan.passes:
            return keys, []  # the p=0 identity plan: nothing to histogram
        n = keys.shape[0]
        depth, t = plan.depth, plan.trailing_bits
        last = plan.passes[-1]
        slices = torch.tensor_split(keys, num_batches)
        hists = [ft.build_histogram(s, plan.p, depth) for s in slices]
        merged = hists[0]
        for h in hists[1:]:
            merged = ft.merge_histograms(merged, h)
        counts = merged.leaf_counts
        bin_start = ft.exclusive_cumsum(counts)
        carry = torch.zeros((1 << depth,), dtype=torch.int32,
                            device=keys.device)
        grouped = t == 0 or plan.supports_grouped_trailing
        out = torch.zeros((n,), dtype=torch.int32, device=keys.device)
        for s in slices:
            su = as_u32_bits(s)
            prefix = (su >> t) & ((1 << depth) - 1)
            rank, _, carry = self.backend.rank(
                prefix, 1 << depth, carry_in=carry, bin_start=bin_start,
                engine=last.engine)
            # grouped mode scatters only the trailing entries (the prefix
            # is implied by the destination segment); the fallback carries
            # full keys for its plan re-run
            out[rank.long()] = su & ((1 << t) - 1) if grouped else su
        if grouped:  # covers t == 0: reconstruct from counts alone
            sorted_u = self.run_grouped_trailing(out, counts, plan)
        else:
            sorted_u = self.run(out, plan)
        return _like_keys(sorted_u, keys), hists

    # -- per-chunk histogram accumulation (streaming consumers) --------------

    def digit_counts(self, keys: torch.Tensor, dp: DigitPass,
                     init: Optional[torch.Tensor] = None,
                     pad_to: Optional[int] = None) -> torch.Tensor:
        """One chunk's histogram of ``dp``'s digit, accumulated onto
        ``init``.  ``pad_to`` pads the digit stream with the out-of-range
        sentinel ``dp.n_bins``, which every backend's histogram drops."""
        digit = _digit_of(as_u32_bits(keys), dp)
        if pad_to is not None and pad_to > digit.shape[0]:
            digit = torch.cat([digit, torch.full(
                (pad_to - digit.shape[0],), dp.n_bins, dtype=torch.int32,
                device=digit.device)])
        return self.backend.histogram(digit, dp.n_bins, init=init)
