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
  tensors the kernel wrappers compute their plain versions.

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

from repro_torch.core.fractal_tree import as_u32_bits
from repro_torch.core.sort_plan import DigitPass, SortPlan
from repro_torch.obs import trace

__all__ = [
    "PassBackend",
    "TorchBackend",
    "CudaBackend",
    "PlanExecutor",
]


_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _digit_of(u: torch.Tensor, dp: DigitPass) -> torch.Tensor:
    """The ``dp.bits``-wide digit of each key (int32 storage of uint32
    bits) at ``dp.shift``."""
    return (u >> dp.shift) & (dp.n_bins - 1)


def _as_key_stream(keys: torch.Tensor, encode) -> torch.Tensor:
    """The key stream a run ranks on: ``keys`` directly, or the
    order-preserving transform ``encode(keys)`` of a raw input column, as
    int32 storage of uint32 bits."""
    return as_u32_bits(keys if encode is None else encode(keys))


class PassBackend:
    """Per-pass primitives a :class:`PlanExecutor` composes into a sort:
    stable digit ranking, histogram, scatter and Algorithm-5
    reconstruction."""

    #: base chunk length the per-pass ``rank_batch`` hints derive from
    rank_base: int = 1024

    def rank(self, digit: torch.Tensor, n_bins: int, *,
             batch_hint: Optional[int] = None,
             carry_in: Optional[torch.Tensor] = None,
             bin_start: Optional[torch.Tensor] = None,
             engine: Optional[str] = None):
        """Stable output slot per key for one digit stream.  Returns
        ``(rank, counts, carry_out)``; ``engine`` is the pass's hint."""
        raise NotImplementedError

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
            # torch has no index_put for uint16/32/64: move their bits as
            # the signed type of the same width
            signed = _SIGNED_VIEW.get(a.dtype)
            src = a if signed is None else a.view(signed)
            out = torch.zeros_like(src)
            out[idx] = src
            outs.append(out if signed is None else out.view(a.dtype))
        return tuple(outs)

    def lsd_pass_pairs(self, u: torch.Tensor, payloads: tuple,
                       dp: DigitPass) -> tuple:
        """One stable counting pass moving the keys and every payload to
        the digit's rank order.  Returns ``(u, *payloads)``."""
        rank, _, _ = self.rank(_digit_of(u, dp), dp.n_bins,
                               batch_hint=dp.rank_batch(self.rank_base),
                               engine=dp.engine)
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
             bin_start=None, engine=None):
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
    """Hand-written kernel primitives: K1 histogram, K2/K3 rank (by the
    pass's engine hint; ``None`` → the one-hot kernel K2), K4 reconstruct.
    ``block`` is the rank kernels' tile.  Each kernel call starts from zero
    carry, so ``carry_in`` is refused."""

    def __init__(self, block: int = 1024):
        self.block = block

    def rank(self, digit, n_bins, *, batch_hint=None, carry_in=None,
             bin_start=None, engine=None):
        if carry_in is not None:
            raise NotImplementedError(
                "streaming carry is a TorchBackend mode; each rank kernel "
                "call starts from zero carry")
        from repro_torch.kernels.fractal_rank import fractal_rank_counts

        return fractal_rank_counts(digit, n_bins, block=self.block,
                                   bin_start=bin_start, engine=engine)

    def histogram(self, digit, n_bins, init=None):
        from repro_torch.kernels.fractal_histogram import fractal_histogram

        return fractal_histogram(digit, n_bins, init=init)

    def reconstruct(self, counts, trailing, plan):
        from repro_torch.kernels.fractal_reconstruct import (
            fractal_reconstruct_plan)

        return fractal_reconstruct_plan(counts, trailing, plan)


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

    def _msd_rank(self, u: torch.Tensor, last: DigitPass):
        return self.backend.rank(
            _digit_of(u, last), last.n_bins,
            batch_hint=last.rank_batch(self.backend.rank_base),
            engine=last.engine)

    # -- plain sort ---------------------------------------------------------

    def run(self, keys: torch.Tensor, plan: SortPlan,
            encode=None) -> torch.Tensor:
        """Sorted keys, rebuilt by the backend's Algorithm 5.

        ``encode`` (here and on every ``run*`` mode) is an order-preserving
        transform applied to ``keys`` inside the run, so raw columns enter
        and pass 0 extracts digits from the encoded stream."""
        u = _as_key_stream(keys, encode)
        if u.shape[0] == 0 or not plan.passes:
            # empty input, or the p=0 identity plan
            return u if encode is not None else keys
        pass_stats = self._pass_stats(u, plan, with_index=False)
        for i, dp in enumerate(plan.passes[:-1]):
            with self._pass_span(pass_stats, i, dp):
                u, = self.backend.lsd_pass_pairs(u, (), dp)
                if pass_stats is not None:
                    self._sync(u)
        last = plan.passes[-1]
        with self._pass_span(pass_stats, len(plan.passes) - 1, last):
            rank, counts, _ = self._msd_rank(u, last)
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
        u = _as_key_stream(keys, encode)
        if u.shape[0] == 0 or not plan.passes:
            return (u if encode is not None else keys), values
        pass_stats = self._pass_stats(u, plan, with_index=True)
        for i, dp in enumerate(plan.passes[:-1]):
            with self._pass_span(pass_stats, i, dp):
                u, *payloads = self.backend.lsd_pass_pairs(
                    u, tuple(payloads), dp)
                if pass_stats is not None:
                    self._sync(u, *payloads)
        last = plan.passes[-1]
        with self._pass_span(pass_stats, len(plan.passes) - 1, last):
            rank, counts, _ = self._msd_rank(u, last)
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
        u = _as_key_stream(keys, encode)
        n = u.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=u.device)
        if n == 0 or not plan.passes:
            return idx  # p=0: all keys equal, stable perm is the identity
        pass_stats = self._pass_stats(u, plan, with_index=True)
        for i, dp in enumerate(plan.passes):
            with self._pass_span(pass_stats, i, dp):
                u, idx = self.backend.lsd_pass_pairs(u, (idx,), dp)
                if pass_stats is not None:
                    self._sync(u, idx)
        return idx

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
