"""Distribution-adaptive MSD partitioning from the streamed fractal histogram.

Port of ``repro.stream.partition``.  The external sort's first pass
accumulates the histogram of the leading MSD field across every chunk of
a :class:`~repro_torch.stream.chunks.ChunkSource`: one
:meth:`~repro_torch.core.executor.PlanExecutor.digit_counts` call per
chunk with the running counts as its ``init`` carry — on the card, K1
adding each chunk onto the carried counts.  No sampling pre-pass: the
histogram *is* the distribution.

The second half is pure planning: :func:`partition_bins` greedily merges
adjacent bins into partitions whose *predicted* sizes fit the budget.
Partitions are disjoint key ranges, so sorted partitions concatenate into
the total order.  A single bin that alone exceeds the budget becomes its
own oversized partition, which the external sort re-partitions
recursively on the next field down.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor import PlanExecutor
from repro_torch.core.fractal_sort import make_backend, resolve_device
from repro_torch.core.sort_plan import DigitPass
from repro_torch.obs import metrics

__all__ = [
    "DEFAULT_PARTITION_BITS",
    "KeyPartition",
    "bin_to_partition",
    "partition_bins",
    "streamed_field_counts",
]

#: Width of the leading MSD field the partitioner histograms: 1024 bins.
DEFAULT_PARTITION_BITS = 10

#: Rows the device (int32) histogram carry may accumulate before it is
#: spilled onto the host int64 total: K1 counts in int32 and a single bin
#: can hold every row, so the carry spills before any bin nears 2**31.
_CARRY_SPILL_ROWS = 1 << 30


@dataclasses.dataclass(frozen=True)
class KeyPartition:
    """Bins ``[lo, hi)`` of one partitioning field, with the histogram's
    predicted row count."""

    lo: int
    hi: int
    count: int

    @property
    def num_bins(self) -> int:
        return self.hi - self.lo

    def oversized(self, budget_rows: int) -> bool:
        """Predicted not to fit the budget — only ever true for a single
        bin (greedy merging never grows a partition past the budget)."""
        return self.count > budget_rows

    def shared_field_bits(self, w: int) -> int:
        """Leading bits of the ``w``-bit partitioning field every key in
        this partition provably shares: all member digits agree above the
        highest bit where ``lo`` and ``hi - 1`` differ."""
        if not 0 <= self.lo < self.hi <= (1 << w):
            raise ValueError(f"bins [{self.lo}, {self.hi}) outside {w} bits")
        return w - (self.lo ^ (self.hi - 1)).bit_length()


def _chunk_tensor(chunk, device: torch.device) -> torch.Tensor:
    """A 1-D chunk of field values as int32 storage on ``device``."""
    if not isinstance(chunk, torch.Tensor):
        a = np.ascontiguousarray(chunk)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        chunk = torch.from_numpy(a)
    elif chunk.dtype == torch.uint32:
        chunk = chunk.view(torch.int32)
    return chunk.to(device)


def streamed_field_counts(
    chunk_iter: Iterable,
    dp: DigitPass,
    executor: Optional[PlanExecutor] = None,
    device=None,
) -> Tuple[np.ndarray, int]:
    """Histogram of ``dp``'s digit across a whole chunk stream.

    ``chunk_iter`` yields 1-D uint32-castable key (or code-word) chunks,
    numpy or tensors; numpy chunks move to ``device`` (``None``: the card,
    raising without CUDA), tensors count where they lie.  Each chunk costs
    one executor ``digit_counts`` call with the running counts as its
    ``init`` carry (K1 on the card; ``executor`` defaults to the device's
    backend).  The carry is int32; before any carry window reaches
    ``_CARRY_SPILL_ROWS`` it spills onto a host int64 total, so bin counts
    stay exact at any scale.

    Returns ``(counts, total_rows)`` — counts as host int64."""
    device = resolve_device(device)
    ex = executor or PlanExecutor(make_backend(None, device))
    total64 = np.zeros((dp.n_bins,), np.int64)
    carried = None
    window_rows = 0
    total = 0
    n_chunks = 0
    for chunk in chunk_iter:
        chunk = _chunk_tensor(chunk, device)
        m = int(chunk.shape[0])
        n_chunks += 1
        if carried is not None and window_rows + m > _CARRY_SPILL_ROWS:
            total64 += carried.cpu().numpy().astype(np.int64)
            carried, window_rows = None, 0
        if carried is not None and carried.device != chunk.device:
            carried = carried.to(chunk.device)
        carried = ex.digit_counts(chunk, dp, init=carried)
        window_rows += m
        total += m
    if carried is not None:
        total64 += carried.cpu().numpy().astype(np.int64)
    metrics.counter("stream.histogram.chunks").inc(n_chunks)
    metrics.counter("stream.histogram.rows").inc(total)
    return total64, total


def partition_bins(counts: np.ndarray,
                   budget_rows: int) -> Tuple[KeyPartition, ...]:
    """Greedily merge adjacent bins into budget-fitting partitions.

    Walks the histogram low bin to high, packing bins into the current
    partition while the predicted total stays within ``budget_rows``.  A
    single bin larger than the budget is emitted *alone*, so an oversized
    partition is always exactly one bin.  Empty bins attach to whichever
    partition is open; only non-empty partitions are returned, with bin
    ranges disjoint and ordered."""
    if budget_rows < 1:
        raise ValueError(f"budget_rows={budget_rows}")
    n_bins = int(np.asarray(counts).shape[0])
    parts = []
    lo, acc = 0, 0
    for b in range(n_bins):
        c = int(counts[b])
        if c > budget_rows:
            # skewed bin: alone, so recursion sees one shared digit
            if acc > 0:
                parts.append(KeyPartition(lo=lo, hi=b, count=acc))
            parts.append(KeyPartition(lo=b, hi=b + 1, count=c))
            lo, acc = b + 1, 0
            continue
        if acc > 0 and acc + c > budget_rows:
            parts.append(KeyPartition(lo=lo, hi=b, count=acc))
            lo, acc = b, 0
        acc += c
    if acc > 0:
        parts.append(KeyPartition(lo=lo, hi=n_bins, count=acc))
    return tuple(parts)


def bin_to_partition(partitions: Tuple[KeyPartition, ...],
                     n_bins: int) -> np.ndarray:
    """Bin id → partition index lookup (-1 for bins no partition claims —
    empty-count gaps that no key can hit)."""
    lut = np.full((n_bins,), -1, np.int64)
    for i, part in enumerate(partitions):
        lut[part.lo:part.hi] = i
    return lut
