"""Stable k-way merge of pre-sorted on-disk runs.

Port of ``repro.stream.merge``.  It runs on the host over memory-mapped
runs, as the reference does, and launches no kernel: it is the path for
runs that are already sorted.

The partitioned external sort never merges — its partitions are disjoint
key ranges, so concatenation is the total order.  This module is the
*pure-streaming* fallback for when a re-partition pass is not possible:
the input already exists as sorted runs (a prior spill, an upstream
producer's chunked output) and can only be read forward.

Runs open as numpy memory-maps (resident page by page, never whole), and
the merge advances in rounds: each round picks the smallest block-tail
key across runs as the emit *bound*, then drains every key ``<= bound``
from **every** active run — the whole equal-key tail, found by binary
search over the memmapped remainder, not just the block — and emits the
drained rows in one stable sort.  Draining past the block is what makes
the merge stable *across* rounds: a key equal to the bound can never be
left behind in one run while another run's equal keys ship, so ties
order by (run position in ``run_ids``, within-run arrival) globally.
The cost is that a massive equal-key tail inflates one round past the
block size (charged to the budget tracker, visible in ``peak_bytes``);
heavily skewed data belongs on the partitioned path, which recurses —
this merge is the fallback for *pre-sorted* runs.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from repro_torch.stream.chunks import MemoryBudget, RunStore

__all__ = ["merge_runs"]


def merge_runs(store: RunStore, run_ids: Sequence[int],
               budget: MemoryBudget,
               block_rows: Optional[int] = None) -> Iterator[tuple]:
    """Merge pre-sorted runs into one sorted stream of array tuples.

    Each run is a stored tuple ``(keys, *payloads)`` with ``keys`` 1-D
    and sorted; yielded chunks have the same arity.  ``block_rows`` caps
    the rows loaded per run per round (default: an equal split of the
    budget across the open runs).  Stability: ties across runs keep
    ``run_ids`` order, ties within a run keep the run's order — merging
    runs spilled in arrival order reproduces a global stable sort.
    """
    ids = list(run_ids)
    if not ids:
        return
    runs = [store.get(rid, mmap=True) for rid in ids]
    arity = len(runs[0])
    if any(len(r) != arity for r in runs):
        raise ValueError("runs must share arity")
    row_bytes = sum(int(a.dtype.itemsize) for a in runs[0])
    if block_rows is None:
        block_rows = max(1, budget.rows(row_bytes) // len(runs))
    pos = [0] * len(runs)

    while True:
        active = [i for i in range(len(runs))
                  if pos[i] < runs[i][0].shape[0]]
        if not active:
            return
        # the emit bound: smallest end-of-block key across active runs —
        # every run has already surfaced all its keys <= bound
        bound = min(
            runs[i][0][min(pos[i] + block_rows, runs[i][0].shape[0]) - 1]
            for i in active)
        pieces = []
        for i in active:
            keys_i = runs[i][0]
            # drain the FULL <= bound prefix (binary search over the
            # memmapped remainder): leaving an equal key for a later
            # round would break cross-run tie order
            take = int(np.searchsorted(keys_i[pos[i]:], bound,
                                       side="right"))
            if take:
                pieces.append(tuple(np.asarray(a[pos[i]:pos[i] + take])
                                    for a in runs[i]))
                pos[i] += take
        # the bound-achieving run always consumes its whole block: progress
        if not pieces:
            raise ValueError("merge stalled (unsorted run?)")
        cat = tuple(np.concatenate([p[j] for p in pieces])
                    for j in range(arity))
        order = np.argsort(cat[0], kind="stable")
        out = tuple(a[order] for a in cat)
        budget.charge(*out)
        yield out
