"""The paper's own experiment configurations (§IV) as selectable workload
configs (port of ``repro.configs.fractal_sort_paper``): the sort
workloads a benchmark harness selects; kept alongside the LM
architecture configs so `--arch`-style selection covers the paper's
native workloads too.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SortWorkload:
    name: str
    p: int              # key precision (bits)
    log2n_range: tuple  # dataset sizes, paper Fig. 3/5/6/9
    batches: tuple      # serial batch counts, paper Fig. 7/8
    distribution: str = "uniform"  # paper §IV.A test bed
    # SortPlan per-pass bin cap (log2).  None -> the library default
    # (repro_torch.core.DEFAULT_MAX_BINS_LOG2); the
    # paper's native scheme is 16 (one 2**16-counter pass per field).
    max_bins_log2: int | None = None


# Table II / Figs 3,6,7,8: p=32 latency+memory study up to n=2^30
PAPER_P32 = SortWorkload(
    name="paper-p32",
    p=32,
    log2n_range=(10, 30),
    batches=(1, 2, 5, 10, 20),
)

# Figs 9,10: p=16 throughput + bandwidth-efficiency study (512MB..32GB)
PAPER_P16 = SortWorkload(
    name="paper-p16",
    p=16,
    log2n_range=(10, 31),
    batches=(1, 14),
)

# The paper's own pass scheme (LLC-resident 2**16-counter trie, one pass
# per 16-bit field) — the analytic-bandwidth reference plan.
PAPER_NATIVE_PLAN = SortWorkload(
    name="paper-native-plan",
    p=32,
    log2n_range=(10, 30),
    batches=(1,),
    max_bins_log2=16,
)

WORKLOADS = {w.name: w for w in (PAPER_P32, PAPER_P16, PAPER_NATIVE_PLAN)}
