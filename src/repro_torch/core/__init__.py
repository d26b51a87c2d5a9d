"""The sort engine: trie histogram, planner, pass loop and public sorts."""

from repro_torch.core.fractal_tree import (
    FractalHistogram,
    as_u32_bits,
    bit_reverse,
    build_histogram,
    ceil_log2,
    exclusive_cumsum,
    get_index,
    get_item,
    histogram_nbytes,
    merge_histograms,
    taper_levels,
    tapered_bits,
    tapered_dtype,
    trie_depth,
)
from repro_torch.core.sort_plan import (
    DEFAULT_MAX_BINS_LOG2,
    DigitPass,
    SortPlan,
    convert_plan,
    make_sort_plan,
    pass_cost,
    pick_engine,
    plan_cost,
    quantize_sort_bits,
    rank_chunk_len,
    scatter_tile_len,
)
from repro_torch.core.executor import (
    CudaBackend,
    PassBackend,
    PlanExecutor,
    TorchBackend,
)
from repro_torch.core.fractal_sort import (
    PassStats,
    SortStats,
    fractal_argsort,
    fractal_rank,
    fractal_rank_scatter,
    fractal_rank_serial,
    fractal_sort,
    fractal_sort_pairs,
    fractal_sort_stats,
    keys_dtype,
    rank_engine,
    reconstruct,
)
