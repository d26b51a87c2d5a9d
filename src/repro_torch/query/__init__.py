"""Query execution: typed key codecs and sort-backed relational operators,
every one bottoming out in the
:class:`~repro_torch.core.executor.PlanExecutor` (see ``operators.py``).
Port of ``repro.query``."""

from repro_torch.query.codec import (
    BoolCodec,
    Codec,
    ColumnSpec,
    CompositeCodec,
    Float32Codec,
    Float64Codec,
    IntCodec,
    UIntCodec,
    infer_codec,
    word_widths,
)
from repro_torch.query.operators import (
    distinct,
    group_by,
    order_by,
    sort_merge_join,
    sort_rowids,
    top_k,
)
from repro_torch.query.table import Table
