"""Out-of-core streaming sort subsystem: histogram-partitioned external
sort over chunk streams, on the card under a byte budget.

Port of ``repro.stream``:

* :mod:`~repro_torch.stream.chunks` — the :class:`ChunkSource` protocol,
  the :class:`MemoryBudget` that sizes chunks from a byte cap and counts
  host and device copies, and the placement stores (:class:`RunStore`:
  fragments on disk, distributed and sorted on the work device);
* :mod:`~repro_torch.stream.device_store` — :class:`DeviceShardStore`,
  the placement over a ``torch.distributed`` group (fragments routed to
  their owner ranks by collectives, partition sorts through the
  distributed backend);
* :mod:`~repro_torch.stream.partition` — one streamed histogram pass (K1
  with a carried ``init`` on the card), then greedy merging of adjacent
  bins into budget-fitting partitions;
* :mod:`~repro_torch.stream.external` — :func:`external_sort` /
  :func:`external_argsort`: each partition sorts through the
  :class:`~repro_torch.core.executor.PlanExecutor`; partitions are
  disjoint key ranges, so concatenation is the total order;
* :mod:`~repro_torch.stream.merge` — stable k-way merge of pre-sorted
  runs on the host;
* :mod:`~repro_torch.stream.table_ops` — :class:`StreamTable` and the
  streaming ``order_by`` / ``group_by`` / ``top_k`` the query operators
  dispatch to.
"""

from repro_torch.stream.chunks import (
    ArraySource,
    ChunkSource,
    GeneratorSource,
    MemoryBudget,
    PlacementStore,
    RunSource,
    RunStore,
    temp_store,
)
from repro_torch.stream.device_store import DeviceShardStore
from repro_torch.stream.partition import (
    KeyPartition,
    partition_bins,
    streamed_field_counts,
)
from repro_torch.stream.external import (
    external_argsort,
    external_sort,
)
from repro_torch.stream.merge import merge_runs
from repro_torch.stream.table_ops import (
    StreamTable,
    stream_group_by,
    stream_order_by,
    stream_top_k,
)
