"""MoE token dispatch built from the fractal kernels (port of
``repro.kernels.moe_dispatch``).

Routing tokens to experts is a ``p = ceil(log2 E)``-bit fractal sort:

* the leaf histogram (K1) is each expert's load, which capacity and the
  load-balancing loss need anyway;
* the rank pass (K2) is each assignment's slot in expert-grouped order;
* the inverse permutation is the gather order that groups tokens by
  expert.

One read of the expert ids for the histogram and one for the ranks, in
place of a comparison sort of the ids
(:func:`~repro_torch.kernels.ref.moe_dispatch_ref`, the plain version).
On a CUDA tensor both kernels launch; on a CPU tensor their wrappers
compute their plain versions.  :func:`moe_ranks` is the custom operator
``repro_torch::moe_ranks``, whose registered fake gives the outputs'
shapes alone: on the ``meta`` device (the dry-run's parameters and
activations) the dispatcher routes it there, by device type, and no
kernel is built or launched.
"""

from __future__ import annotations

import torch

from repro_torch.core.fractal_tree import exclusive_cumsum
from repro_torch.kernels.fractal_histogram import fractal_histogram
from repro_torch.kernels.fractal_rank import fractal_rank_kernel

__all__ = ["moe_ranks", "moe_dispatch"]


@torch.library.custom_op("repro_torch::moe_ranks", mutates_args=())
def moe_ranks(expert_ids: torch.Tensor, num_experts: int,
              block: int = 1024) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The part of :func:`moe_dispatch` that the MoE layer reads: int32
    ``(rank, counts, start)``, ``start`` (E,) being the experts' first
    slots (the exclusive sum of ``counts``, which K2 takes anyway)."""
    ids = expert_ids.to(torch.int32).contiguous()
    counts = fractal_histogram(ids, num_experts)
    start = exclusive_cumsum(counts)
    rank = fractal_rank_kernel(ids, start, num_experts, block=block)
    return rank, counts, start


@moe_ranks.register_fake
def _moe_ranks_shapes(expert_ids, num_experts, block=1024):
    """Ranks (T,) and counts, starts (E,), int32, with no values."""
    return (expert_ids.new_empty(expert_ids.shape, dtype=torch.int32),
            expert_ids.new_empty((num_experts,), dtype=torch.int32),
            expert_ids.new_empty((num_experts,), dtype=torch.int32))


def moe_dispatch(expert_ids: torch.Tensor, num_experts: int,
                 block: int = 1024) -> tuple:
    """Dispatch metadata for flattened top-k expert assignments.

    ``expert_ids``: (T,) integer in ``[0, num_experts)``, assignment i's
    expert (already flattened over the top-k dimension).

    Returns, all int32:

    * ``perm`` (T,): the gather order; ``expert_ids[perm]`` is sorted, and
      expert e's assignments hold slots ``[start[e], start[e] + counts[e])``;
    * ``rank`` (T,): the inverse of ``perm`` (assignment i's slot);
    * ``counts`` (E,): each expert's load.
    """
    T = expert_ids.shape[0]
    rank, counts, _ = moe_ranks(expert_ids, num_experts, block)
    perm = torch.zeros((T,), dtype=torch.int32, device=rank.device)
    perm[rank.long()] = torch.arange(T, dtype=torch.int32, device=rank.device)
    return perm, rank, counts
