"""Pipeline parallelism (GPipe-style) over a mesh axis (port of
``repro.pipeline``).

Stage s holds layers [s*L/S, (s+1)*L/S); microbatches stream through with
activations handed stage to stage by point-to-point sends.  The bubble
fraction is the usual (S-1)/(S-1+M).  Forward only, as in the reference:
the substrate and its correctness contract (== sequential execution).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

__all__ = ["gpipe_apply"]


def gpipe_apply(stage_fn: Callable, mesh, axis: str, stage_params, x_micro):
    """Run ``stage_fn(params, x) -> y`` (``y`` of ``x``'s shape) as an
    S-stage pipeline over the ``axis`` of ``mesh``: every rank of that
    axis's group calls this, rank s passing ``stage_params``, its own
    stage's parameters (the reference's stacked tree sliced at s).

    x_micro: (M, mb, ...) microbatched input, the same on every rank.
    Returns (M, mb, ...) outputs on every rank, equal to applying the S
    stages sequentially to each microbatch.  The schedule is the
    reference's: at tick t of T = M + S - 1, stage s runs microbatch
    t - s when there is one, taking it from x_micro (stage 0) or from
    stage s - 1, and handing its output to stage s + 1; the last stage
    keeps it.  Its outputs are then broadcast (the reference's masked
    ``psum``).  A bubble tick computes nothing here (the reference
    computes and masks)."""
    group = mesh.get_group(axis)
    S, sid = dist.get_world_size(group), dist.get_rank(group)
    M = x_micro.shape[0]
    outs = torch.zeros_like(x_micro)
    for t in range(M + S - 1):
        mb = t - sid  # microbatch index at this stage, this tick
        if not 0 <= mb < M:
            continue
        if sid == 0:
            x_in = x_micro[mb]
        else:
            x_in = torch.empty_like(x_micro[0])
            dist.recv(x_in, dist.get_global_rank(group, sid - 1), group=group)
        y = stage_fn(stage_params, x_in)
        if sid < S - 1:
            dist.send(y.contiguous(), dist.get_global_rank(group, sid + 1),
                      group=group)
        else:
            outs[mb] = y
    dist.broadcast(outs, dist.get_global_rank(group, S - 1), group=group)
    return outs
