"""Sharding state and the differentiable collectives of the sharded step
(port of ``repro.models.act_sharding``).

The reference pins activation layouts for GSPMD, one program over the
whole mesh.  The port runs SPMD, one process a rank, so its state is the
same process-global pair, set by the step factories
(:func:`repro_torch.train_lib.shard_train_step`) and read by the model:

* ``batch_axes``: the mesh axes the batch is split over (``("data",)``,
  or ``("pod", "data")``); when set with a mesh, :func:`repro_torch.
  models.moe.moe_apply` takes its expert-parallel branch;
* ``mesh``: the ``DeviceMesh``; parameters that carry a spec
  (``shard_spec``, set by the sharded step) are gathered whole by
  :func:`gathered` where the model uses them.

When unset (one rank, no mesh) everything here is the identity.

The collectives are :class:`torch.autograd.Function`\\ s with explicit
gradients, because compute is replicated over ``model`` and each data
rank's loss is the mean over its own batch shard:

* a weight's all-gather over a batch axis (``data``) reduce-scatters its
  gradient, averaged over the axis (:class:`_GatherAvg`); a weight
  replicated over a batch axis averages its gradient there
  (:class:`_AvgGrad`);
* a weight's all-gather over ``model`` keeps this rank's slice of the
  gradient, with no reduction: every ``model`` rank computed the same
  batch (:class:`_GatherSlice`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import sharding as SH

__all__ = ["set_batch_axes", "meshed", "get_batch_axes", "get_mesh",
           "constrain_batch", "fsdp_gather", "gather_param", "gathered",
           "sum_over", "grad_sum_over"]

_BATCH_AXES: Optional[tuple] = None
_MESH = None


def set_batch_axes(axes: Optional[tuple], mesh=None):
    """axes: e.g. ("pod", "data"), or None to disable the batch-sharded
    paths.  ``mesh`` enables the per-shard paths (the MoE branch, split-KV
    decode, the gathers of sharded parameters)."""
    global _BATCH_AXES, _MESH
    _BATCH_AXES = tuple(axes) if axes else None
    _MESH = mesh


@contextlib.contextmanager
def meshed(axes: Optional[tuple], mesh):
    """``set_batch_axes(axes, mesh)`` inside; the state before restored on
    exit."""
    was = _BATCH_AXES, _MESH
    set_batch_axes(axes, mesh)
    try:
        yield
    finally:
        set_batch_axes(*was)


def get_batch_axes() -> Optional[tuple]:
    return _BATCH_AXES


def get_mesh():
    return _MESH


def constrain_batch(x):
    """The identity: the reference pins the batch dim to the DP axes for
    GSPMD; an SPMD rank already holds only its batch shard."""
    return x


def fsdp_gather(w, tp_dim: int):
    """The reference's per-layer FSDP weight gather (a layout constraint
    keeping ``w`` sharded over `model` on ``tp_dim``).  The identity here:
    the sharded step gathers a block's weights whole before the block
    runs (:func:`gathered`), so ``w`` is whole.  These call sites are
    where a tensor-parallel split would keep ``w``'s `model` slice."""
    del tp_dim
    return w


# --- differentiable collectives --------------------------------------------


class _GatherAvg(torch.autograd.Function):
    """All-gather along ``dim`` over a batch axis; backward: this rank's
    block of the gradient averaged over the axis."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return SH.all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (SH.reduce_scatter_dim(g, ctx.dim, ctx.group,
                                      dist.ReduceOp.AVG), None, None)


class _GatherSlice(torch.autograd.Function):
    """All-gather along ``dim`` over an axis the compute is replicated
    over; backward: this rank's slice of the gradient, no reduction."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return SH.all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


class _AvgGrad(torch.autograd.Function):
    """Identity; backward: the gradient averaged over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.AVG, group=ctx.group)
        return g, None


class _Sum(torch.autograd.Function):
    """All-reduce SUM over the groups; backward: the identity, or, with
    ``grad_sum``, the gradient summed over the groups too."""

    @staticmethod
    def forward(ctx, x, groups, grad_sum):
        ctx.groups, ctx.grad_sum = groups, grad_sum
        x = x.clone(memory_format=torch.contiguous_format)
        for group in groups:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = g.clone(memory_format=torch.contiguous_format)
            for group in ctx.groups:
                dist.all_reduce(g, group=group)
        return g, None, None


class _GradSum(torch.autograd.Function):
    """Identity; backward: the gradient summed over the groups."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


def _groups(axes) -> tuple:
    return tuple(_MESH.get_group(a) for a in axes)


def sum_over(x: torch.Tensor, axes, grad_sum: bool = False):
    """``x`` summed over the mesh ``axes``.  Its gradient passes through
    (the ranks' downstream compute is one replicated computation), or
    with ``grad_sum`` is summed over the axes too (each rank's downstream
    compute is its own: a statistic every batch shard's loss reads)."""
    return _Sum.apply(x, _groups(axes), grad_sum)


def grad_sum_over(x: torch.Tensor, axes):
    """``x`` as it is; its gradient summed over the mesh ``axes`` (each
    rank's backward holds a part of it)."""
    return _GradSum.apply(x, _groups(axes))


def gather_param(shard: torch.Tensor, spec: tuple,
                 axes: Optional[tuple] = None) -> torch.Tensor:
    """The whole of a parameter from this rank's ``shard`` under ``spec``
    (only its ``axes``, where given: the rest stay sharded), through the
    gradient rules above: batch axes average the gradient, ``model``
    slices it.  A batch axis the spec does not name averages the
    gradient of the replicated weight."""
    batch = _BATCH_AXES or ()
    x = shard
    named = set()
    for dim, ax in enumerate(spec):
        # minor axis first: a dim split over (pod, data) is pod-major
        for a in reversed(SH.entry_axes(ax)):
            named.add(a)
            if axes is not None and a not in axes:
                continue
            fn = _GatherAvg if a in batch else _GatherSlice
            x = fn.apply(x, dim, _MESH.get_group(a))
    for a in batch:
        if a not in named and (axes is None or a in axes):
            x = _AvgGrad.apply(x, _MESH.get_group(a))
    return x


@contextlib.contextmanager
def gathered(module: torch.nn.Module, names: Optional[tuple] = None):
    """Inside, the parameters of ``module`` (recursively; or only its own
    ``names``) that carry a ``shard_spec`` are whole (:func:`gather_param`):
    the sharded tensor is swapped out for the gathered one and back on
    exit.  A module whose class sets ``gathers_own_weights`` (the MoE
    layer) is skipped: it gathers its weights itself.  Without a mesh, or
    for parameters without a spec, nothing happens."""
    if _MESH is None:
        yield
        return
    swapped = []
    try:
        if names is None:
            mods = [m for m in module.modules()
                    if not getattr(m, "gathers_own_weights", False)]
            pairs = [(m, n) for m in mods for n in m._parameters]
        else:
            pairs = [(module, n) for n in names]
        for m, n in pairs:
            p = m._parameters[n]
            spec = getattr(p, "shard_spec", None)
            if spec is None:
                continue
            swapped.append((m, n, p))
            m._parameters[n] = gather_param(p, spec)
        yield
    finally:
        for m, n, p in reversed(swapped):
            m._parameters[n] = p
