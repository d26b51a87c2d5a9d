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

Every layer the reference splits over `model` runs on this rank's
`model` slice, as Megatron-LM splits it: attention, cross-attention, the
MLP, mamba and the mLSTM and sLSTM mixers (their modules' weights stay
split over `model`: :func:`gathered` leaves the names a module's
``tp_weights()`` gives; :func:`fsdp_gather` gathers them over the batch
axes only), and the embedding, the head and the loss on this rank's
vocab slice (:mod:`.transformer`, :mod:`repro_torch.train_lib`).
Column-parallel products take their input through :func:`tp_copy`
(Megatron's ``f``) and row-parallel ones give their output through
:func:`tp_sum` (``g``).  The rest (norms, a sublayer whose heads or
vocab do not split, the MoE router) is gathered whole where it runs and
computed replicated over `model`.

The collectives are :class:`torch.autograd.Function`\\ s with explicit
gradients; each data rank's loss is the mean over its own batch shard:

* a weight's all-gather over a batch axis (``data``) reduce-scatters its
  gradient, averaged over the axis (:class:`_GatherScatter` with AVG); a
  weight replicated over a batch axis averages its gradient there
  (:class:`_AvgGrad`);
* a weight's all-gather over ``model`` for replicated compute keeps this
  rank's slice of the gradient, with no reduction: every ``model`` rank
  computed the same batch (:class:`_GatherSlice`);
* inside a sublayer split over `model`, each rank computes its own part:
  an activation all-gathered over `model` reduce-scatters its gradient,
  summed (:class:`_GatherScatter` with SUM), or, where what follows is
  replicated over `model`, keeps this rank's slice of it
  (:class:`_GatherSlice`); an activation moved between the ranks by an
  all-to-all moves its gradient back by the inverse one
  (:class:`_AllToAll`); ``f`` sums the gradient of the sublayer's input
  (:class:`_GradSum`), ``g`` sums the output (:class:`_Sum`).

Over a one-rank group neither the collective nor its Function runs
(``x`` passes as it is), as the reference's program has no collective
over an axis of size 1.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import sharding as SH

__all__ = ["set_batch_axes", "meshed", "get_batch_axes", "get_mesh",
           "constrain_batch", "fsdp_gather", "gather_param", "gathered",
           "sum_over", "grad_sum_over", "tp_copy", "tp_sum",
           "gather_model", "all_to_all_model", "model_group", "model_rank",
           "model_size", "mesh_sizes", "tp_names"]

_BATCH_AXES: Optional[tuple] = None
_MESH = None
# what the model reads of the mesh set, read once a mesh (a decode step
# asks a hundred times): its axis sizes, `model` coordinate and groups,
# and each module's tp_weights()
_CACHE: dict = {}


def set_batch_axes(axes: Optional[tuple], mesh=None):
    """axes: e.g. ("pod", "data"), or None to disable the batch-sharded
    paths.  ``mesh`` enables the per-shard paths (the MoE branch, split-KV
    decode, the gathers of sharded parameters)."""
    global _BATCH_AXES, _MESH
    _BATCH_AXES = tuple(axes) if axes else None
    _MESH = mesh
    _CACHE.clear()


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
    """The reference's per-layer FSDP weight gather: ``w`` gathered over
    the mesh's batch axes only, its `model` slice on ``tp_dim`` kept (-1:
    a column-parallel weight, 0: a row-parallel one).  ``w`` as it is
    where no mesh is set or ``w`` carries no ``shard_spec`` (it is whole:
    unsharded, or gathered whole by :func:`gathered`)."""
    spec = getattr(w, "shard_spec", None)
    if _MESH is None or spec is None:
        return w
    if not SH.names_model(spec, tp_dim) and any(
            SH.names_model(spec, d) for d in range(len(spec))):
        raise ValueError(f"fsdp_gather: spec {spec} splits `model` off "
                         f"dim {tp_dim}")
    return gather_param(w, spec, tuple(a for a in mesh_sizes()
                                       if a != "model"))


# --- differentiable collectives --------------------------------------------


class _GatherScatter(torch.autograd.Function):
    """All-gather along ``dim`` over the group; backward: this rank's
    block of the gradient reduced over the group by ``op`` (AVG over a
    batch axis, SUM over `model` inside a split sublayer)."""

    @staticmethod
    def forward(ctx, x, dim, group, op):
        ctx.dim, ctx.group, ctx.op = dim, group, op
        return SH.all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (SH.reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.op), None,
                None, None)


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


class _AllToAll(torch.autograd.Function):
    """The uneven all-to-all along ``dim`` over the group
    (:func:`~repro_torch.sharding.all_to_all_dim`); backward: the
    inverse all-to-all (``send`` and ``recv`` swapped)."""

    @staticmethod
    def forward(ctx, x, dim, send, recv, group):
        ctx.dim, ctx.send, ctx.recv, ctx.group = dim, send, recv, group
        return SH.all_to_all_dim(x, dim, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return (SH.all_to_all_dim(g, ctx.dim, ctx.recv, ctx.send, ctx.group),
                None, None, None, None)


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


def _summed(x: torch.Tensor, groups) -> torch.Tensor:
    """A copy of ``x`` summed over the groups."""
    x = x.clone(memory_format=torch.contiguous_format)
    for group in groups:
        dist.all_reduce(x, group=group)
    return x


class _Sum(torch.autograd.Function):
    """All-reduce SUM over the groups; backward: the identity, or, with
    ``grad_sum``, the gradient summed over the groups too."""

    @staticmethod
    def forward(ctx, x, groups, grad_sum):
        ctx.groups, ctx.grad_sum = groups, grad_sum
        return _summed(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.groups) if ctx.grad_sum else g, None, None


class _GradSum(torch.autograd.Function):
    """Identity; backward: the gradient summed over the groups."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.groups), None


def _group(axis):
    """The process group of the mesh's ``axis``; None where it has one
    rank (every collective over it, and its autograd Function, is the
    identity there)."""
    key = ("group", axis)
    if key not in _CACHE:
        group = _MESH.get_group(axis)
        _CACHE[key] = group if dist.get_world_size(group) > 1 else None
    return _CACHE[key]


def _groups(axes) -> tuple:
    return tuple(g for g in map(_group, axes) if g is not None)


def sum_over(x: torch.Tensor, axes, grad_sum: bool = False):
    """``x`` summed over the mesh ``axes``.  Its gradient passes through
    (the ranks' downstream compute is one replicated computation), or
    with ``grad_sum`` is summed over the axes too (each rank's downstream
    compute is its own: a statistic every batch shard's loss reads)."""
    groups = _groups(axes)
    return _Sum.apply(x, groups, grad_sum) if groups else x


def grad_sum_over(x: torch.Tensor, axes):
    """``x`` as it is; its gradient summed over the mesh ``axes`` (each
    rank's backward holds a part of it)."""
    groups = _groups(axes)
    return _GradSum.apply(x, groups) if groups else x


def tp_copy(x: torch.Tensor):
    """Megatron's ``f``, on the input of a column-parallel product: the
    identity; its gradient summed over `model` (each rank's columns give
    a part of it)."""
    return grad_sum_over(x, ("model",))


def tp_sum(x: torch.Tensor):
    """Megatron's ``g``, on the output of a row-parallel product: the
    ranks' partial sums summed over `model`; its gradient passes as it is
    (what follows is replicated over `model`)."""
    return sum_over(x, ("model",))


def gather_model(x: torch.Tensor, dim: int, replicated: bool = False):
    """This rank's part of an activation concatenated along ``dim`` with
    the other `model` ranks' (group-rank order).  The gradient of the
    whole is reduce-scattered back, summed (each rank's use gives a
    part); with ``replicated`` (what follows is one computation
    replicated over `model`) this rank keeps its slice of it."""
    group = _group("model")
    if group is None:
        return x
    if replicated:
        return _GatherSlice.apply(x, dim, group)
    return _GatherScatter.apply(x, dim, group, dist.ReduceOp.SUM)


def all_to_all_model(x: torch.Tensor, dim: int, send, recv):
    """The uneven all-to-all of ``x`` along ``dim`` over `model`
    (:func:`~repro_torch.sharding.all_to_all_dim`: ``send[t]`` entries to
    rank ``t``, ``recv[s]`` from rank ``s``); its gradient moves back by
    the inverse one."""
    group = _group("model")
    return x if group is None else _AllToAll.apply(x, dim, tuple(send),
                                                   tuple(recv), group)


def model_group():
    """The process group of the mesh's `model` axis; None where no mesh is
    set or the axis has one rank (nothing to reduce over)."""
    return None if _MESH is None else _group("model")


def model_rank() -> int:
    """This rank's coordinate on the mesh's `model` axis."""
    if "rank" not in _CACHE:
        _CACHE["rank"] = _MESH.get_local_rank("model")
    return _CACHE["rank"]


def mesh_sizes() -> dict:
    """``{axis name: size}`` of the mesh set."""
    if "sizes" not in _CACHE:
        _CACHE["sizes"] = dict(SH.axis_sizes(_MESH))
    return _CACHE["sizes"]


def model_size() -> int:
    """The size of the mesh's `model` axis (1 where it has none)."""
    return mesh_sizes().get("model", 1)


def tp_names(module: torch.nn.Module) -> tuple:
    """``module.tp_weights()`` (the weights it keeps split over `model`;
    none for a module without the method), read once a mesh: it depends
    only on the mesh and on the specs the model is stored by."""
    if _MESH is None or not hasattr(module, "tp_weights"):
        return ()
    key = ("tp", id(module))
    if key not in _CACHE:
        _CACHE[key] = module.tp_weights()
    return _CACHE[key]


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
            group = _group(a)
            if group is None or (axes is not None and a not in axes):
                continue
            x = (_GatherScatter.apply(x, dim, group, dist.ReduceOp.AVG)
                 if a in batch else _GatherSlice.apply(x, dim, group))
    for a in batch:
        group = _group(a)
        if a not in named and group is not None and (axes is None
                                                     or a in axes):
            x = _AvgGrad.apply(x, group)
    return x


@contextlib.contextmanager
def gathered(module: torch.nn.Module, names: Optional[tuple] = None):
    """Inside, the parameters of ``module`` (recursively; or only its own
    ``names``) that carry a ``shard_spec`` are whole (:func:`gather_param`):
    the sharded tensor is swapped out for the gathered one and back on
    exit.  A module whose class sets ``gathers_own_weights`` (the MoE
    layer) is skipped: it gathers its weights itself; so are the weights
    a module's ``tp_weights()`` names (a dense sublayer that runs on its
    `model` slice and gathers them through :func:`fsdp_gather`).  Without
    a mesh, or for parameters without a spec, nothing happens."""
    if _MESH is None:
        yield
        return
    swapped = []
    try:
        if names is None:
            mods = [m for m in module.modules()
                    if not getattr(m, "gathers_own_weights", False)]
            pairs = [(m, n) for m in mods for n in m._parameters
                     if n not in tp_names(m)]
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
