"""Path-rule-based sharding: parameter names → partition specs (port of
``repro.sharding``).

T5X/MaxText-style logical rules: each rule is (path glob, spec for the
*trailing* dims).  Specs are right-aligned to the tensor's rank.  A spec
is a plain tuple with one entry a dim: ``None`` (replicated), a mesh
axis name, or a tuple of axis names (major first); torch has no
``PartitionSpec``.

The rules match the reference's parameter paths.  The port's parameter
names (``blocks.3.mixer.wq``) map onto them
(``blocks/b<3 % period>/mixer/wq``), as :mod:`repro_torch.models.convert`
maps the reference's weights: the
reference stacks one period of blocks over a leading ``repeats`` axis, so
its spec of a block weight is the port's with a leading ``None``.

Mesh contract (:mod:`repro_torch.launch.mesh`):
  * ``data``  — DP + FSDP: batch AND the d_model dim of every weight;
  * ``model`` — TP/EP: heads, mlp hidden, vocab, experts;
  * ``pod``   — cross-pod DP (params replicated across pods).

A mesh here is a :class:`torch.distributed.device_mesh.DeviceMesh` with
named dims, or, where only its axis sizes are read (:func:`param_specs`,
:func:`batch_axes`, :func:`dp_size`, :func:`data_specs`,
:func:`cache_specs`), a mapping ``{axis name: size}``.
:func:`local_shard` cuts this rank's block of a full tensor by a spec and
:func:`gather_full` puts the full tensor back together from the blocks.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig

__all__ = ["RULES", "param_specs", "batch_axes", "dp_size", "data_specs",
           "cache_specs", "axis_sizes", "entry_axes", "local_shard",
           "gather_full", "all_gather_dim", "reduce_scatter_dim",
           "all_to_all_dim", "all_reduce", "model_size", "splits_heads",
           "names_model"]

_FSDP = "data"
_TP = "model"

# (path glob, trailing-dims spec). First match wins.  MoE expert weights are
# resolved separately (pattern-aware) before these rules apply.
RULES = [
    # embeddings / unembedding
    ("*embed/table", (_TP, _FSDP)),        # (V, D): vocab x embed
    ("*lm_head/head", (_FSDP, _TP)),       # (D, V)
    # attention (incl. cross) and mlstm q/k/v/o
    ("*wq", (_FSDP, _TP)), ("*wk", (_FSDP, _TP)), ("*wv", (_FSDP, _TP)),
    ("*wo", (_TP, _FSDP)),
    ("*q_scale", (None,)), ("*k_scale", (None,)),
    # mlstm per-head gates (tiny trailing dim: keep unsharded)
    ("*mixer/wi", (_FSDP, None)), ("*mixer/wf", (_FSDP, None)),
    # dense mlp
    ("*ffn/wi", (_FSDP, _TP)), ("*ffn/wg", (_FSDP, _TP)),
    ("*ffn/wd", (_TP, _FSDP)),
    ("*ffn/router", (_FSDP, None)),
    # mamba
    ("*in_proj", (_FSDP, _TP)), ("*out_proj", (_TP, _FSDP)),
    ("*x_proj", (_TP, None)), ("*dt_proj", (None, _TP)),
    ("*dt_bias", (_TP,)), ("*conv_w", (None, _TP)), ("*conv_b", (_TP,)),
    ("*a_log", (_TP, None)), ("*d_skip", (_TP,)),
    # slstm input/recurrent weights: TP over model
    ("*mixer/s?", (_FSDP, _TP)), ("*mixer/r?", (_FSDP, _TP)),
    ("*f_bias", (None,)),
    # norms and leftovers: replicated
    ("*", (None,)),
]

# expert-weight specs by shard_axis choice, for trailing (E, d_in, d_out)
_MOE_RULES = {
    "experts": {"wi": (_TP, _FSDP, None), "wg": (_TP, _FSDP, None),
                "wd": (_TP, None, _FSDP)},
    "mlp": {"wi": (None, _FSDP, _TP), "wg": (None, _FSDP, _TP),
            "wd": (None, _TP, _FSDP)},
}


def _right_align(spec: tuple, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        spec = spec[-ndim:] if ndim else ()
    return (None,) * (ndim - len(spec)) + spec


def _is_moe_leaf(path: str, cfg: Optional[ModelConfig]) -> bool:
    if cfg is None or cfg.moe is None or "/ffn/" not in path:
        return False
    if path.startswith("encoder"):
        return False
    m = re.search(r"(?:^|/)b(\d+)/ffn/", path)
    if not m:
        return False
    return cfg.pattern[int(m.group(1))][1] == "moe"


def _spec_for(path: str, ndim: int, cfg: Optional[ModelConfig]) -> tuple:
    leaf = path.rsplit("/", 1)[-1]
    if _is_moe_leaf(path, cfg) and leaf in ("wi", "wg", "wd"):
        return _right_align(_MOE_RULES[cfg.moe.shard_axis][leaf], ndim)
    for pat, spec in RULES:
        if fnmatch.fnmatch(path, pat):
            return _right_align(spec, ndim)
    return (None,) * ndim


def axis_sizes(mesh) -> Mapping[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of a mapping, as it
    is)."""
    if isinstance(mesh, Mapping):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def model_size(mesh) -> int:
    """The size of ``mesh``'s `model` axis (1 where it has none)."""
    return axis_sizes(mesh).get(_TP, 1)


def splits_heads(n_heads: int, mesh) -> bool:
    """Whether ``n_heads`` whole heads split evenly over `model`: the
    condition for an attention sublayer to run on its `model` slice."""
    return n_heads % model_size(mesh) == 0


def names_model(spec: Optional[tuple], dim: int) -> bool:
    """Whether ``spec`` (``None``: no spec) splits ``dim`` over `model`."""
    return spec is not None and _TP in entry_axes(spec[dim])


def entry_axes(ax) -> tuple:
    """The axis names of one spec entry (``None``: none)."""
    return () if ax is None else ax if isinstance(ax, tuple) else (ax,)


def _fit_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop axes that don't divide their dim (no padding; e.g. whisper's
    vocab 51865 on a 16-way axis)."""
    if mesh is None:
        return spec
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in enumerate(spec):
        n = 1
        for a in entry_axes(ax):
            n *= sizes[a]
        out.append(ax if ax is None or shape[dim] % n == 0 else None)
    return tuple(out)


def _apply_policy(spec: tuple, cfg: Optional[ModelConfig]) -> tuple:
    """Per-arch sharding policy: cfg.fsdp=False drops the `data` weight
    axes (pure DP+TP — right for small models where per-layer weight
    collectives dominate)."""
    if cfg is None or cfg.fsdp:
        return spec

    def drop(ax):
        if ax == _FSDP:
            return None
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a != _FSDP)
            return kept if kept else None
        return ax
    return tuple(drop(a) for a in spec)


def _ref_path(name: str, cfg: ModelConfig) -> str:
    """The reference's parameter path of the port's parameter ``name``:
    block ``i`` of a stack is ``b<i % period>`` (the encoder's period is
    one block), a norm's ``.scale`` is the norm itself, ``embed`` and
    ``lm_head`` are ``embed/table`` and ``lm_head/head``."""
    parts = name.split(".")
    if parts[-1] == "scale" and len(parts) > 1 and parts[-2].startswith(
            ("norm", "final_norm")):
        parts = parts[:-1]
    if parts == ["embed"]:
        return "embed/table"
    if parts == ["lm_head"]:
        return "lm_head/head"
    for i, p in enumerate(parts):
        if p == "blocks" and i + 1 < len(parts):
            period = 1 if parts[0] == "encoder" else len(cfg.pattern)
            parts[i + 1] = f"b{int(parts[i + 1]) % period}"
            break
    return "/".join(parts)


def param_specs(model: torch.nn.Module, cfg: ModelConfig, mesh=None) -> dict:
    """``{parameter name: spec}`` over ``model.named_parameters()``, fitted
    to ``mesh``'s axis sizes where one is given.  Read from the full
    shapes: a model on the ``meta`` device serves (the shapes of a
    sharded model's local blocks do not)."""
    return {name: _fit_spec(_apply_policy(_spec_for(
        _ref_path(name, cfg), p.ndim, cfg), cfg), p.shape, mesh)
        for name, p in model.named_parameters()}


# --- activation / batch specs -------------------------------------------


def batch_axes(mesh) -> tuple:
    """Mesh axes carrying the global batch (pod extends data when present)."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def _entry(axes: tuple):
    """One spec entry over ``axes``: one axis as its name, as
    ``PartitionSpec`` writes it."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def data_specs(mesh, batch: dict) -> dict:
    """Shard every leading batch dim over (pod, data); tensors whose batch
    doesn't divide the DP size (e.g. B=1 long-context decode) replicate."""
    axes = _entry(batch_axes(mesh))
    n_dp = dp_size(mesh)

    def spec(x):
        if x.ndim == 0 or x.shape[0] % n_dp != 0:
            return (None,) * x.ndim
        return (axes,) + (None,) * (x.ndim - 1)

    return {k: spec(v) for k, v in batch.items()}


def cache_specs(mesh, cache: list, batch_size: int,
                kv_seq_shard: bool) -> list:
    """KV-cache sharding for serving, one dict of specs a layer as
    :func:`~repro_torch.models.transformer.init_cache` lays the cache out
    (the reference's specs without the leading repeats axis).
    Batch-sharded when possible: the K/V sequence dim over ``model``;
    tiny batches shard the sequence over every axis instead.  As in the
    reference, ``kv_seq_shard`` changes nothing: the split follows from
    the batch size alone."""
    del kv_seq_shard
    axes = batch_axes(mesh)
    n_dp = dp_size(mesh)
    batch = _entry(axes)

    def spec(name, x):
        if isinstance(x, dict):
            return {k: spec(k, v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(spec(name, v) for v in x)
        if name in ("k", "v", "ck", "cv") and x.ndim >= 4:
            # (B, S, KV, hd): batch over DP axes and the KV sequence over
            # `model`; tiny batches shard the sequence over everything
            if batch_size % n_dp == 0:
                return (batch, "model", None, None)
            return (None, tuple(axes) + ("model",), None, None)
        # recurrent states: (B, ...)
        if x.ndim >= 2 and batch_size % n_dp == 0:
            return (batch,) + (None,) * (x.ndim - 1)
        return (None,) * x.ndim

    return [spec(None, layer) for layer in cache]


# --- placement of tensors by spec (SPMD: one process a rank) -------------


def _coords(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_shard(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``: the block that
    ``jax.device_put(x, NamedSharding(mesh, spec))`` places on the device
    at this rank's mesh coordinate (``init_device_mesh`` numbers ranks
    row-major over the mesh).  A dim over several axes splits major
    first.  A contiguous copy, so the full tensor can be freed."""
    sizes, coords = axis_sizes(mesh), _coords(mesh)
    out = full
    for dim, ax in enumerate(spec):
        n, idx = 1, 0
        for a in entry_axes(ax):
            n, idx = n * sizes[a], idx * sizes[a] + coords[a]
        if n > 1:
            if out.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(full.shape)} does "
                                 f"not split {n} ways ({spec})")
            step = out.shape[dim] // n
            out = out.narrow(dim, idx * step, step)
    return out.clone(memory_format=torch.contiguous_format)


# torch 2.13 renames these two (the old names warn); torch 2.11 has only
# the old names
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order
    (``x`` itself over a one-rank group: no collective)."""
    if dist.get_world_size(group) == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((dist.get_world_size(group) * front.shape[0],)
                          + front.shape[1:])
    _all_gather_single(out, front, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group,
                       op=dist.ReduceOp.SUM) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` reduced over the group
    (``op``): the inverse of :func:`all_gather_dim` for gradients (``x``
    itself over a one-rank group)."""
    if dist.get_world_size(group) == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // dist.get_world_size(group),)
                          + front.shape[1:])
    _reduce_scatter_single(out, front, op=op, group=group)
    return out.movedim(0, dim)


def all_to_all_dim(x: torch.Tensor, dim: int, send, recv,
                   group) -> torch.Tensor:
    """The uneven all-to-all along ``dim``: the first ``send[0]`` entries
    of ``x`` along ``dim`` go to group rank 0, the next ``send[1]`` to
    rank 1, and so on; returns what the ranks sent here, ``recv[s]``
    entries from rank ``s``, concatenated along ``dim`` in group-rank
    order (``x`` itself over a one-rank group).  Its inverse swaps
    ``send`` and ``recv``."""
    if dist.get_world_size(group) == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((sum(recv),) + front.shape[1:])
    dist.all_to_all_single(out, front, output_split_sizes=list(recv),
                           input_split_sizes=list(send), group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """``dist.all_reduce`` of ``x`` in place, skipped over a one-rank group:
    the reference's program has no collective over an axis of size 1."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=op, group=group)


def gather_full(shard: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The inverse of :func:`local_shard`: every rank's block put together
    (all-gathers over each sharded dim's axes, minor axis first).  A
    collective: every rank of ``mesh`` calls it.  No autograd; a new
    tensor, which later in-place updates of ``shard`` do not reach."""
    out = shard.detach().clone(memory_format=torch.contiguous_format)
    for dim, ax in enumerate(spec):
        for a in reversed(entry_axes(ax)):
            out = all_gather_dim(out, dim, mesh.get_group(a))
    return out.contiguous()
