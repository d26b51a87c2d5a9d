"""Train, prefill and decode step factories (port of ``repro.train_lib``).

Each factory takes the config and returns a step over a
:class:`~repro_torch.models.transformer.Transformer`; the config passed
here, not the model's own, decides the path (``use_pallas_attention``
routes prefill attention through kernel K5).  Prefill and decode steps
run under :func:`torch.inference_mode`.

The train step takes the model, the optimizer state of
:func:`repro_torch.optim.init_opt_state` over its named parameters and a
batch, and updates the model in place: autograd of the chunked loss
(``torch.autograd.grad``, so no ``.grad`` is left behind), then AdamW.
It makes the model's parameters trainable (``requires_grad_``) and runs
with fp32 matmuls at full precision (TF32 off).  K5 has no backward, so
a config with ``use_pallas_attention`` is refused.

:func:`make_compressed_ddp_step` is the data-parallel step whose gradient
all-reduce is int8 (:func:`repro_torch.optim.compressed_psum`) over a
``torch.distributed`` group.  :func:`shard_train_step`,
:func:`shard_prefill_step` and :func:`shard_decode_step` are the train,
prefill and decode steps on a (data, model) mesh, SPMD over its ranks:
:func:`shard_model` stores each parameter by its spec
(:mod:`repro_torch.sharding`; :func:`serving_config` gives the
reference's serving policy), the model gathers each block over the batch
axes where it runs and splits its dense sublayers over `model`, and
:func:`gather_state` / :func:`load_state` move a sharded state to full
tensors and back.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch import optim as O
from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig
from repro_torch.models import act_sharding as AS
from repro_torch.models import transformer as T

__all__ = ["AUX_WEIGHT", "LOSS_CHUNK", "chunked_ce", "loss_fn",
           "value_and_grad", "full_precision", "make_train_step",
           "make_prefill_step", "make_decode_step",
           "make_compressed_ddp_step", "init_error_feedback",
           "shard_model", "gather_state", "load_state", "shard_train_step",
           "serving_config", "shard_prefill_step", "shard_decode_step"]

AUX_WEIGHT = 0.01  # load-balancing loss weight
LOSS_CHUNK = 512   # sequence-chunked cross-entropy (bounds fp32 logits)


def _chunk_nll(h, head, lab):
    """(sum of the chunk's token NLLs, its count of valid labels)."""
    logits = (h @ head).float()  # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1,
                       torch.clamp(lab, min=0).long()[..., None])[..., 0]
    valid = (lab >= 0).float()
    return ((lse - tgt) * valid).sum(), valid.sum()


class _VocabParallelNLL(torch.autograd.Function):
    """Each token's NLL from logits split over the vocab (this rank's
    columns from ``start``), as Megatron-LM's
    ``_VocabParallelCrossEntropy``: forward the local max, all-reduced
    MAX; the local sum of exp below it, all-reduced SUM; the target's
    logit where this rank holds it (zero elsewhere), all-reduced SUM.
    Backward: this rank's columns of softmax - one-hot, no collective."""

    @staticmethod
    def forward(ctx, logits, lab, start, group):
        ctx.dtype = logits.dtype
        logits = logits.float()
        m = logits.amax(dim=-1)
        SH.all_reduce(m, group, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        s = e.sum(dim=-1)
        SH.all_reduce(s, group)
        local = lab.long() - start
        inside = (local >= 0) & (local < logits.shape[-1])
        local = torch.where(inside, local, 0)
        tgt = torch.where(inside, torch.gather(logits, -1, local[..., None])[
            ..., 0], 0.0)
        SH.all_reduce(tgt, group)
        ctx.save_for_backward(e, s, local, inside)
        return torch.log(s) + m - tgt

    @staticmethod
    def backward(ctx, g):
        e, s, local, inside = ctx.saved_tensors
        grad = e / s[..., None]
        grad.scatter_add_(-1, local[..., None], -inside.float()[..., None])
        return (grad * g[..., None]).to(ctx.dtype), None, None, None


def _chunk_nll_split(h, head, lab, start: int, group):
    """:func:`_chunk_nll` on this rank's vocab columns ``head`` (D, V / m)
    from ``start``, over the `model` group ``group``."""
    nll = _VocabParallelNLL.apply(h @ head, lab, start, group)
    valid = (lab >= 0).float()
    return (nll * valid).sum(), valid.sum()


def chunked_ce(hidden, head, labels, chunk: int = LOSS_CHUNK,
               vocab_start: Optional[int] = None):
    """Cross-entropy without materializing (B, S, V) fp32 logits: one
    sequence chunk at a time, labels padded with -1 and masked.  Under
    grad each chunk runs under :func:`torch.utils.checkpoint.checkpoint`,
    so backward too holds one chunk's logits at a time, and its recompute
    issues the forward's collectives again, in the same order on every
    rank.

    ``vocab_start``: ``head`` is this rank's vocab columns from there,
    under a mesh whose `model` ranks hold the rest: the cross-entropy is
    vocab-parallel (:class:`_VocabParallelNLL`); ``hidden`` must come
    through :func:`~repro_torch.models.act_sharding.tp_copy`.  Over a
    one-rank `model` group the head is whole and nothing changes."""
    group = None if vocab_start is None else AS.model_group()
    nll_fn = _chunk_nll if group is None else (
        lambda h, w, lab: _chunk_nll_split(h, w, lab, vocab_start, group))
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S + pad, chunk):
        args = (hidden[:, lo:lo + chunk], head, labels[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            nll, n = checkpoint(nll_fn, *args, use_reentrant=False)
        else:
            nll, n = nll_fn(*args)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(model, cfg: ModelConfig, batch):
    """``(total, (loss, aux))``: the token cross-entropy plus
    ``AUX_WEIGHT`` times the MoE load-balancing loss."""
    hidden, aux = T.forward_hidden(model, cfg, batch["tokens"],
                                   frontend_embeds=batch.get("frontend"))
    start = T.vocab_start(model, cfg)
    if start is None:
        with T.gathered_head(model, cfg):
            loss = chunked_ce(hidden, T.unembed(model, cfg), batch["labels"])
    else:  # the vocab-parallel loss on this rank's columns
        loss = chunked_ce(AS.tp_copy(hidden), T.local_head(model, cfg),
                          batch["labels"], vocab_start=start)
    return loss + AUX_WEIGHT * aux, (loss, aux)


def value_and_grad(model, cfg: ModelConfig, batch) -> tuple:
    """``((total, (loss, aux)), grads)``, grads a dict over the model's
    named parameters (zeros for a parameter the loss does not reach, as
    ``jax.grad`` gives).  Makes the parameters trainable."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        total, (loss, aux) = loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return (total.detach(), (loss.detach(), aux.detach())), grads


@contextlib.contextmanager
def full_precision():
    """fp32 matmuls at full precision (TF32 off) inside, as the
    reference's fp32 products are; the setting is restored on exit."""
    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(was)


def _refuse_k5(cfg: ModelConfig) -> None:
    if cfg.use_pallas_attention:
        raise ValueError(
            f"{cfg.name}: use_pallas_attention=True routes attention "
            f"through K5, which has no backward; train with "
            f"use_pallas_attention=False")


def make_train_step(cfg: ModelConfig, oc: O.OptimizerConfig):
    """``(model, opt_state, batch) -> (opt_state, metrics)``; the model's
    parameters are updated in place.  Metrics: ``loss``, ``aux_loss``,
    ``total_loss``, ``lr``, ``grad_norm`` (0-d tensors)."""
    _refuse_k5(cfg)

    def train_step(model, opt_state, batch):
        with full_precision():
            (total, (loss, aux)), grads = value_and_grad(model, cfg, batch)
            opt_state, om = O.adamw_update(dict(model.named_parameters()),
                                           grads, opt_state, oc)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": total, **om}
        return opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """Inference prefill: ``(model, batch) -> logits`` for a full prompt
    batch (``batch["tokens"]``: (B, S) integer; ``batch["frontend"]``,
    where given: an enc-dec model's stub frame embeddings or a vlm's stub
    patch embeddings, passed to :func:`~repro_torch.models.transformer.
    forward` as ``frontend_embeds``)."""

    @torch.inference_mode()
    def prefill_step(model, batch):
        logits, _ = T.forward(model, cfg, batch["tokens"],
                              frontend_embeds=batch.get("frontend"))
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, kv_seq_axis: Optional[str] = None):
    """One-token greedy decode: ``(model, cache, token, pos[, cross_kv])
    -> (next_token (B, 1) int32, cache)``; ``cross_kv`` from
    :func:`~repro_torch.models.transformer.encode_cross_kv` (enc-dec)."""

    @torch.inference_mode()
    def decode_step(model, cache, token, pos, cross_kv=None):
        logits, cache = T.decode_step(model, cfg, cache, token, pos,
                                      cross_kv=cross_kv,
                                      kv_seq_axis=kv_seq_axis)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, cache

    return decode_step


def make_compressed_ddp_step(cfg: ModelConfig, oc: O.OptimizerConfig,
                             group=None):
    """Data-parallel train step whose gradient all-reduce is int8
    (error-feedback quantization, :func:`repro_torch.optim.
    compressed_psum`) over ``group`` (``None``: the default group, which
    must be initialised).

    Parameters are replicated: every rank holds the same model and
    optimizer state and passes its own slice of the global batch; each
    gradient is reduced at int8 width and the update runs identically on
    every rank.  Returns ``step(model, opt_state, err, batch) ->
    (opt_state, err, metrics)``: ``err`` is this rank's error-feedback
    residual per parameter (:func:`init_error_feedback`; the reference
    stacks every shard's on a leading axis), ``loss`` the mean over the
    ranks, ``aux_loss`` this rank's."""
    _refuse_k5(cfg)

    def step(model, opt_state, err, batch):
        with full_precision():
            (_, (loss, aux)), grads = value_and_grad(model, cfg, batch)
            reduced, err_new = {}, {}
            for k, g in grads.items():
                reduced[k], err_new[k] = O.compressed_psum(g, group, err[k])
            del grads
            opt_state, om = O.adamw_update(dict(model.named_parameters()),
                                           reduced, opt_state, oc)
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        loss = loss / dist.get_world_size(group)
        return opt_state, err_new, {"loss": loss, "aux_loss": aux, **om}

    return step


def init_error_feedback(model) -> dict:
    """This rank's error-feedback residuals: fp32 zeros per parameter."""
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# the sharded train step (SPMD over a (data, model) mesh)
# ---------------------------------------------------------------------------


def shard_model(model, cfg: ModelConfig, mesh) -> dict:
    """Store ``model`` by its specs for :func:`shard_train_step`, in place:
    each parameter becomes this rank's :func:`~repro_torch.sharding.
    local_shard` under its spec (:func:`~repro_torch.sharding.
    param_specs`, fitted to ``mesh``) and carries the spec as
    ``shard_spec``.  Every rank passes the same full weights.  Returns
    ``{name: spec}``."""
    specs = SH.param_specs(model, cfg, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = SH.local_shard(p.data, specs[name], mesh)
            p.shard_spec = specs[name]
    return specs


def gather_state(model, opt_state: dict, mesh) -> dict:
    """``{"params", "opt"}`` of a sharded model and its optimizer state as
    full tensors (the moments by their parameters' specs; a collective:
    every rank calls it and gets them all)."""
    specs = {name: p.shard_spec for name, p in model.named_parameters()}
    return {
        "params": {name: SH.gather_full(p, specs[name], mesh)
                   for name, p in model.named_parameters()},
        "opt": {"mu": {k: SH.gather_full(v, specs[k], mesh)
                       for k, v in opt_state["mu"].items()},
                "nu": {k: SH.gather_full(v, specs[k], mesh)
                       for k, v in opt_state["nu"].items()},
                "step": opt_state["step"]}}


@torch.no_grad()
def load_state(model, opt_state: dict, full: dict, mesh) -> dict:
    """Copy this rank's shards of a full ``{"params", "opt"}`` state (as
    :func:`gather_state` gives, or a checkpoint restores) into the sharded
    ``model`` and ``opt_state``.  Returns the optimizer state."""
    for name, p in model.named_parameters():
        p.copy_(SH.local_shard(full["params"][name], p.shard_spec, mesh))
        for m in ("mu", "nu"):
            opt_state[m][name].copy_(SH.local_shard(
                full["opt"][m][name], p.shard_spec, mesh))
    opt_state["step"] = full["opt"]["step"].to(opt_state["step"].device)
    return opt_state


def _global_norm(grads: dict, specs: dict, mesh) -> torch.Tensor:
    """The gradients' fp32 norm over unique elements: each shard's squared
    sum all-reduced over the axes its spec names only (a leaf replicated
    over an axis counts once, not once a rank)."""
    sums = {}
    for name, g in grads.items():
        axes = tuple(sorted({a for ax in specs[name]
                             for a in SH.entry_axes(ax)}))
        s = g.float().square().sum()
        sums[axes] = s if axes not in sums else sums[axes] + s
    total = 0.0
    for axes, s in sums.items():  # the same order on every rank
        for a in axes:
            SH.all_reduce(s, mesh.get_group(a))
        total = total + s
    return torch.sqrt(total)


def shard_train_step(cfg: ModelConfig, oc: O.OptimizerConfig, mesh):
    """The reference's ``jit`` with explicit in/out shardings over
    ``mesh``, SPMD: every rank of ``mesh`` calls ``step(model, opt_state,
    batch) -> (opt_state, metrics)``, the contract of
    :func:`make_train_step`.

    * ``model`` is stored by spec (:func:`shard_model`); ``opt_state`` is
      :func:`repro_torch.optim.init_opt_state` over its parameters, so the
      moments take the same specs and ``step`` is replicated.
    * ``batch`` is the global batch, the same on every rank: each rank
      takes its slice over the batch axes (which must divide it).
    * The model gathers each block's weights where it runs, inside its
      remat checkpoint, and the final norm where it is used; attention,
      the MLP, mamba and the xLSTM mixers keep their `model` split and run
      on this rank's slice, and so do the embedding, the head and the
      loss on this rank's vocab slice (a vocab-parallel cross-entropy);
      the MoE branch gathers its expert weights and router over `data`
      itself (:mod:`repro_torch.models.act_sharding`).
    * The other compute (norms, a sublayer whose heads or vocab do not
      split) is replicated over `model`; the gathers' backward reduces
      each gradient to this rank's shard, averaged over `data` (each data
      rank's loss is the mean over its own shard).
    * The clip norm counts unique elements; AdamW, elementwise, runs on
      the shards.  ``loss`` and ``aux_loss`` are averaged over the batch
      axes, ``grad_norm`` is the global norm.

    K5 has no backward, so a config with ``use_pallas_attention`` is
    refused, as :func:`make_train_step` refuses it."""
    _refuse_k5(cfg)
    axes = SH.batch_axes(mesh)
    n_dp = SH.dp_size(mesh)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        specs = _sharded_specs(model, "shard_train_step")
        if batch["tokens"].shape[0] % n_dp:
            raise ValueError(f"a batch of {batch['tokens'].shape[0]} does "
                             f"not split over {n_dp} data ranks")
        local = _local_batch(batch, mesh)
        with AS.meshed(axes, mesh), full_precision():
            (_, (loss, aux)), grads = value_and_grad(model, cfg, local)
            norm = _global_norm(grads, specs, mesh)
            opt_state, om = O.adamw_update(params, grads, opt_state, oc,
                                           norm)
        del grads
        for t in (loss, aux):
            for a in axes:
                SH.all_reduce(t, mesh.get_group(a), dist.ReduceOp.AVG)
        metrics = {"loss": loss, "aux_loss": aux,
                   "total_loss": loss + AUX_WEIGHT * aux, **om}
        return opt_state, metrics

    return train_step


def _sharded_specs(model, what: str) -> dict:
    """``{name: shard_spec}`` of a model stored by :func:`shard_model`."""
    specs = {name: getattr(p, "shard_spec", None)
             for name, p in model.named_parameters()}
    if any(spec is None for spec in specs.values()):
        raise ValueError(f"{what} takes a sharded model: call "
                         f"shard_model(model, cfg, mesh) first")
    return specs


def _local_batch(batch: dict, mesh) -> dict:
    """This rank's block of each batch tensor under
    :func:`~repro_torch.sharding.data_specs` (a batch the data ranks do
    not split is replicated)."""
    return {k: SH.local_shard(v, spec, mesh) for (k, v), spec in zip(
        batch.items(), SH.data_specs(mesh, batch).values())}


SERVING_RESIDENT_BYTES = 10e9  # bf16 weights a `model` rank keeps resident


def serving_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """The reference's serving parameter policy for decode: where the
    bf16 weights split over `model` alone stay under
    ``SERVING_RESIDENT_BYTES`` a rank, ``fsdp=False`` (the weights stay
    resident, no per-step gather over `data`); ``cfg`` otherwise.  Store
    the model by the result (``shard_model(model, serving_config(cfg,
    mesh), mesh)``)."""
    if cfg.params_count() * 2 / SH.model_size(mesh) < SERVING_RESIDENT_BYTES:
        return dataclasses.replace(cfg, fsdp=False)
    return cfg


def shard_prefill_step(cfg: ModelConfig, mesh):
    """The reference's ``jit`` of :func:`make_prefill_step` with explicit
    shardings over ``mesh``, SPMD: every rank calls ``step(model, batch) ->
    logits`` on a model stored by :func:`shard_model`, with the global
    batch; it returns this rank's block of the logits as the reference's
    output lays them out: its batch shard (B / dp; a batch the data ranks
    do not split: all of it) and its vocab shard (V / m; the whole vocab
    where `model` does not divide it).  Every split layer runs on the
    rank's `model` slice."""
    axes = SH.batch_axes(mesh)

    @torch.inference_mode()
    def prefill_step(model, batch):
        _sharded_specs(model, "shard_prefill_step")
        local = _local_batch(batch, mesh)
        with AS.meshed(axes, mesh):
            logits, _ = T.forward(model, cfg, local["tokens"],
                                  frontend_embeds=local.get("frontend"))
        return logits

    return prefill_step


def shard_decode_step(cfg: ModelConfig, mesh):
    """The reference's ``jit`` of :func:`make_decode_step` with explicit
    shardings over ``mesh``, SPMD: ``step(model, cache, token, pos[,
    cross_kv]) -> (next_token, cache)`` on a model stored by
    :func:`shard_model` (:func:`serving_config` gives the reference's
    policy), with the global ``token`` (B, 1) and this rank's block of the
    cache (``init_cache(..., mesh=mesh)`` for the global B).  Attention is
    split-KV over the cache's sequence split: `model` where the data ranks
    split the batch, every axis otherwise (the batch replicated), as
    :func:`~repro_torch.sharding.cache_specs` lays it out.  ``cross_kv``
    (enc-dec) is whole, its batch split as the token's.  Returns this
    rank's batch shard of the next tokens: over a vocab split over
    `model`, the largest of the ranks' (max, argmax) gathered over
    `model` (:func:`_vocab_argmax`)."""
    axes = SH.batch_axes(mesh)
    n_dp = SH.dp_size(mesh)

    @torch.inference_mode()
    def decode_step(model, cache, token, pos, cross_kv=None):
        _sharded_specs(model, "shard_decode_step")
        split = token.shape[0] % n_dp == 0
        kv_axis = "model" if split else axes + ("model",)
        local = _local_batch({"token": token}, mesh)["token"]
        if cross_kv is not None:
            cross_kv = [_local_batch(c, mesh) for c in cross_kv]
        with AS.meshed(axes, mesh):
            logits, cache = T.decode_step(model, cfg, cache, local, pos,
                                          cross_kv=cross_kv,
                                          kv_seq_axis=kv_axis)
            nxt = _vocab_argmax(logits[:, -1:], T.vocab_start(model, cfg))
        return nxt.to(torch.int32), cache

    return decode_step


def _vocab_argmax(logits, start: Optional[int]):
    """The vocab index of the largest of ``logits`` (..., V'), this rank's
    vocab columns from ``start`` (None: the whole vocab).  Split over
    `model`: each rank's (max, argmax) gathered over `model` (one gather
    of the pairs in fp64, where both are exact) and the largest kept; on
    a tie the lowest vocab index, as ``torch.argmax`` and ``jnp.argmax``
    give (the lowest rank's, and within a rank the first)."""
    idx = torch.argmax(logits, dim=-1)
    group = None if start is None else AS.model_group()
    if group is None:
        return idx
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    pair = torch.stack([val.double(), (idx + start).double()], dim=-1)
    every = SH.all_gather_dim(pair[None], 0, group)  # (m, ..., 2)
    best = torch.argmax(every[..., 0], dim=0)
    return torch.gather(every[..., 1], 0, best[None])[0].long()
