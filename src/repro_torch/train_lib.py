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
``torch.distributed`` group.  :func:`shard_train_step` needs the LM's
sharding, which is not ported yet.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch import optim as O
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

__all__ = ["AUX_WEIGHT", "LOSS_CHUNK", "chunked_ce", "loss_fn",
           "value_and_grad", "full_precision", "make_train_step",
           "make_prefill_step", "make_decode_step",
           "make_compressed_ddp_step", "init_error_feedback",
           "shard_train_step"]

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


def chunked_ce(hidden, head, labels, chunk: int = LOSS_CHUNK):
    """Cross-entropy without materializing (B, S, V) fp32 logits: one
    sequence chunk at a time, labels padded with -1 and masked.  Under
    grad each chunk runs under :func:`torch.utils.checkpoint.checkpoint`,
    so backward too holds one chunk's logits at a time."""
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
            nll, n = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            nll, n = _chunk_nll(*args)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(model, cfg: ModelConfig, batch):
    """``(total, (loss, aux))``: the token cross-entropy plus
    ``AUX_WEIGHT`` times the MoE load-balancing loss."""
    hidden, aux = T.forward_hidden(model, cfg, batch["tokens"],
                                   frontend_embeds=batch.get("frontend"))
    loss = chunked_ce(hidden, T.unembed(model, cfg), batch["labels"])
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


def shard_train_step(*args, **kwargs):
    """The reference's jit with explicit in/out shardings for a
    production mesh: needs the LM's sharding (``sharding.py``), which the
    port does not have yet."""
    raise NotImplementedError(
        "shard_train_step needs the LM's sharding, not ported yet (ROADMAP "
        "queue 1: the LM's sharding slice)")
