"""Optimizer substrate: AdamW with dtype-tapered moments, cosine schedule,
global-norm clipping, and int8-compressed gradient all-reduce (port of
``repro.optim``).

Parameters are a model's ``named_parameters()`` as a dict, and optimizer
state is ``{"mu": {name: tensor}, "nu": {name: tensor}, "step": 0-d
int32}``, keyed the same way.  :func:`adamw_update` writes the new
parameters and moments into their tensors (the reference returns new
trees).

* Moments can be stored in bf16 (``moment_dtype``): store narrow,
  update in fp32.
* Every scalar of the update (the learning rate, the bias corrections
  ``1 - b**step``) is an fp32 tensor, as in the reference, never a
  Python float64.  Weight decay applies to every parameter, norms and
  embeddings too: the reference has no parameter groups.
* The update holds no matmul; the train step that calls it keeps fp32
  matmuls at full precision (TF32 off, ``train_lib.full_precision``).
* :func:`compressed_psum` is the int8 gradient reduction with error
  feedback over a ``torch.distributed`` process group (the reference's
  runs inside ``shard_map`` over a mesh axis): one all-reduce MAX for
  the shared scale, the int8 payload summed as int32, and the residual
  kept on the rank.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = ["OptimizerConfig", "cosine_lr", "init_opt_state",
           "clip_by_global_norm", "adamw_update", "quantize_int8",
           "compressed_psum"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # or "bfloat16" for the huge cells
    min_lr_ratio: float = 0.1


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cosine_lr(step, oc: OptimizerConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; an fp32 0-d
    tensor on ``step``'s device (``step``: a number or an integer
    tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - oc.warmup_steps)
                    / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return oc.lr * warm * (oc.min_lr_ratio + (1 - oc.min_lr_ratio) * cos)


def init_opt_state(params: dict, oc: OptimizerConfig) -> dict:
    """Zero moments in ``oc.moment_dtype`` beside each parameter, and step
    0 (an int32 0-d tensor on the parameters' device)."""
    dt = _MOMENT_DTYPES[oc.moment_dtype]
    params = dict(params)
    device = next(iter(params.values())).device if params else None
    return {
        "mu": {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
        "nu": {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def clip_by_global_norm(grads: dict, max_norm: float, norm=None) -> tuple:
    """``(grads scaled so their global fp32 norm is at most max_norm, in
    their own dtypes; the norm before clipping)``.  ``norm``: the norm,
    where the caller counts it (a sharded step's spans every rank's
    shards); by default that of ``grads``."""
    if norm is None:
        norm = torch.sqrt(sum(g.float().square().sum()
                              for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict,
                 oc: OptimizerConfig, norm=None) -> tuple:
    """One AdamW step.  Moments stored in ``oc.moment_dtype`` but updated
    in fp32 (store narrow, accumulate wide).  ``params`` and the moments
    are updated in place; returns ``(state, metrics)``: the state with
    the new step, metrics ``{"lr", "grad_norm"}``.  ``norm``: the
    gradients' global norm for clipping, where the caller counts it
    (:func:`clip_by_global_norm`)."""
    grads, gnorm = clip_by_global_norm(grads, oc.grad_clip, norm)
    step = state["step"] + 1
    lr = cosine_lr(step, oc)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - b1 ** step.float()  # fp32 tensors, as the reference's
    bc2 = 1 - b2 ** step.float()
    for k, p in params.items():
        g32 = grads[k].float()
        mu, nu = state["mu"][k], state["nu"][k]
        mu32 = b1 * mu.float() + (1 - b1) * g32
        nu32 = b2 * nu.float() + (1 - b2) * torch.square(g32)
        mhat = mu32 / bc1
        nhat = nu32 / bc2
        delta = mhat / (torch.sqrt(nhat) + oc.eps) + oc.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        mu.copy_(mu32)
        nu.copy_(nu32)
    state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------


def quantize_int8(g: torch.Tensor, scale: torch.Tensor) -> tuple:
    """Symmetric int8 quantization at a given (shared) scale.  Returns
    ``(q int8, q dequantized to fp32)``; ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, q.float() * scale


def compressed_psum(g: torch.Tensor, group=None, err=None) -> tuple:
    """Mean all-reduce over ``group`` whose bulk payload is the int8
    quantization of ``g`` (plus ``err``, the residual carried from the
    last step), at a scale shared across the group (one scalar all-reduce
    MAX), so the int32 sum is exact w.r.t. the quantized values.  Returns
    ``(mean fp32, new residual)``.  ``group``: a process group (``None``:
    the default group, which must be initialised)."""
    g32 = g.float()
    if err is not None:
        g32 = g32 + err
    gmax = torch.amax(torch.abs(g32))
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    q, deq = quantize_int8(g32, scale)
    new_err = g32 - deq  # error feedback carries to the next step
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return total.float() * scale / n, new_err
