"""Mamba selective-SSM block, jamba's sub-quadratic mixer (port of
``repro.models.ssm``).

Prefill runs a *chunked scan* of the linear recurrence ``h_t = a_t *
h_{t-1} + b_t``: within a chunk of ``cfg.mamba.chunk`` tokens a log-depth
(Hillis-Steele) inclusive scan composes ``(a, b)`` pairs with the
reference's combine ``(al * ar, ar * bl + br)``, and a loop over chunks
carries ``h`` in fp32, so the (B, L, d_inner, N) tensors of the
recurrence exist one chunk at a time.  ``lax.associative_scan`` composes
in another order, so fp32 results differ in rounding only.  Decode is
the O(1)-per-token step on a (conv window, ssm state) cache.

The math runs on plain torch ops: there is no TPU kernel on this path
(the reference runs ``jnp`` ops too).

Under a mesh (:mod:`.act_sharding`), for a model stored by spec, the
mixer runs on this rank's d_inner / m channels, as the reference's specs
split them: ``in_proj``'s columns, ``conv_w``, ``conv_b``, ``dt_proj``,
``dt_bias``, ``a_log`` and ``d_skip`` over d_inner, ``x_proj`` and
``out_proj`` by rows.  ``in_proj`` is stored as the reference lays it
out, ``[x | z]`` split contiguously over `model` (on 2 ranks, rank 0
holds all of x and rank 1 all of z), so its product runs on the stored
columns and one uneven all-to-all over `model` brings each rank the x
and z of its own channels (backward: the inverse all-to-all).  The conv,
``dt_proj``, the scan, ``d_skip`` and the gate then run on the local
channels; ``x_proj``'s partial (R + 2N) output is summed over `model`
and, read by every rank's channels, sums its gradient there too;
``out_proj``'s output is summed.  Decode keeps the cache as
``cache_specs`` lays it out (whole over `model`): each rank steps its
channels' conv window and scan state and gathers them back whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as SH
from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.act_sharding import (all_to_all_model, fsdp_gather,
                                             gather_model, get_mesh,
                                             model_rank, model_size,
                                             tp_copy, tp_names, tp_sum)

__all__ = ["Mamba", "mamba_apply", "mamba_init_cache", "mamba_decode"]


def _dims(cfg: ModelConfig):
    m = cfg.mamba or MambaConfig()
    d_in = m.expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return m, d_in, dt_rank


# each weight's dim split over `model` under the reference's specs
_TP_DIMS = {"in_proj": -1, "conv_w": -1, "conv_b": 0, "x_proj": 0,
            "dt_proj": -1, "dt_bias": 0, "a_log": 0, "d_skip": 0,
            "out_proj": 0}


class Mamba(nn.Module):
    """in_proj (D, 2 d_in), conv_w (d_conv, d_in), conv_b (d_in,), x_proj
    (d_in, R + 2N), dt_proj (R, d_in), dt_bias (d_in,), out_proj (d_in,
    D) in the model's dtype; a_log (d_in, N) and d_skip (d_in,) in fp32
    whatever the model's dtype, as the reference keeps them."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        m, d_in, dt_rank = _dims(cfg)
        D = cfg.d_model
        self.in_proj = L.empty_param((D, 2 * d_in), dtype, device)
        self.conv_w = L.empty_param((m.d_conv, d_in), dtype, device)
        self.conv_b = L.empty_param((d_in,), dtype, device)
        self.x_proj = L.empty_param((d_in, dt_rank + 2 * m.d_state), dtype,
                                    device)
        self.dt_proj = L.empty_param((dt_rank, d_in), dtype, device)
        self.dt_bias = L.empty_param((d_in,), dtype, device)
        self.a_log = L.empty_param((d_in, m.d_state), torch.float32, device)
        self.d_skip = L.empty_param((d_in,), torch.float32, device)
        self.out_proj = L.empty_param((d_in, D), dtype, device)

    def init_params(self, generator: torch.Generator) -> None:
        """Dense weights normal / sqrt(d_in), conv_w normal / sqrt(d_conv),
        zero biases, the S4D-real ``A = -[1..N]`` per channel, d_skip one."""
        L.dense_init(self.in_proj, generator)
        L.dense_init(self.conv_w, generator,
                     1.0 / math.sqrt(self.conv_w.shape[0]))
        self.conv_b.zero_()
        L.dense_init(self.x_proj, generator)
        L.dense_init(self.dt_proj, generator)
        self.dt_bias.zero_()
        n = torch.arange(1, self.a_log.shape[1] + 1, dtype=torch.float32,
                         device=self.a_log.device)
        self.a_log.copy_(torch.log(n).expand_as(self.a_log))
        self.d_skip.fill_(1.0)
        L.dense_init(self.out_proj, generator)

    def tp_weights(self) -> tuple:
        """The weights kept split over `model` while the mixer runs: all
        of them under a mesh, for a model stored by spec with each split
        over d_inner there (``_TP_DIMS``); none otherwise (gathered
        whole, compute replicated)."""
        if get_mesh() is None or not all(
                SH.names_model(getattr(getattr(self, n), "shard_spec", None),
                               d) for n, d in _TP_DIMS.items()):
            return ()
        return tuple(_TP_DIMS)


def _weights(p: Mamba) -> dict:
    """Each weight as the mixer uses it: on the `model` slice gathered
    over the batch axes only, else as it is (whole)."""
    return {n: fsdp_gather(getattr(p, n), d) for n, d in _TP_DIMS.items()}


def _in_proj_plan(d_in: int, m: int, r: int) -> tuple:
    """The all-to-all over `model` that gives rank ``r`` of ``m`` the x
    and z columns of its d_in / m channels from the stored columns of
    ``[x | z]`` (2 d_in / m contiguous ones a rank).  Returns (send,
    recv, order): ``send[t]`` columns go to rank t, ``recv[s]`` come from
    rank s, and ``order`` lists this rank's columns in the order they are
    sent, grouped by destination (ascending but where this rank's block
    crosses the x | z border, as it does for an odd m).  A rank receives
    its x and then its z, each ascending: in group-rank order the
    senders' columns ascend."""
    c, d = 2 * d_in // m, d_in // m

    def owned(lo, hi, t):  # the columns in [lo, hi) of rank t's channels
        return [(max(lo, a), min(hi, a + d)) for a in (t * d, d_in + t * d)
                if min(hi, a + d) > max(lo, a)]

    pieces = [owned(r * c, (r + 1) * c, t) for t in range(m)]
    send = [sum(b - a for a, b in ps) for ps in pieces]
    recv = [sum(b - a for a, b in owned(s * c, (s + 1) * c, r))
            for s in range(m)]
    order = [j - r * c for ps in pieces for a, b in ps for j in range(a, b)]
    return send, recv, order


def _in_proj(cfg: ModelConfig, x, w: dict, tp: bool):
    """(x, z) of ``in_proj`` (B, L, d) for this rank's channels: every
    channel unsharded; on the `model` slice the product on the stored
    columns, then the all-to-all of :func:`_in_proj_plan`."""
    if not tp:
        return (x @ w["in_proj"]).chunk(2, dim=-1)
    y = tp_copy(x) @ w["in_proj"]
    send, recv, order = _in_proj_plan(_dims(cfg)[1], model_size(),
                                      model_rank())
    if order != list(range(y.shape[-1])):
        y = y.index_select(-1, torch.tensor(order, device=y.device))
    return all_to_all_model(y, -1, send, recv).chunk(2, dim=-1)


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C); cache: (B, K-1, C).
    Returns (out, the last K-1 inputs)."""
    K = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = cache
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    new_cache = xp[:, -(K - 1):] if K > 1 else pad
    return out, new_cache


def _ssm_params(w: dict, cfg: ModelConfig, xc, tp: bool):
    """xc: (B, L, d) -> (a, bx, Cs) of the recurrence, all fp32 (the
    selective scan is numerically sensitive; outputs cast back on exit).
    On the `model` slice ``x_proj``'s row-parallel output is summed over
    `model`, and its gradient too (every rank's channels read it)."""
    m, d_in, dt_rank = _dims(cfg)
    proj = xc @ w["x_proj"]  # (B, L, R + 2N)
    if tp:
        proj = tp_copy(tp_sum(proj))
    dt, Bs, Cs = torch.split(proj, [dt_rank, m.d_state, m.d_state], dim=-1)
    # the product and bias in the model's dtype, then fp32, as the
    # reference casts.  F.softplus returns x itself above its threshold of
    # 20 where jax.nn.softplus is logaddexp(x, 0): under 2e-9 relative.
    dt = F.softplus((dt @ w["dt_proj"] + w["dt_bias"]).float())
    A = -torch.exp(w["a_log"])  # (d, N) fp32
    a = torch.exp(dt[..., None] * A)  # (B, L, d_in, N)
    bx = (dt * xc.float())[..., None] * Bs.float()[:, :, None, :]
    return a, bx, Cs.float()


def _linear_scan(a, b):
    """Inclusive scan along dim 1 of the pairs ``(a_t, b_t)`` under the
    combine ``(al, bl) . (ar, br) = (al * ar, ar * bl + br)`` (left is
    earlier): log2(L) Hillis-Steele passes.  Returns (a_acc, b_acc), so
    that ``h_t = a_acc_t * h_0 + b_acc_t``."""
    d, L_ = 1, a.shape[1]
    while d < L_:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])],
                      dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def mamba_apply(p: Mamba, cfg: ModelConfig, x):
    """x: (B, S, D) -> (B, S, D), chunked scan over the sequence."""
    if cfg.mamba is None:
        # the reference reads cfg.mamba.d_state here and fails without it
        raise ValueError(f"{cfg.name}: a mamba mixer needs cfg.mamba")
    m, _, _ = _dims(cfg)
    B, S, _ = x.shape
    w, tp = _weights(p), bool(tp_names(p))
    xin, z = _in_proj(cfg, x, w, tp)
    xc, _ = _causal_conv(xin, w["conv_w"], w["conv_b"])
    xc = F.silu(xc)

    # the reference pads the sequence to whole chunks; the scan is causal,
    # so a short last chunk gives the same first S outputs
    chunk = min(m.chunk, S)
    h = torch.zeros((B, xc.shape[-1], m.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for lo in range(0, S, chunk):
        a, bx, Cs = _ssm_params(w, cfg, xc[:, lo:lo + chunk], tp)
        a_acc, b_acc = _linear_scan(a, bx)
        del a, bx
        hs = torch.addcmul(b_acc, a_acc, h[:, None])  # (B, L, d_in, N)
        del a_acc, b_acc
        ys.append((hs * Cs[:, :, None, :]).sum(-1))  # (B, L, d_in)
        h = hs[:, -1]
        del hs
    y = torch.cat(ys, dim=1) + xc.float() * w["d_skip"]
    y = y.to(x.dtype)
    out = (y * F.silu(z)) @ w["out_proj"]
    return tp_sum(out) if tp else out


def mamba_init_cache(cfg: ModelConfig, B: int, dtype, device) -> dict:
    """The conv window in the model's dtype, the scan state in fp32."""
    m, d_in, _ = _dims(cfg)
    return {
        "conv": torch.zeros((B, m.d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "h": torch.zeros((B, d_in, m.d_state), dtype=torch.float32,
                         device=device),
    }


def mamba_decode(p: Mamba, cfg: ModelConfig, x, cache: dict):
    """Single-token step.  x: (B, 1, D).  Returns (out, new cache).  On
    the `model` slice the step runs on this rank's channels of the (whole)
    cache, and the new conv window and scan state are gathered back whole
    over `model`."""
    w, tp = _weights(p), bool(tp_names(p))
    xin, z = _in_proj(cfg, x, w, tp)
    conv, h = cache["conv"], cache["h"]
    if tp:
        d = xin.shape[-1]
        conv, h = (t.narrow(dim, model_rank() * d, d)
                   for t, dim in ((conv, -1), (h, 1)))
    xc, conv_cache = _causal_conv(xin, w["conv_w"], w["conv_b"], conv)
    xc = F.silu(xc)
    a, bx, Cs = _ssm_params(w, cfg, xc, tp)
    h = a[:, 0] * h + bx[:, 0]
    y = (h * Cs[:, 0, None, :]).sum(-1)[:, None]  # (B, 1, d) fp32
    y = (y + xc.float() * w["d_skip"]).to(x.dtype)
    out = (y * F.silu(z)) @ w["out_proj"]
    if tp:
        out = tp_sum(out)
        conv_cache, h = gather_model(conv_cache, -1), gather_model(h, 1)
    return out, {"conv": conv_cache, "h": h}
