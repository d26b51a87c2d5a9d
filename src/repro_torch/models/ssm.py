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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.models import layers as L

__all__ = ["Mamba", "mamba_apply", "mamba_init_cache", "mamba_decode"]


def _dims(cfg: ModelConfig):
    m = cfg.mamba or MambaConfig()
    d_in = m.expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return m, d_in, dt_rank


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


def _ssm_params(p: Mamba, cfg: ModelConfig, xc):
    """xc: (B, L, d_in) -> (a, bx, Cs) of the recurrence, all fp32 (the
    selective scan is numerically sensitive; outputs cast back on exit)."""
    m, d_in, dt_rank = _dims(cfg)
    proj = xc @ p.x_proj  # (B, L, R + 2N)
    dt, Bs, Cs = torch.split(proj, [dt_rank, m.d_state, m.d_state], dim=-1)
    # the product and bias in the model's dtype, then fp32, as the
    # reference casts.  F.softplus returns x itself above its threshold of
    # 20 where jax.nn.softplus is logaddexp(x, 0): under 2e-9 relative.
    dt = F.softplus((dt @ p.dt_proj + p.dt_bias).float())
    A = -torch.exp(p.a_log)  # (d_in, N) fp32
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
    m, d_in, _ = _dims(cfg)
    B, S, _ = x.shape
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    xc, _ = _causal_conv(xin, p.conv_w, p.conv_b)
    xc = F.silu(xc)

    # the reference pads the sequence to whole chunks; the scan is causal,
    # so a short last chunk gives the same first S outputs
    chunk = min(m.chunk, S)
    h = torch.zeros((B, d_in, m.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for lo in range(0, S, chunk):
        a, bx, Cs = _ssm_params(p, cfg, xc[:, lo:lo + chunk])
        a_acc, b_acc = _linear_scan(a, bx)
        del a, bx
        hs = torch.addcmul(b_acc, a_acc, h[:, None])  # (B, L, d_in, N)
        del a_acc, b_acc
        ys.append((hs * Cs[:, :, None, :]).sum(-1))  # (B, L, d_in)
        h = hs[:, -1]
        del hs
    y = torch.cat(ys, dim=1) + xc.float() * p.d_skip
    y = y.to(x.dtype)
    return (y * F.silu(z)) @ p.out_proj


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
    """Single-token step.  x: (B, 1, D).  Returns (out, new cache)."""
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    xc, conv_cache = _causal_conv(xin, p.conv_w, p.conv_b, cache["conv"])
    xc = F.silu(xc)
    a, bx, Cs = _ssm_params(p, cfg, xc)
    h = a[:, 0] * cache["h"] + bx[:, 0]
    y = (h * Cs[:, 0, None, :]).sum(-1)[:, None]  # (B, 1, d_in) fp32
    y = (y + xc.float() * p.d_skip).to(x.dtype)
    out = (y * F.silu(z)) @ p.out_proj
    return out, {"conv": conv_cache, "h": h}
