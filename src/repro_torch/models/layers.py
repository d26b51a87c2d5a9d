"""Core transformer sublayers (port of ``repro.models.layers``, dense path).

Weights live in small :class:`torch.nn.Module` containers (:class:`RMSNorm`,
:class:`Attention`, :class:`MLP`) whose attributes carry the reference's
parameter names and its (d_in, d_out) layout, so ``x @ w`` is the same
product.  The math is in plain functions over tensors that take such a
module where the reference takes its parameter dict, with the reference's
signatures.  Parameters are created with ``requires_grad=False``; the
train step (:func:`repro_torch.train_lib.make_train_step`) makes a
model's parameters trainable.

Attention over a full sequence is blockwise over query and key chunks
with a running max and denominator (:func:`flash_attention`), or the
flash-attention kernel K5 when ``cfg.use_pallas_attention`` is set (K5
has no backward, so training takes the blockwise version).  The
reference's ``fsdp_gather`` sites stay (:func:`.act_sharding.fsdp_gather`,
the identity: the sharded step gathers a block's weights whole).
Decode over a sequence-sharded cache (``kv_seq_axis``) is split-KV: each
rank attends over its slice, and the partial softmax terms combine over
the axis's process group.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.act_sharding import fsdp_gather, get_mesh

__all__ = ["RMSNorm", "Attention", "MLP", "dense_init", "rms_norm", "rope",
           "flash_attention", "attn_apply", "attn_decode", "mlp_apply",
           "NEG_INF"]

NEG_INF = -1e30


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init(w: torch.Tensor, generator: torch.Generator,
               scale: Optional[float] = None) -> None:
    """Fill a (d_in, d_out) weight with normal * ``scale`` (default
    1/sqrt(d_in)), drawn in fp32 and cast, as the reference does."""
    scale = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
    z = torch.randn(w.shape, generator=generator, device=w.device,
                    dtype=torch.float32)
    w.copy_(z * scale)


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


class RMSNorm(nn.Module):
    """scale (dim,), ones."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.scale = empty_param((dim,), dtype, device)
        self.scale.data.fill_(1.0)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half * math.log(theta))
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise attention (prefill), the plain twin of the kernel path
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, groups: int):
    # (B, S, KV, hd) -> (B, S, KV*groups, hd)
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def flash_attention(q, k, v, causal: bool, q_offset: int = 0,
                    chunk_q: int = 1024, chunk_kv: int = 1024):
    """Blockwise softmax attention that never holds more than
    (B, H, chunk_q, chunk_kv) scores.  q: (B, Sq, H, hd); k, v:
    (B, Skv, H, hd) (kv already repeated to H).  ``q_offset`` is the
    absolute position of q[0] (prefill resume)."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    cq = min(chunk_q, Sq)
    ck = min(chunk_kv, Skv)
    pq, pk = (-Sq) % cq, (-Skv) % ck
    # (B, S, H, hd) -> (B, H, S, hd), padded to whole chunks
    qp = F.pad(q.transpose(1, 2), (0, 0, 0, pq))
    kp = F.pad(k.transpose(1, 2), (0, 0, 0, pk))
    vp = F.pad(v.transpose(1, 2), (0, 0, 0, pk)).float()
    nq, nk = qp.shape[2] // cq, kp.shape[2] // ck
    out = torch.empty((B, H, nq * cq, hd), dtype=torch.float32,
                      device=q.device)
    for iq in range(nq):
        qi = qp[:, :, iq * cq:(iq + 1) * cq].float()
        q_pos = q_offset + iq * cq + torch.arange(cq, device=q.device)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32,
                          device=q.device)
        for ik in range(nk):
            ki = kp[:, :, ik * ck:(ik + 1) * ck].float()
            vi = vp[:, :, ik * ck:(ik + 1) * ck]
            s = (qi @ ki.transpose(-1, -2)) * scale
            k_pos = ik * ck + torch.arange(ck, device=q.device)
            mask = (k_pos >= Skv)[None, :]
            if causal:
                mask = mask | (k_pos[None, :] > q_pos[:, None])
            s = s.masked_fill(mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vi
            m = m_new
        out[:, :, iq * cq:(iq + 1) * cq] = acc / torch.clamp(
            l[..., None], min=1e-30)
    return out[:, :, :Sq].transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# attention sublayer
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """wq (D, H*hd), wk/wv (D, KV*hd), wo (H*hd, D); q_scale/k_scale (hd,)
    under ``cfg.qk_norm``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.resolved_head_dim
        d, q_width, kv_width = (cfg.d_model, cfg.n_heads * hd,
                                cfg.n_kv_heads * hd)
        self.wq = empty_param((d, q_width), dtype, device)
        self.wk = empty_param((d, kv_width), dtype, device)
        self.wv = empty_param((d, kv_width), dtype, device)
        self.wo = empty_param((q_width, d), dtype, device)
        if cfg.qk_norm:
            self.q_scale = empty_param((hd,), dtype, device)
            self.k_scale = empty_param((hd,), dtype, device)

    def init_params(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        dense_init(self.wq, generator)
        dense_init(self.wk, generator)
        dense_init(self.wv, generator)
        dense_init(self.wo, generator,
                   scale=1.0 / math.sqrt(cfg.n_heads * hd))
        if cfg.qk_norm:
            self.q_scale.data.fill_(1.0)
            self.k_scale.data.fill_(1.0)


def _qkv(p: Attention, cfg: ModelConfig, x, kv_x=None):
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    q = (x @ fsdp_gather(p.wq, -1)).reshape(B, S, cfg.n_heads, hd)
    k = (kv_x @ fsdp_gather(p.wk, -1)).reshape(B, Skv, cfg.n_kv_heads, hd)
    v = (kv_x @ fsdp_gather(p.wv, -1)).reshape(B, Skv, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_scale, cfg.rms_eps)
        k = rms_norm(k, p.k_scale, cfg.rms_eps)
    return q, k, v


def attn_apply(p: Attention, cfg: ModelConfig, x, *, causal: bool = True,
               positions=None, kv_x=None, use_rope: bool = True,
               chunk_q: int = 1024, chunk_kv: int = 1024):
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, kv_x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        kv_pos = torch.arange(k.shape[1], device=x.device)[None, :]
        k = rope(k, kv_pos, cfg.rope_theta)
    groups = cfg.n_heads // cfg.n_kv_heads
    if cfg.use_pallas_attention:
        from repro_torch.kernels import ops as _kops

        out = _kops.flash_attention(
            q, _repeat_kv(k, groups), _repeat_kv(v, groups),
            causal=causal and kv_x is None,
            block_q=chunk_q, block_kv=chunk_kv)
    else:
        out = flash_attention(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                              causal=causal and kv_x is None,
                              chunk_q=chunk_q, chunk_kv=chunk_kv)
    out = out.reshape(B, S, -1) @ fsdp_gather(p.wo, 0)
    return out, (k, v)


def attn_decode(p: Attention, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                use_rope: bool = True, update_cache: bool = True,
                kv_seq_axis: Optional[str] = None):
    """Single-token decode.  x: (B, 1, D); cache_*: (B, S_max, KV, hd).

    ``pos``: int (or 0-d tensor) — the current position; the new K/V are
    written at ``pos`` clamped into the cache, as ``dynamic_update_slice``
    clamps.  The caches are updated in place (the reference returns new
    arrays) and returned.

    ``kv_seq_axis``: the caches are this rank's slice of a cache split
    over that axis of the mesh set in :mod:`.act_sharding` (rank ``i``
    holding positions ``[i * S, (i + 1) * S)``), and attention runs as
    split-KV: each rank attends over its slice, then the partial
    ``(m, l, o)`` combine with one all-reduce MAX of ``m`` and one
    all-reduce SUM each of ``l`` and ``o`` rescaled to it.  Only the
    owning rank writes the new K/V, at ``pos`` less its slice's start
    (the reference writes at the global ``pos`` clamped into every
    rank's slice)."""
    pos = int(pos)
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x)
    if use_rope:
        ppos = torch.full((B, 1), pos, device=x.device)
        q = rope(q, ppos, cfg.rope_theta)
        k_new = rope(k_new, ppos, cfg.rope_theta)
    shard, idx, n_shards, group = cache_k.shape[1], 0, 1, None
    if kv_seq_axis is not None:
        if get_mesh() is None:
            raise ValueError(f"kv_seq_axis={kv_seq_axis!r} needs a mesh "
                             f"(act_sharding.set_batch_axes(..., mesh))")
        group = get_mesh().get_group(kv_seq_axis)
        idx, n_shards = dist.get_rank(group), dist.get_world_size(group)
    pos_base = idx * shard
    if update_cache:
        at = min(max(pos, 0), n_shards * shard - 1) - pos_base
        if 0 <= at < shard:
            cache_k[:, at:at + 1] = k_new.to(cache_k.dtype)
            cache_v[:, at:at + 1] = v_new.to(cache_v.dtype)
    groups = cfg.n_heads // cfg.n_kv_heads
    # grouped attention over the local cache, without repeating it
    Bq, Sq, H, _ = q.shape
    kv = cache_k.shape[2]
    qg = q.reshape(Bq, Sq, kv, groups, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     cache_k.float()) / math.sqrt(hd)
    k_pos = pos_base + torch.arange(shard, device=x.device)
    s = s.masked_fill((k_pos > pos)[None, None, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", e, cache_v.float())
    l = l.reshape(Bq, H, Sq)
    o = o.reshape(Bq, H, Sq, hd)
    if group is not None:
        m = m.reshape(Bq, H, Sq)
        g_m = m.clone()
        dist.all_reduce(g_m, op=dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m - g_m)
        l = l * corr
        o = o * corr[..., None]
        dist.all_reduce(l, group=group)
        dist.all_reduce(o, group=group)
    out = o / torch.clamp(l[..., None], min=1e-30)
    out = out.transpose(1, 2).reshape(B, 1, -1).to(x.dtype) @ p.wo
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """wi (D, d_ff), wd (d_ff, D), and wg (D, d_ff) for the gated acts."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 d_ff: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        d_ff = d_ff or cfg.d_ff
        self.wi = empty_param((cfg.d_model, d_ff), dtype, device)
        self.wd = empty_param((d_ff, cfg.d_model), dtype, device)
        if cfg.act not in ("relu2", "gelu_plain"):  # gated variants
            self.wg = empty_param((cfg.d_model, d_ff), dtype, device)

    def init_params(self, generator: torch.Generator) -> None:
        dense_init(self.wi, generator)
        dense_init(self.wd, generator)
        if hasattr(self, "wg"):
            dense_init(self.wg, generator)


def mlp_apply(p: MLP, cfg: ModelConfig, x):
    h = x @ fsdp_gather(p.wi, -1)
    if cfg.act == "relu2":  # nemotron squared-ReLU, non-gated
        h = torch.square(F.relu(h))
    elif cfg.act == "gelu_plain":  # whisper-style, non-gated
        h = F.gelu(h, approximate="tanh")
    elif cfg.act == "gelu":  # GeGLU (grok)
        h = F.gelu(h, approximate="tanh") * (x @ fsdp_gather(p.wg, -1))
    else:  # SwiGLU
        h = F.silu(h) * (x @ fsdp_gather(p.wg, -1))
    return h @ fsdp_gather(p.wd, 0)
