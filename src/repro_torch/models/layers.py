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
has no backward, so training takes the blockwise version).  Decode over
a sequence-sharded cache (``kv_seq_axis``) is split-KV: each rank attends
over its slice, and the partial softmax terms combine over the axes'
process groups.

Tensor parallelism over `model` (the mesh set in :mod:`.act_sharding`,
a model stored by ``shard_model``): attention, cross-attention and the
MLP run on this rank's slice where their weights stay split
(``tp_weights()``), gathered over the batch axes at the reference's
``fsdp_gather`` sites.  q, k, v, ``wi`` and ``wg`` are column-parallel
behind :func:`.act_sharding.tp_copy`; ``wo`` and ``wd`` row-parallel
before :func:`.act_sharding.tp_sum`.  Attention splits when ``n_heads``
divides over `model`; its KV heads then take one of two paths:

* ``n_kv_heads`` divides too: each rank projects its own KV heads;
* otherwise (llama3.2-1b, qwen3-8b and the other 8-KV-head configs, and
  qwen3-moe's 4, on 16 x 16): k and v are projected on the stored
  `model` columns (half a head for llama3.2-1b), gathered over `model`,
  and each local q head picks its KV head.

Where ``n_heads`` does not divide (whisper-small's 12 heads on 16) the
layer is gathered whole and runs replicated.  The MLP splits when
``d_ff`` does (every config's on 16).  Decode projects on the slice,
gathers the new token's q, k, v whole over `model`, attends split-KV
over the cache's sequence split, and runs ``wo`` on its rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig
from repro_torch.models.act_sharding import (fsdp_gather, gather_model,
                                             get_mesh, mesh_sizes,
                                             model_rank, model_size,
                                             tp_copy, tp_names, tp_sum)

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

    def tp_weights(self) -> tuple:
        """The weights kept split over `model` while the sublayer runs
        (:func:`.act_sharding.gathered` leaves them): all four under a
        mesh whose `model` size divides ``n_heads``, for a model stored
        by spec with q's and k's columns split over `model`; none
        otherwise (gathered whole, compute replicated)."""
        if (get_mesh() is None
                or not SH.splits_heads(self.cfg.n_heads, mesh_sizes())
                or not all(SH.names_model(getattr(w, "shard_spec", None), -1)
                           for w in (self.wq, self.wk))):
            return ()
        return ("wq", "wk", "wv", "wo")


def _qkv(p: Attention, cfg: ModelConfig, x, kv_x=None, whole: bool = False):
    """q (B, S, Hq, hd) and k, v (B, Skv, Hk, hd), qk-normed.

    Unsharded (or gathered whole): every head.  On this rank's `model`
    slice: its ``n_heads / m`` q heads; k and v with its ``n_kv_heads /
    m`` KV heads where those divide, else gathered over `model` with each
    local q head's KV head picked (Hk = Hq).  ``whole``: q, k and v with
    every head, gathered over `model` (decode)."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    tp = bool(tp_names(p))
    if tp:
        x = tp_copy(x)
        kv_x = None if kv_x is None else tp_copy(kv_x)
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    q = x @ fsdp_gather(p.wq, -1)
    k, v = kv_x @ fsdp_gather(p.wk, -1), kv_x @ fsdp_gather(p.wv, -1)
    pick = None
    if tp:
        m = model_size()
        if whole or cfg.n_kv_heads % m:
            k, v = gather_model(k, -1), gather_model(v, -1)
            if whole:
                q = gather_model(q, -1)
            else:  # each local q head's KV head
                hl = cfg.n_heads // m
                pick = (model_rank() * hl + torch.arange(
                    hl, device=x.device)) // (cfg.n_heads // cfg.n_kv_heads)
    q = q.reshape(B, S, -1, hd)
    k, v = k.reshape(B, Skv, -1, hd), v.reshape(B, Skv, -1, hd)
    if pick is not None:
        k, v = k.index_select(2, pick), v.index_select(2, pick)
    if cfg.qk_norm:
        q_scale, k_scale = p.q_scale, p.k_scale
        if tp:  # each rank's heads give a part of their gradients
            q_scale, k_scale = tp_copy(q_scale), tp_copy(k_scale)
        q = rms_norm(q, q_scale, cfg.rms_eps)
        k = rms_norm(k, k_scale, cfg.rms_eps)
    return q, k, v


def attn_apply(p: Attention, cfg: ModelConfig, x, *, causal: bool = True,
               positions=None, kv_x=None, use_rope: bool = True,
               chunk_q: int = 1024, chunk_kv: int = 1024):
    """Full-sequence attention (prefill).  Returns (out, (k, v)): on a
    `model` slice, k and v are the local heads :func:`_qkv` gives."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, kv_x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        kv_pos = torch.arange(k.shape[1], device=x.device)[None, :]
        k = rope(k, kv_pos, cfg.rope_theta)
    groups = q.shape[2] // k.shape[2]
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
    return (tp_sum(out) if tp_names(p) else out), (k, v)


def attn_decode(p: Attention, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                use_rope: bool = True, update_cache: bool = True,
                kv_seq_axis=None):
    """Single-token decode.  x: (B, 1, D); cache_*: (B, S_max, KV, hd).

    ``pos``: int (or 0-d tensor) — the current position; the new K/V are
    written at ``pos`` clamped into the cache, as ``dynamic_update_slice``
    clamps.  The caches are updated in place (the reference returns new
    arrays) and returned.

    ``kv_seq_axis``: an axis of the mesh set in :mod:`.act_sharding`, or a
    tuple of them (major first, as :func:`~repro_torch.sharding.
    cache_specs` splits a tiny batch's cache over every axis): the caches
    are this rank's slice of a cache split over them (rank ``i`` holding
    positions ``[i * S, (i + 1) * S)``), and attention runs as split-KV:
    each rank attends over its slice, then the partial ``(m, l, o)``
    combine with an all-reduce MAX of ``m`` and an all-reduce SUM each of
    ``l`` and ``o`` rescaled to it, over each axis of more than one rank.
    Only the owning rank writes the new K/V, at ``pos`` less its slice's
    start (the reference writes at the global ``pos`` clamped into every
    rank's slice).

    On a `model` slice the new token's q, k and v are gathered whole
    before they attend, and ``wo`` runs on the slice's rows."""
    pos = int(pos)
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, whole=True)
    if use_rope:
        ppos = torch.full((B, 1), pos, device=x.device)
        q = rope(q, ppos, cfg.rope_theta)
        k_new = rope(k_new, ppos, cfg.rope_theta)
    shard, idx, n_shards, groups_kv = cache_k.shape[1], 0, 1, []
    if kv_seq_axis is not None:
        mesh = get_mesh()
        if mesh is None:
            raise ValueError(f"kv_seq_axis={kv_seq_axis!r} needs a mesh "
                             f"(act_sharding.set_batch_axes(..., mesh))")
        for a in SH.entry_axes(kv_seq_axis):
            group = mesh.get_group(a)
            n = dist.get_world_size(group)
            idx, n_shards = idx * n + dist.get_rank(group), n_shards * n
            if n > 1:
                groups_kv.append(group)
    pos_base = idx * shard
    if update_cache:
        at = min(max(pos, 0), n_shards * shard - 1) - pos_base
        if 0 <= at < shard:
            cache_k[:, at:at + 1] = k_new.to(cache_k.dtype)
            cache_v[:, at:at + 1] = v_new.to(cache_v.dtype)
    # grouped attention over the local cache, without repeating it
    Bq, Sq, H, _ = q.shape
    kv = cache_k.shape[2]
    qg = q.reshape(Bq, Sq, kv, H // kv, hd)
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
    if groups_kv:
        m = m.reshape(Bq, H, Sq)
        g_m = m.clone()
        for group in groups_kv:
            dist.all_reduce(g_m, op=dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m - g_m)
        l = l * corr
        o = o * corr[..., None]
        for group in groups_kv:
            dist.all_reduce(l, group=group)
            dist.all_reduce(o, group=group)
    out = o / torch.clamp(l[..., None], min=1e-30)
    out = out.transpose(1, 2).reshape(B, 1, -1).to(x.dtype)
    if not tp_names(p):
        return out @ fsdp_gather(p.wo, 0), cache_k, cache_v
    width = out.shape[-1] // model_size()
    out = out.narrow(-1, model_rank() * width, width)
    return tp_sum(out @ fsdp_gather(p.wo, 0)), cache_k, cache_v


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

    def tp_weights(self) -> tuple:
        """The weights kept split over `model` while the MLP runs: all of
        them under a mesh, for a model stored by spec with ``d_ff`` split
        over `model`; none otherwise (gathered whole)."""
        if get_mesh() is None or not SH.names_model(
                getattr(self.wi, "shard_spec", None), -1):
            return ()
        return tuple(n for n in ("wi", "wg", "wd") if n in self._parameters)


def mlp_apply(p: MLP, cfg: ModelConfig, x):
    tp = bool(tp_names(p))
    if tp:
        x = tp_copy(x)
    h = x @ fsdp_gather(p.wi, -1)
    if cfg.act == "relu2":  # nemotron squared-ReLU, non-gated
        h = torch.square(F.relu(h))
    elif cfg.act == "gelu_plain":  # whisper-style, non-gated
        h = F.gelu(h, approximate="tanh")
    elif cfg.act == "gelu":  # GeGLU (grok)
        h = F.gelu(h, approximate="tanh") * (x @ fsdp_gather(p.wg, -1))
    else:  # SwiGLU
        h = F.silu(h) * (x @ fsdp_gather(p.wg, -1))
    out = h @ fsdp_gather(p.wd, 0)
    return tp_sum(out) if tp else out
