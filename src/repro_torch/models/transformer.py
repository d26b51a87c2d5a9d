"""Model assembler (port of ``repro.models.transformer``, dense path).

A :class:`Transformer` holds the token embedding, one :class:`Block` per
layer and the final norm; the reference stacks one period of blocks over
``cfg.repeats`` and scans it, which here becomes a Python loop over
``cfg.n_layers`` blocks (layer ``r * len(pattern) + i`` is block ``i`` of
repeat ``r``).  :func:`forward` / :func:`forward_hidden` /
:func:`unembed` / :func:`init_cache` / :func:`decode_step` keep the
reference's signatures with the model in place of the parameter pytree.

Supported: mixer ``attn``, ffns ``mlp`` and ``none``.  The other mixers
(``mamba``, ``mlstm``, ``slstm``), ``moe`` ffns, the encoder-decoder stack
and the ``patch`` frontend raise :class:`NotImplementedError` naming the
ROADMAP item that ports them; nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fractal_sort import resolve_device
from repro_torch.models import layers as L

__all__ = ["Block", "Transformer", "forward", "forward_hidden", "unembed",
           "init_cache", "decode_step"]

_NOT_YET = {
    "mamba": "the mamba mixer (models/ssm.py)",
    "mlstm": "the mLSTM mixer (models/xlstm.py)",
    "slstm": "the sLSTM mixer (models/xlstm.py)",
    "moe": "the MoE ffn (models/moe.py, kernels/moe_dispatch.py)",
}


def _refuse(what: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1: the LM scaffold's "
        f"remaining families)")


def _check_supported(cfg: ModelConfig) -> None:
    for mixer, ffn in cfg.pattern:
        if mixer != "attn":
            _refuse(_NOT_YET.get(mixer, f"mixer {mixer!r}"))
        if ffn not in ("mlp", "none"):
            _refuse(_NOT_YET.get(ffn, f"ffn {ffn!r}"))
    if cfg.encoder_layers:
        _refuse("the encoder-decoder stack (whisper)")
    if cfg.frontend == "patch":
        _refuse("the patch frontend (vlm)")


class Block(nn.Module):
    """norm1 + attention mixer, then norm2 + ffn (absent when ``none``)."""

    def __init__(self, cfg: ModelConfig, ffn: str, dtype, device):
        super().__init__()
        self.ffn_kind = ffn
        self.norm1 = L.RMSNorm(cfg.d_model, dtype, device)
        self.mixer = L.Attention(cfg, dtype, device)
        if ffn != "none":
            self.norm2 = L.RMSNorm(cfg.d_model, dtype, device)
            self.ffn = L.MLP(cfg, dtype, device)

    def init_params(self, generator: torch.Generator) -> None:
        self.mixer.init_params(generator)
        if self.ffn_kind != "none":
            self.ffn.init_params(generator)


class Transformer(nn.Module):
    """Decoder-only LM of ``cfg``: ``embed`` (V, D), ``blocks``,
    ``final_norm`` and, without tied embeddings, ``lm_head`` (D, V).

    ``device=None`` means ``"cuda"`` and raises without a card.  The
    parameters are allocated here and filled by :meth:`init_params` (or
    copied in by :func:`repro_torch.models.convert.params_from_jax`)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = L.empty_param((cfg.vocab, cfg.d_model), dtype,
                                   device)
        self.blocks = nn.ModuleList(
            Block(cfg, ffn, dtype, device)
            for _ in range(cfg.repeats) for _, ffn in cfg.pattern)
        self.final_norm = L.RMSNorm(cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = L.empty_param((cfg.d_model, cfg.vocab), dtype,
                                         device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def init_params(self, generator: torch.Generator) -> "Transformer":
        """Random weights from ``generator`` (on the model's device):
        dense weights normal / sqrt(d_in), the embedding normal * 0.02,
        norm scales one.  Returns the model."""
        z = torch.randn(self.embed.shape, generator=generator,
                        device=self.device, dtype=torch.float32)
        self.embed.copy_(z * 0.02)
        del z
        for block in self.blocks:
            block.init_params(generator)
        if not self.cfg.tie_embeddings:
            L.dense_init(self.lm_head, generator)
        return self


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _block_apply(p: Block, cfg: ModelConfig, x, *, causal: bool):
    h = L.rms_norm(x, p.norm1.scale, cfg.rms_eps)
    h, _ = L.attn_apply(p.mixer, cfg, h, causal=causal,
                        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    x = x + h.to(x.dtype)
    if p.ffn_kind != "none":
        h = L.rms_norm(x, p.norm2.scale, cfg.rms_eps)
        x = x + L.mlp_apply(p.ffn, cfg, h).to(x.dtype)
    return x


def unembed(model: Transformer, cfg: ModelConfig):
    return model.embed.T if cfg.tie_embeddings else model.lm_head


def forward_hidden(model: Transformer, cfg: ModelConfig, tokens,
                   frontend_embeds=None):
    """Final hidden states (pre-unembedding).  Returns (h (B,S,D), aux);
    aux is the MoE load-balancing loss, zero for dense models."""
    if frontend_embeds is not None:
        _refuse("frontend embeddings (enc-dec and vlm)")
    x = model.embed[tokens]
    for block in model.blocks:
        x = _block_apply(block, cfg, x, causal=True)
    x = L.rms_norm(x, model.final_norm.scale, cfg.rms_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(model: Transformer, cfg: ModelConfig, tokens,
            frontend_embeds=None):
    """Logits for a token batch.  tokens: (B, S) integer.  Returns
    (logits (B, S, V), aux_loss)."""
    x, aux = forward_hidden(model, cfg, tokens, frontend_embeds)
    return x @ unembed(model, cfg), aux


# ---------------------------------------------------------------------------
# decode (serve)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_len: int, dtype,
               device=None, kv_shards: int = 1) -> list:
    """Decode cache: one ``{"k", "v"}`` dict of zero (B, max_len, KV, hd)
    tensors per layer.  ``device=None`` means ``"cuda"``."""
    _check_supported(cfg)
    if kv_shards != 1:
        raise NotImplementedError(
            "sequence-sharded decode caches are not ported yet (ROADMAP "
            "queue 1: the LM scaffold's sharding)")
    device = resolve_device(device)
    shape = (B, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def decode_step(model: Transformer, cfg: ModelConfig, cache: list, token,
                pos, *, cross_kv=None, kv_seq_axis: Optional[str] = None):
    """One decode step.  token: (B, 1) integer; pos: int (or 0-d tensor).

    Returns (logits (B, 1, V), cache); the cache tensors are updated in
    place (the reference returns new arrays)."""
    if cross_kv is not None:
        _refuse("cross-attention decode (enc-dec)")
    x = model.embed[token]
    for block, c in zip(model.blocks, cache):
        h = L.rms_norm(x, block.norm1.scale, cfg.rms_eps)
        h, c["k"], c["v"] = L.attn_decode(block.mixer, cfg, h, c["k"],
                                          c["v"], pos,
                                          kv_seq_axis=kv_seq_axis)
        x = x + h.to(x.dtype)
        if block.ffn_kind == "mlp":
            h = L.rms_norm(x, block.norm2.scale, cfg.rms_eps)
            x = x + L.mlp_apply(block.ffn, cfg, h).to(x.dtype)
    x = L.rms_norm(x, model.final_norm.scale, cfg.rms_eps)
    return x @ unembed(model, cfg), cache
