"""Model assembler (port of ``repro.models.transformer``, dense and MoE
paths).

A :class:`Transformer` holds the token embedding, one :class:`Block` per
layer and the final norm; the reference stacks one period of blocks over
``cfg.repeats`` and scans it, which here becomes a Python loop over
``cfg.n_layers`` blocks (layer ``r * len(pattern) + i`` is block ``i`` of
repeat ``r``).  :func:`forward` / :func:`forward_hidden` /
:func:`unembed` / :func:`init_cache` / :func:`decode_step` keep the
reference's signatures with the model in place of the parameter pytree.

Supported: mixer ``attn``, ffns ``mlp``, ``moe`` (:mod:`.moe`, one rank)
and ``none``.  The other mixers (``mamba``, ``mlstm``, ``slstm``), the
encoder-decoder stack and the ``patch`` frontend raise
:class:`NotImplementedError` naming the ROADMAP item that ports them;
nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fractal_sort import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, moe_apply

__all__ = ["Block", "Transformer", "forward", "forward_hidden", "unembed",
           "init_cache", "decode_step"]

_NOT_YET = {
    "mamba": "the mamba mixer (models/ssm.py)",
    "mlstm": "the mLSTM mixer (models/xlstm.py)",
    "slstm": "the sLSTM mixer (models/xlstm.py)",
}


def _refuse(what: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1: the LM scaffold's "
        f"remaining families)")


def _check_supported(cfg: ModelConfig) -> None:
    for mixer, ffn in cfg.pattern:
        if mixer != "attn":
            _refuse(_NOT_YET.get(mixer, f"mixer {mixer!r}"))
        if ffn not in ("mlp", "moe", "none"):
            _refuse(_NOT_YET.get(ffn, f"ffn {ffn!r}"))
    if cfg.encoder_layers:
        _refuse("the encoder-decoder stack (whisper)")
    if cfg.frontend == "patch":
        _refuse("the patch frontend (vlm)")


class Block(nn.Module):
    """norm1 + attention mixer, then norm2 + ffn: an MLP, an
    :class:`~repro_torch.models.moe.MoE`, or none."""

    def __init__(self, cfg: ModelConfig, ffn: str, dtype, device):
        super().__init__()
        self.ffn_kind = ffn
        self.norm1 = L.RMSNorm(cfg.d_model, dtype, device)
        self.mixer = L.Attention(cfg, dtype, device)
        if ffn != "none":
            self.norm2 = L.RMSNorm(cfg.d_model, dtype, device)
            self.ffn = (MoE(cfg, dtype, device) if ffn == "moe"
                        else L.MLP(cfg, dtype, device))

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


def _ffn_apply(p: Block, cfg: ModelConfig, x):
    """The block's ffn half with its residual.  Returns (x, aux): aux is
    the MoE load-balancing loss (fp32), None for the other ffns."""
    if p.ffn_kind == "none":
        return x, None
    aux = None
    h = L.rms_norm(x, p.norm2.scale, cfg.rms_eps)
    if p.ffn_kind == "moe":
        h, aux = moe_apply(p.ffn, cfg, h)
    else:
        h = L.mlp_apply(p.ffn, cfg, h)
    return x + h.to(x.dtype), aux


def _block_apply(p: Block, cfg: ModelConfig, x, *, causal: bool):
    """Returns (x, aux), as :func:`_ffn_apply`."""
    h = L.rms_norm(x, p.norm1.scale, cfg.rms_eps)
    h, _ = L.attn_apply(p.mixer, cfg, h, causal=causal,
                        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return _ffn_apply(p, cfg, x + h.to(x.dtype))


def unembed(model: Transformer, cfg: ModelConfig):
    return model.embed.T if cfg.tie_embeddings else model.lm_head


def forward_hidden(model: Transformer, cfg: ModelConfig, tokens,
                   frontend_embeds=None):
    """Final hidden states (pre-unembedding).  Returns (h (B,S,D), aux);
    aux is the MoE load-balancing loss summed over the layers in fp32,
    zero for dense models."""
    if frontend_embeds is not None:
        _refuse("frontend embeddings (enc-dec and vlm)")
    x = model.embed[tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in model.blocks:
        x, a = _block_apply(block, cfg, x, causal=True)
        if a is not None:
            aux = aux + a
    x = L.rms_norm(x, model.final_norm.scale, cfg.rms_eps)
    return x, aux


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
    place (the reference returns new arrays).  MoE blocks route this
    step's B tokens alone, and their aux loss is dropped."""
    if cross_kv is not None:
        _refuse("cross-attention decode (enc-dec)")
    x = model.embed[token]
    for block, c in zip(model.blocks, cache):
        h = L.rms_norm(x, block.norm1.scale, cfg.rms_eps)
        h, c["k"], c["v"] = L.attn_decode(block.mixer, cfg, h, c["k"],
                                          c["v"], pos,
                                          kv_seq_axis=kv_seq_axis)
        x, _ = _ffn_apply(block, cfg, x + h.to(x.dtype))
    x = L.rms_norm(x, model.final_norm.scale, cfg.rms_eps)
    return x @ unembed(model, cfg), cache
