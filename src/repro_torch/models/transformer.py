"""Model assembler: decoder-only, hybrid, recurrent and encoder-decoder LMs
from a ``ModelConfig`` layer pattern (port of
``repro.models.transformer``).

A :class:`Transformer` holds the token embedding, one :class:`Block` per
layer and the final norm, and for an enc-dec config (whisper) an
:class:`Encoder`; the reference stacks one period of blocks over
``cfg.repeats`` and scans it, which here becomes a Python loop over
``cfg.n_layers`` blocks (layer ``r * len(pattern) + i`` is block ``i`` of
repeat ``r``).  :func:`forward` / :func:`forward_hidden` /
:func:`unembed` / :func:`init_cache` / :func:`encode_cross_kv` /
:func:`decode_step` keep the reference's signatures with the model in
place of the parameter pytree.

Block kinds: mixers ``attn``, ``mamba`` (:mod:`.ssm`), ``mlstm`` and
``slstm`` (:mod:`.xlstm`); ffns ``mlp``, ``moe`` (:mod:`.moe`, one rank)
and ``none``.  An enc-dec config adds a bidirectional encoder stack and a
cross-attention sublayer in every decoder block; a ``patch`` frontend
(vlm) prepends stub patch embeddings.  ``init_cache(kv_shards=)`` gives
this rank's slice of a sequence-sharded decode cache (split-KV decode).

Under the sharded train step the model's parameters are this rank's
shards, and each block (and the embedding, the final norms, the head)
is gathered whole where it runs (:func:`.act_sharding.gathered`): inside
the remat checkpoint, so the recompute gathers again.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fractal_sort import resolve_device
from repro_torch.models import act_sharding as AS
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.moe import MoE, moe_apply

__all__ = ["Block", "Encoder", "Transformer", "forward", "forward_hidden",
           "unembed", "gathered_head", "init_cache", "encode_cross_kv",
           "decode_step"]

_ENCODER_PATTERN = (("attn", "mlp"),)


class _Mixer(NamedTuple):
    """What the model needs of one mixer kind: ``module(cfg, dtype,
    device)``; ``apply(p, cfg, h, causal) -> h`` over a sequence;
    ``decode(p, cfg, h, cache, pos, kv_seq_axis) -> h`` for one token,
    updating the layer's cache dict in place; ``init_cache(cfg, B,
    max_len, dtype, device) -> cache``."""
    module: type
    apply: Callable
    decode: Callable
    init_cache: Callable


def _attn_apply(p, cfg: ModelConfig, h, causal: bool):
    return L.attn_apply(p, cfg, h, causal=causal, chunk_q=cfg.attn_chunk_q,
                        chunk_kv=cfg.attn_chunk_kv)[0]


def _attn_decode(p, cfg: ModelConfig, h, c: dict, pos, kv_seq_axis):
    h, c["k"], c["v"] = L.attn_decode(p, cfg, h, c["k"], c["v"], pos,
                                      kv_seq_axis=kv_seq_axis)
    return h


def _attn_cache(cfg: ModelConfig, B: int, max_len: int, dtype, device):
    shape = (B, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _one_token(cell: Callable) -> Callable:
    """A cell on (B, D) as a step on (B, 1, D)."""
    def step(p, cfg, h, state):
        h, state = cell(p, cfg, h[:, 0], state)
        return h[:, None], state
    return step


def _recurrent(kind: str, module: type, apply: Callable, step: Callable,
               init_state: Callable) -> _Mixer:
    """A recurrent mixer: its cache is ``{kind: state}``, replaced by
    each step; the causal flag means nothing to it."""
    def decode(p, cfg, h, c, pos, kv_seq_axis):
        h, c[kind] = step(p, cfg, h, c[kind])
        return h
    return _Mixer(
        module, lambda p, cfg, h, causal: apply(p, cfg, h), decode,
        lambda cfg, B, max_len, dtype, device: {
            kind: init_state(cfg, B, dtype, device)})


_MIXERS = {
    "attn": _Mixer(L.Attention, _attn_apply, _attn_decode, _attn_cache),
    "mamba": _recurrent("mamba", S.Mamba, S.mamba_apply, S.mamba_decode,
                        S.mamba_init_cache),
    "mlstm": _recurrent("mlstm", X.MLSTM, X.mlstm_apply,
                        _one_token(X.mlstm_cell), X.mlstm_init_state),
    "slstm": _recurrent("slstm", X.SLSTM, X.slstm_apply,
                        _one_token(X.slstm_cell), X.slstm_init_state),
}


class Block(nn.Module):
    """norm1 + a mixer (``attn``, ``mamba``, ``mlstm`` or ``slstm``); in
    an enc-dec decoder, norm_x + cross-attention; then norm2 + ffn: an
    MLP, an :class:`~repro_torch.models.moe.MoE`, or none."""

    def __init__(self, cfg: ModelConfig, mixer: str, ffn: str, dtype, device,
                 cross: bool = False):
        super().__init__()
        if mixer not in _MIXERS:
            raise ValueError(f"unknown mixer {mixer!r}: one of "
                             f"{sorted(_MIXERS)}")
        self.mixer_kind = mixer
        self.ffn_kind = ffn
        self.norm1 = L.RMSNorm(cfg.d_model, dtype, device)
        self.mixer = _MIXERS[mixer].module(cfg, dtype, device)
        if cross:
            self.norm_x = L.RMSNorm(cfg.d_model, dtype, device)
            self.cross = L.Attention(cfg, dtype, device)
        if ffn != "none":
            self.norm2 = L.RMSNorm(cfg.d_model, dtype, device)
            self.ffn = (MoE(cfg, dtype, device) if ffn == "moe"
                        else L.MLP(cfg, dtype, device))

    def init_params(self, generator: torch.Generator) -> None:
        self.mixer.init_params(generator)
        if hasattr(self, "cross"):
            self.cross.init_params(generator)
        if self.ffn_kind != "none":
            self.ffn.init_params(generator)


class Encoder(nn.Module):
    """The enc-dec encoder: ``cfg.encoder_layers`` (attn, mlp) blocks run
    without a causal mask, and a final norm."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(cfg, mixer, ffn, dtype, device)
            for _ in range(cfg.encoder_layers)
            for mixer, ffn in _ENCODER_PATTERN)
        self.final_norm = L.RMSNorm(cfg.d_model, dtype, device)


class Transformer(nn.Module):
    """LM of ``cfg``: ``embed`` (V, D), ``blocks``, ``final_norm``,
    without tied embeddings ``lm_head`` (D, V), and for an enc-dec config
    ``encoder``.

    ``device=None`` means ``"cuda"`` and raises without a card.  The
    parameters are allocated here and filled by :meth:`init_params` (or
    copied in by :func:`repro_torch.models.convert.params_from_jax`)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = L.empty_param((cfg.vocab, cfg.d_model), dtype,
                                   device)
        cross = cfg.encoder_layers > 0
        self.blocks = nn.ModuleList(
            Block(cfg, mixer, ffn, dtype, device, cross=cross)
            for _ in range(cfg.repeats) for mixer, ffn in cfg.pattern)
        self.final_norm = L.RMSNorm(cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = L.empty_param((cfg.d_model, cfg.vocab), dtype,
                                         device)
        if cross:
            self.encoder = Encoder(cfg, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def init_params(self, generator: torch.Generator) -> "Transformer":
        """Random weights from ``generator`` (on the model's device):
        dense weights normal / sqrt(d_in), the embedding normal * 0.02,
        norm scales one, each mixer's own init.  Returns the model."""
        z = torch.randn(self.embed.shape, generator=generator,
                        device=self.device, dtype=torch.float32)
        self.embed.copy_(z * 0.02)
        del z
        for block in self.blocks:
            block.init_params(generator)
        if not self.cfg.tie_embeddings:
            L.dense_init(self.lm_head, generator)
        if hasattr(self, "encoder"):
            for block in self.encoder.blocks:
                block.init_params(generator)
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


def _block_apply(p: Block, cfg: ModelConfig, x, *, causal: bool,
                 enc_out=None):
    """Returns (x, aux), as :func:`_ffn_apply`."""
    h = L.rms_norm(x, p.norm1.scale, cfg.rms_eps)
    # keep the residual stream in the model's dtype (the fp32 SSM and gate
    # math must not promote it)
    x = x + _MIXERS[p.mixer_kind].apply(p.mixer, cfg, h, causal).to(
        x.dtype)
    if enc_out is not None:
        h = L.rms_norm(x, p.norm_x.scale, cfg.rms_eps)
        h, _ = L.attn_apply(p.cross, cfg, h, causal=False, kv_x=enc_out,
                            use_rope=False, chunk_q=cfg.attn_chunk_q,
                            chunk_kv=cfg.attn_chunk_kv)
        x = x + h.to(x.dtype)
    return _ffn_apply(p, cfg, x)


def _run_stack(blocks, cfg: ModelConfig, x, period: int, *, causal: bool,
               enc_out=None):
    """The blocks over x, one period (``period`` blocks) at a time.
    Returns (x, aux): aux summed over the layers in fp32.

    With ``cfg.remat`` and grad mode on, each period runs under
    :func:`torch.utils.checkpoint.checkpoint`: backward keeps only each
    period's input and recomputes the rest, as the reference's
    ``jax.checkpoint`` of its scanned period does.  The port has no
    ``"dots"`` policy (saving the products' outputs), so
    ``remat_policy="dots"`` remats as ``"nothing"`` does.  A sharded
    block is gathered whole while it runs (:func:`.act_sharding.
    gathered`)."""
    def period_fn(x, aux, *period_blocks):
        for block in period_blocks:
            with AS.gathered(block):
                x, a = _block_apply(block, cfg, x, causal=causal,
                                    enc_out=enc_out)
            if a is not None:
                aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, len(blocks), period):
        period_blocks = blocks[lo:lo + period]
        if remat:
            x, aux = checkpoint(period_fn, x, aux, *period_blocks,
                                use_reentrant=False)
        else:
            x, aux = period_fn(x, aux, *period_blocks)
    return x, aux


def _encode(encoder: Encoder, cfg: ModelConfig, x):
    """The encoder over frame embeddings (B, S_enc, D) of its dtype.
    Returns its normed output."""
    x, _ = _run_stack(encoder.blocks, cfg, x, len(_ENCODER_PATTERN),
                      causal=False)
    with AS.gathered(encoder.final_norm):
        return L.rms_norm(x, encoder.final_norm.scale, cfg.rms_eps)


def unembed(model: Transformer, cfg: ModelConfig):
    return model.embed.T if cfg.tie_embeddings else model.lm_head


def gathered_head(model: Transformer, cfg: ModelConfig):
    """A context inside which :func:`unembed` is whole (the sharded step
    gathers it there; otherwise nothing happens)."""
    return AS.gathered(model, ("embed",) if cfg.tie_embeddings
                       else ("lm_head",))


def forward_hidden(model: Transformer, cfg: ModelConfig, tokens,
                   frontend_embeds=None):
    """Final hidden states (pre-unembedding).  Returns (h (B,S,D), aux);
    aux is the MoE load-balancing loss summed over the layers in fp32,
    zero for models without MoE."""
    with AS.gathered(model, ("embed",)):
        x = model.embed[tokens]
    enc_out = None
    if cfg.encoder_layers and frontend_embeds is not None:
        enc_out = _encode(model.encoder, cfg,
                          frontend_embeds.to(model.dtype))
    prefix = 0
    if cfg.frontend == "patch" and frontend_embeds is not None:
        prefix = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    x, aux = _run_stack(model.blocks, cfg, x, len(cfg.pattern), causal=True,
                        enc_out=enc_out)
    with AS.gathered(model.final_norm):
        x = L.rms_norm(x, model.final_norm.scale, cfg.rms_eps)
    if prefix:
        x = x[:, prefix:]
    return x, aux


def forward(model: Transformer, cfg: ModelConfig, tokens,
            frontend_embeds=None):
    """Logits for a token batch.

    tokens: (B, S) integer.  ``frontend_embeds``:
      * audio (enc-dec): (B, S_enc, D) stub frame embeddings -> encoder;
      * patch (vlm): (B, P, D) stub patch embeddings, prepended to the
        sequence and cut off after the final norm.

    Returns (logits (B, S, V), aux_loss)."""
    x, aux = forward_hidden(model, cfg, tokens, frontend_embeds)
    with gathered_head(model, cfg):
        return x @ unembed(model, cfg), aux


# ---------------------------------------------------------------------------
# decode (serve)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_len: int, dtype,
               device=None, kv_shards: int = 1) -> list:
    """Decode cache, one dict per layer: ``{"k", "v"}`` zero (B, max_len,
    KV, hd) tensors for attention, ``{"mamba": ...}``, ``{"mlstm": ...}``
    or ``{"slstm": ...}`` zero recurrent states for the others.
    Cross-attention K/V are not part of it: :func:`encode_cross_kv` makes
    them once a request.  ``device=None`` means ``"cuda"``.

    ``kv_shards > 1``: this rank's slice of a cache whose sequence is
    split ``kv_shards`` ways (split-KV decode, ``decode_step(...,
    kv_seq_axis=)`` over an axis of that size): attention K/V of
    ``max_len / kv_shards`` positions; the recurrent states are not
    split.  The reference, one process, stacks every slice on a leading
    ``kv_shards`` axis instead."""
    if kv_shards < 1 or max_len % kv_shards:
        raise ValueError(f"max_len {max_len} does not split into "
                         f"{kv_shards} equal slices")
    device = resolve_device(device)
    return [_MIXERS[mixer].init_cache(cfg, B, max_len // kv_shards, dtype,
                                      device)
            for _ in range(cfg.repeats) for mixer, _ in cfg.pattern]


def encode_cross_kv(model: Transformer, cfg: ModelConfig, frontend_embeds):
    """Enc-dec: run the encoder once.  Returns (one ``{"ck", "cv"}`` dict
    of (B, S_enc, KV, hd) tensors per decoder layer, enc_out).

    As in the reference, the frames are not cast to the model's dtype
    here (``forward_hidden`` casts them): the encoder and the cross K/V
    run in the wider of the two dtypes, as JAX promotes bf16 weights
    against fp32 frames, on a copy of the encoder cast to it.  Frames
    narrower than the model differ: the reference keeps its encoder's
    residual stream in the frames' dtype, the port in the model's."""
    dtype = torch.promote_types(frontend_embeds.dtype, model.dtype)
    encoder = (model.encoder if dtype == model.dtype
               else copy.deepcopy(model.encoder).to(dtype))
    enc_out = _encode(encoder, cfg, frontend_embeds.to(dtype))
    hd = cfg.resolved_head_dim
    B, Skv, _ = enc_out.shape
    cross_kv = [{
        name: (enc_out @ w.to(dtype)).reshape(B, Skv, cfg.n_kv_heads, hd)
        for name, w in (("ck", block.cross.wk), ("cv", block.cross.wv))
    } for block in model.blocks]
    return cross_kv, enc_out


def decode_step(model: Transformer, cfg: ModelConfig, cache: list, token,
                pos, *, cross_kv=None, kv_seq_axis: Optional[str] = None):
    """One decode step.  token: (B, 1) integer; pos: int (or 0-d tensor).

    Returns (logits (B, 1, V), cache); the attention caches are updated in
    place and the recurrent states replaced in their layer's dict (the
    reference returns a new cache).  ``cross_kv`` (from
    :func:`encode_cross_kv`) enables the enc-dec path.  MoE blocks route
    this step's B tokens alone, and their aux loss is dropped."""
    x = model.embed[token]
    for layer, (block, c) in enumerate(zip(model.blocks, cache)):
        h = L.rms_norm(x, block.norm1.scale, cfg.rms_eps)
        h = _MIXERS[block.mixer_kind].decode(block.mixer, cfg, h, c, pos,
                                             kv_seq_axis)
        x = x + h.to(x.dtype)
        if cross_kv is not None:
            # every encoder position is visible: pos past any of them, no
            # rope, the cross K/V left as they are
            h = L.rms_norm(x, block.norm_x.scale, cfg.rms_eps)
            h, _, _ = L.attn_decode(block.cross, cfg, h,
                                    cross_kv[layer]["ck"],
                                    cross_kv[layer]["cv"], 1 << 30,
                                    use_rope=False, update_cache=False)
            x = x + h.to(x.dtype)
        x, _ = _ffn_apply(block, cfg, x)
    x = L.rms_norm(x, model.final_norm.scale, cfg.rms_eps)
    return x @ unembed(model, cfg), cache
