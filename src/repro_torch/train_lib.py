"""Prefill and decode step factories (port of ``repro.train_lib``, the
inference half; there is no train step in the port yet).

Each factory takes the config and returns a step over a
:class:`~repro_torch.models.transformer.Transformer`; the config passed
here, not the model's own, decides the path (``use_pallas_attention``
routes prefill attention through kernel K5).  Steps run under
:func:`torch.inference_mode`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

__all__ = ["make_prefill_step", "make_decode_step"]


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
