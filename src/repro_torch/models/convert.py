"""Carry the reference package's parameters into a :class:`Transformer`.

The reference keeps its weights as a pytree of arrays with one period of
blocks stacked over a leading ``repeats`` axis.  :func:`params_from_jax`
takes that pytree with numpy leaves (``jax.tree.map(np.asarray, params)``,
done by the caller: nothing here imports JAX), unstacks the repeats into
one block per layer and copies every weight in its (d_in, d_out) layout
(an MoE block's (E, D, F) experts and fp32 router likewise).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer

__all__ = ["params_from_jax"]

# the reference's parameter dtypes (bfloat16 is ml_dtypes' numpy type)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _copy(dst: torch.Tensor, src, what: str) -> None:
    a = np.asarray(src)
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {a.shape} != {tuple(dst.shape)}")
    if a.dtype.name == "bfloat16":  # numpy has no bf16: move the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    dst.copy_(t)


def params_from_jax(params: dict, cfg: ModelConfig, device=None
                    ) -> Transformer:
    """A :class:`Transformer` of ``cfg`` holding the reference's weights
    (numpy leaves), in their dtype, on ``device`` (``None`` means cuda)."""
    dtype = _DTYPES[np.asarray(params["embed"]["table"]).dtype.name]
    model = Transformer(cfg, device=device, dtype=dtype)
    _copy(model.embed, params["embed"]["table"], "embed.table")
    _copy(model.final_norm.scale, params["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _copy(model.lm_head, params["lm_head"]["head"], "lm_head.head")
    stacked = params["blocks"]
    period = len(cfg.pattern)
    for layer, block in enumerate(model.blocks):
        r, i = divmod(layer, period)
        p = stacked[f"b{i}"]
        name = f"blocks.b{i}[{r}]"
        _copy(block.norm1.scale, p["norm1"][r], f"{name}.norm1")
        for w in ("wq", "wk", "wv", "wo", "q_scale", "k_scale"):
            if w in p["mixer"]:
                _copy(getattr(block.mixer, w), p["mixer"][w][r],
                      f"{name}.mixer.{w}")
        if block.ffn_kind != "none":
            _copy(block.norm2.scale, p["norm2"][r], f"{name}.norm2")
            for w in ("wi", "wd", "wg", "router"):
                if w in p["ffn"]:
                    _copy(getattr(block.ffn, w), p["ffn"][w][r],
                          f"{name}.ffn.{w}")
    return model
