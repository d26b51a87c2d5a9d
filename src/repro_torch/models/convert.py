"""Carry the reference package's parameters into a :class:`Transformer`.

The reference keeps its weights as a pytree of arrays with one period of
blocks stacked over a leading ``repeats`` axis.  :func:`params_from_jax`
takes that pytree with numpy leaves (``jax.tree.map(np.asarray, params)``,
done by the caller: nothing here imports JAX), unstacks the repeats into
one block per layer and copies every weight in its (d_in, d_out) layout
(an MoE block's (E, D, F) experts and fp32 router, the mamba, mLSTM and
sLSTM mixers, an enc-dec decoder's cross-attention and its encoder
likewise).
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
    if _DTYPES.get(a.dtype.name) != dst.dtype:
        raise ValueError(f"{what}: dtype {a.dtype} != {dst.dtype}")
    if a.dtype.name == "bfloat16":  # numpy has no bf16: move the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    dst.copy_(t)


def _copy_module(module, tree: dict, r, what: str) -> None:
    """Copy every leaf of the reference's ``tree`` (stacked: leaf ``[r]``;
    ``r=None``: as it is) into the same-named parameter of ``module``;
    the two must name the same weights."""
    own = dict(module.named_parameters(recurse=False))
    if sorted(own) != sorted(tree):
        raise ValueError(f"{what}: parameters {sorted(own)} != the "
                         f"reference's {sorted(tree)}")
    for name, leaf in tree.items():
        _copy(own[name], leaf if r is None else leaf[r], f"{what}.{name}")


def _copy_block(block, p: dict, r: int, what: str) -> None:
    """Block ``r`` of a stacked block tree ``p`` into ``block``."""
    _copy(block.norm1.scale, p["norm1"][r], f"{what}.norm1")
    _copy_module(block.mixer, p["mixer"], r, f"{what}.mixer")
    if hasattr(block, "cross") or "cross" in p:
        _copy(block.norm_x.scale, p["norm_x"][r], f"{what}.norm_x")
        _copy_module(block.cross, p["cross"], r, f"{what}.cross")
    if block.ffn_kind != "none":
        _copy(block.norm2.scale, p["norm2"][r], f"{what}.norm2")
        _copy_module(block.ffn, p["ffn"], r, f"{what}.ffn")


def _copy_stack(blocks, stacked: dict, period: int, what: str) -> None:
    for layer, block in enumerate(blocks):
        r, i = divmod(layer, period)
        _copy_block(block, stacked[f"b{i}"], r, f"{what}.b{i}[{r}]")


def params_from_jax(params: dict, cfg: ModelConfig, device=None
                    ) -> Transformer:
    """A :class:`Transformer` of ``cfg`` holding the reference's weights
    (numpy leaves) on ``device`` (``None`` means cuda).  The model's dtype
    is the embedding's; every leaf keeps its own (the MoE router and
    mamba's ``a_log`` and ``d_skip`` are fp32 in a bf16 tree), and a
    leaf whose dtype differs from its parameter's raises."""
    dtype = _DTYPES[np.asarray(params["embed"]["table"]).dtype.name]
    model = Transformer(cfg, device=device, dtype=dtype)
    _copy(model.embed, params["embed"]["table"], "embed.table")
    _copy(model.final_norm.scale, params["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _copy(model.lm_head, params["lm_head"]["head"], "lm_head.head")
    _copy_stack(model.blocks, params["blocks"], len(cfg.pattern), "blocks")
    if cfg.encoder_layers:
        enc = params["encoder"]
        _copy_stack(model.encoder.blocks, enc["blocks"], 1, "encoder.blocks")
        _copy(model.encoder.final_norm.scale, enc["final_norm"],
              "encoder.final_norm")
    return model
