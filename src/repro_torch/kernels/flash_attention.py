"""K5: blockwise (flash) attention — wrapper over ``csrc/flash_attention.cu``.

Port of ``repro.kernels.flash_attention``.  :func:`flash_attention_kernel`
takes q (B, Sq, H, hd) and k, v (B, Skv, H, hd) already repeated to H
heads, in float32 or bfloat16, and returns softmax attention in q's dtype
(scale 1/sqrt(hd), causal mask top-left aligned, fp32 accumulation).  On
a CPU tensor it computes the plain version
(:func:`~repro_torch.kernels.ref.flash_attention_ref`); on a CUDA tensor it
launches the kernel or raises.

K5 has no backward, as the reference's has none: a call that autograd
would have to differentiate (grad mode on and q, k or v requiring grad)
raises on either device, so no path gets an attention output whose
gradient is silently lost.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, ref

__all__ = ["flash_attention_kernel", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.library("flash_attention", {"fs_flash_attention": [
        vp, vp, vp, vp, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll,
        i, ctypes.c_float, i, vp]})


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device.index not in (None, 0):
        raise ValueError(f"{name} is on {t.device}; the kernels run on cuda:0")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, q is {dtype}")
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{name} must be 4-D (B, S, H, hd) with a dense "
                         f"last dim, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True, block_q: int = 128,
                           block_kv: int = 128) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, hd) over k, v (B, Skv, H, hd).

    ``block_q``/``block_kv`` are the reference's TPU tile sizes; they do
    not change the result, and the CUDA kernel tiles by its own choice."""
    del block_q, block_kv
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_kernel (K5) has no backward: it cannot run on "
            "inputs that require grad; train with use_pallas_attention="
            "False (the plain blockwise attention)")
    if q.device.type == "cpu":
        if k.device != q.device or v.device != q.device:
            raise ValueError(f"q is on the CPU, k on {k.device}, v on "
                             f"{v.device}")
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, q.dtype)
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    if k.shape != (B, Skv, H, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, Skv, H, hd) with q's B, H, hd {tuple(q.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} out of range (1..{MAX_HEAD_DIM})")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.check(_lib().fs_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Sq, Skv, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
        _build.stream(q.device)), "flash_attention_kernel")
    _build.count_launch(flash_attention_kernel)
    return out


flash_attention_kernel.launches = 0
