"""Plain PyTorch versions of the CUDA kernels (port of ``repro.kernels.ref``).

Each function computes what its kernel computes, with ordinary torch ops,
on any device.  The kernel wrappers call them for tensors on the CPU; the
tests and ``chip_smoke.py`` hold the kernels against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.fractal_tree import (as_u32_bits, exclusive_cumsum,
                                           wrap_int32)

__all__ = ["histogram_ref", "digit_histograms_ref", "rank_ref",
           "reconstruct_ref", "moe_dispatch_ref", "moe_ranks_ref",
           "flash_attention_ref"]


def histogram_ref(keys: torch.Tensor, n_bins: int,
                  init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bincount over ``[0, n_bins)`` added onto ``init`` (zeros when
    None); keys outside the range (padding) are ignored."""
    keys = keys.to(torch.int64)
    valid = keys[(keys >= 0) & (keys < n_bins)]
    out = (torch.zeros((n_bins,), dtype=torch.int32, device=keys.device)
           if init is None else init.to(torch.int32).clone())
    out.index_add_(0, valid, torch.ones_like(valid, dtype=torch.int32))
    return out


def digit_histograms_ref(keys: torch.Tensor, passes, init=None) -> tuple:
    """One :func:`histogram_ref` per digit pass: the bincount of each
    pass's ``bits``-wide digit at ``shift`` of the (uint32) key stream,
    added onto the matching entry of ``init`` when given."""
    u = as_u32_bits(keys)
    passes = tuple(passes)
    if init is None:
        init = (None,) * len(passes)
    return tuple(histogram_ref((u >> dp.shift) & (dp.n_bins - 1), dp.n_bins,
                               init=carried)
                 for dp, carried in zip(passes, init))


def rank_ref(keys: torch.Tensor, bin_start: torch.Tensor,
             n_bins: int) -> torch.Tensor:
    """Stable scatter slots via argsort-of-argsort:
    ``rank[i] = bin_start[k] + (earlier keys equal to k)``.

    Keys outside ``[0, n_bins)`` get rank 0 and are counted nowhere —
    what the rank kernels do with them (and what the reference's one-hot
    kernel does with its −1 padding)."""
    keys = keys.to(torch.int64)
    n = keys.shape[0]
    valid = (keys >= 0) & (keys < n_bins)
    sort_key = torch.where(valid, keys, torch.full_like(keys, n_bins))
    perm = torch.argsort(sort_key, stable=True)  # sorted -> arrival
    dense = torch.empty_like(perm)
    dense[perm] = torch.arange(n, device=keys.device)  # arrival -> sorted
    counts = histogram_ref(keys, n_bins).to(torch.int64)
    dense_start = torch.cumsum(counts, 0) - counts
    safe = keys.clamp(0, n_bins - 1)
    rank = bin_start.to(torch.int64)[safe] + dense - dense_start[safe]
    return torch.where(valid, rank, torch.zeros_like(rank)).to(torch.int32)


def reconstruct_ref(counts: torch.Tensor, trailing: torch.Tensor,
                    t_bits: int) -> torch.Tensor:
    """Algorithm 5: repeat bin ids by counts, or in the trailing bits;
    int32 bit patterns (p = 32 wraps, exact as uint32)."""
    n = trailing.shape[0]
    ends = torch.cumsum(counts.to(torch.int64), 0)
    slots = torch.arange(n, dtype=torch.int64, device=trailing.device)
    slot_bin = torch.searchsorted(ends, slots, right=True)
    return wrap_int32((slot_bin << t_bits)
                      | (trailing.to(torch.int64) & 0xFFFFFFFF))


def moe_dispatch_ref(expert_ids: torch.Tensor, num_experts: int) -> tuple:
    """The argsort dispatch (what frameworks usually do): ``perm`` a
    stable argsort of the ids, ``rank`` its inverse and ``counts`` the
    experts' loads, all int32."""
    T = expert_ids.shape[0]
    perm = torch.argsort(expert_ids, stable=True)
    rank = torch.zeros((T,), dtype=torch.int32, device=expert_ids.device)
    rank[perm] = torch.arange(T, dtype=torch.int32, device=expert_ids.device)
    return (perm.to(torch.int32), rank,
            histogram_ref(expert_ids, num_experts))


def moe_ranks_ref(expert_ids: torch.Tensor, num_experts: int) -> tuple:
    """:func:`moe_dispatch_ref`'s ``(rank, counts)`` and the experts'
    first slots, the shape of ``moe_dispatch.moe_ranks``."""
    _, rank, counts = moe_dispatch_ref(expert_ids, num_experts)
    return rank, counts, exclusive_cumsum(counts)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Naive softmax attention oracle in fp32, cast back to q's dtype.
    q: (B, Sq, H, hd); k, v: (B, Skv, H, hd); the causal mask hides keys
    after the query's own index (top-left aligned)."""
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        mask = (torch.arange(Skv, device=q.device)[None, :]
                > torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(mask[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
