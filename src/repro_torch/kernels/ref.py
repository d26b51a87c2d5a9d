"""Plain PyTorch versions of the CUDA kernels (port of ``repro.kernels.ref``).

Each function computes what its kernel computes, with ordinary torch ops,
on any device.  The kernel wrappers call them for tensors on the CPU; the
tests and ``chip_smoke.py`` hold the kernels against them on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fractal_tree import wrap_int32

__all__ = ["histogram_ref", "rank_ref", "reconstruct_ref"]


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
