"""Sorts and stable permutations of p-bit keys by ``torch.sort``.

Keys come as ``torch.uint32`` (p = 32) or int32 (p <= 31) tensors and
are widened to int64 before sorting, so every key sorts by its unsigned
value.  ``bits`` < p keeps only a key's top ``bits`` bits as its sort
key: the control's lower precision (the output is still the keys whole,
reordered by the truncated key, stably)."""

from __future__ import annotations

import torch


def as_int64(keys: torch.Tensor) -> torch.Tensor:
    """Unsigned key values as int64 (uint32 bits read through int32)."""
    if keys.dtype == torch.uint32:
        return keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return keys.to(torch.int64)


def stable_perm(keys: torch.Tensor, p: int, bits: int | None = None):
    """The stable permutation that sorts ``keys`` (int64), by the top
    ``bits`` of their ``p`` bits (all of them by default)."""
    k = as_int64(keys)
    if bits is not None and bits < p:
        k = k >> (p - bits)
    return torch.argsort(k, stable=True)


def sorted_keys(keys: torch.Tensor, p: int, bits: int | None = None):
    """``keys`` in sorted order as int64 values; by the top ``bits`` of
    their ``p`` bits, stably, where ``bits`` is given."""
    k = as_int64(keys)
    if bits is None or bits >= p:
        return torch.sort(k, stable=True).values
    return k[torch.argsort(k >> (p - bits), stable=True)]

