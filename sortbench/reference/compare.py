"""The number a judge reports: mismatched elements (an exact comparison,
limit 0)."""

from __future__ import annotations

import torch


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``got`` that differ from ``want``, compared as int64
    (integers) or float64 (floats); a length that differs counts every
    element of the longer one."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if got.shape != want.shape:
        return int(max(got.numel(), want.numel()))
    wide = (torch.float64 if got.is_floating_point() or want.is_floating_point()
            else torch.int64)
    got = _widen(got, wide).to(want.device)
    return int((got != _widen(want, wide)).sum())


def _widen(t: torch.Tensor, wide: torch.dtype) -> torch.Tensor:
    if t.dtype == torch.uint32:
        return (t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).to(wide)
    return t.to(wide)

