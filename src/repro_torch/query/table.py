"""Minimal columnar table: named equal-length columns, gather-based ops.

Port of ``repro.query.table``.  Columns are 1-D tensors on one device,
keyed by name, insertion-ordered; float64 columns stay on the device as
``torch.float64``.  Row movement is always a *gather* by a row-id column
produced by a sort (:meth:`Table.take`), never a per-column sort.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.executor import _signed
from repro_torch.core.fractal_sort import resolve_device

__all__ = ["Table"]


def _gather(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]`` along dim 0; torch gathers no uint16/uint32/uint64
    tensor, so those move their bits as the signed type of their width."""
    return _signed(col).index_select(0, idx).view(col.dtype)


class Table:
    """Named, equal-length, insertion-ordered columns on one device.

    ``device=None`` means ``"cuda"`` and raises when CUDA is unavailable
    (:func:`~repro_torch.core.fractal_sort.resolve_device`); pass
    ``device="cpu"`` to run on the CPU.  Columns may be numpy arrays or
    tensors; each moves to the device."""

    def __init__(self, columns: Mapping[str, object], device=None):
        if not columns:
            raise ValueError("a Table needs at least one column")
        self._device = resolve_device(device)
        cols = {}
        n = None
        for name, col in columns.items():
            if not isinstance(col, torch.Tensor):
                col = torch.as_tensor(np.asarray(col))
            col = col.to(self._device)
            if col.dim() != 1:
                raise ValueError(f"column {name!r} must be 1-D")
            if n is None:
                n = col.shape[0]
            if col.shape[0] != n:
                raise ValueError(f"column {name!r} has {col.shape[0]} rows, "
                                 f"expected {n}")
            cols[name] = col
        self._cols = cols
        self._n = n

    # -- shape / access -----------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def num_rows(self) -> int:
        return self._n

    @property
    def column_names(self):
        return tuple(self._cols)

    def column(self, name: str) -> torch.Tensor:
        if name not in self._cols:
            raise KeyError(f"no column {name!r}; have {list(self._cols)}")
        return self._cols[name]

    def __len__(self) -> int:
        return self._n

    def __repr__(self) -> str:
        cols = ", ".join(f"{k}:{str(v.dtype).removeprefix('torch.')}"
                         for k, v in self._cols.items())
        return f"Table({self._n} rows on {self._device}; {cols})"

    # -- relational building blocks ------------------------------------------

    def _new(self, columns: Mapping[str, torch.Tensor]) -> "Table":
        return Table(columns, device=self._device)

    def select(self, names: Sequence[str]) -> "Table":
        return self._new({n: self.column(n) for n in names})

    def take(self, rowids) -> "Table":
        """Gather every column at ``rowids`` (a sort's payload output),
        one ``index_select`` a column over one shared int64 index."""
        idx = torch.as_tensor(rowids, device=self._device).to(torch.int64)
        return self._new({n: _gather(c, idx) for n, c in self._cols.items()})

    def head(self, k: int) -> "Table":
        return self._new({n: c[:min(k, self._n)]
                          for n, c in self._cols.items()})

    def with_columns(self, columns: Mapping[str, object]) -> "Table":
        merged = dict(self._cols)
        merged.update(columns)
        return self._new(merged)

    def to_numpy(self) -> dict:
        """Every column as a numpy array of its dtype (on the host)."""
        return {n: c.cpu().numpy() for n, c in self._cols.items()}
