"""Order-preserving key codecs: typed columns → sortable unsigned bitstrings.

Port of ``repro.query.codec``.  A :class:`Codec` maps a typed column to
an unsigned code such that

    a < b  (column order)  ⇔  encode(a) < encode(b)  (unsigned order)

and back (``decode(encode(x)) == x``), reporting its exact bit width so
the planner sizes radix passes from the *encoded* key.

Transforms: signed ints by **bias flip** (add ``2**(bits-1)`` modulo
``2**bits``); float32/float64 by the **IEEE-754 sign-magnitude
transform** (non-negative floats get the sign bit set, negative floats
are complemented: the IEEE total order, NaNs at the extremes, -0.0 just
below +0.0); bool as one bit; composites pack each column's code
**MSB-first** in key-priority order, a descending column bit-inverted
within its width.

Codes wider than 32 bits are **multi-word**: shape ``(n, W)``, word 0
most significant, every word 32 bits wide except the last
(:func:`word_widths`).  As everywhere in this package the words are
``torch.int32`` storage of their uint32 bits, touched only by
``& | ^ ~`` and masked shifts; ``.view(torch.uint32)`` gives the unsigned
view.  Encoding and decoding run on the column's device, float64
included (the reference splits float64 on the host because its JAX runs
with x64 off).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fractal_tree import as_u32_bits
from repro_torch.core.autotune import tuned_plan

__all__ = [
    "Codec",
    "BoolCodec",
    "IntCodec",
    "UIntCodec",
    "Float32Codec",
    "Float64Codec",
    "CompositeCodec",
    "ColumnSpec",
    "infer_codec",
    "word_widths",
]

_SIGN = -(1 << 31)  # int32 with only the top bit set


def word_widths(bits: int) -> Tuple[int, ...]:
    """Bit width of each uint32 word of a ``bits``-wide code, MSB-first:
    all words carry 32 bits except the last, which carries the low
    ``((bits - 1) % 32) + 1`` bits (LSB-aligned)."""
    if bits < 1:
        raise ValueError(f"code width {bits} out of range")
    last = ((bits - 1) % 32) + 1
    return (32,) * ((bits - last) // 32) + (last,)


def _i32(value: int) -> int:
    """A uint32 constant as the int32 value of the same bits."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


def _mask(bits: int) -> int:
    return _i32((1 << bits) - 1)


def _tensor(col) -> torch.Tensor:
    return col if isinstance(col, torch.Tensor) else torch.as_tensor(
        np.asarray(col))


def _u32_bits(col: torch.Tensor) -> torch.Tensor:
    """An integer column's values modulo 2**32 as int32 storage (the
    reference's ``astype(uint32)``)."""
    if col.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8,
                     torch.uint16):
        return col.to(torch.int32)
    return as_u32_bits(col)


class Codec:
    """Order-preserving column ⇄ unsigned-code map.

    ``bits`` is the exact code width; ``encode`` returns ``(n, W)`` int32
    words (``W = len(word_widths(bits))``), ``decode`` inverts it.
    Encoding is split in two so a sort can take raw columns:
    :meth:`prepare` is a bitcast or layout change only, never
    order-transforming; :meth:`encode_fn` holds every order-preserving
    transform.  ``encode`` is ``encode_fn(prepare(col))``.  Codecs are
    hashable values, so sort chains cache on them."""

    bits: int

    @property
    def num_words(self) -> int:
        return len(word_widths(self.bits))

    def word_plans(self, n: int, backend: str) -> tuple:
        """One sort plan per code word for an ``n``-row column, each
        sized to that word's bit width and resolved through the autotune
        cache of the pass backend ``backend``
        (:func:`~repro_torch.core.autotune.tuned_plan`: never measures)."""
        return tuple(tuned_plan(n, w, backend=backend)
                     for w in word_widths(self.bits))

    def prepare(self, col):
        """The column as tensors ready for :meth:`encode_fn` (bitcast or
        layout only: no ordering transform happens here)."""
        return _tensor(col)

    def encode_fn(self, prepped) -> torch.Tensor:
        """Order-preserving transform: prepared tensors → ``(n, W)`` int32
        code words."""
        raise NotImplementedError

    def encode(self, col) -> torch.Tensor:
        return self.encode_fn(self.prepare(col))

    def decode(self, words: torch.Tensor):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class BoolCodec(Codec):
    bits: int = 1

    def encode_fn(self, prepped):
        return _tensor(prepped).to(torch.bool).to(torch.int32)[:, None]

    def decode(self, words):
        return words[:, 0] != 0


def _int_out_dtype(bits: int, signed: bool) -> torch.dtype:
    """Narrowest dtype holding a ``bits``-wide (un)signed value: decode
    hands back the dtype :func:`infer_codec` maps to this codec, so an
    operator's output re-infers the same codec."""
    if bits <= 8:
        return torch.int8 if signed else torch.uint8
    if bits <= 16:
        return torch.int16 if signed else torch.uint16
    return torch.int32 if signed else torch.uint32


@dataclasses.dataclass(frozen=True)
class IntCodec(Codec):
    """Signed ints in ``[-2**(bits-1), 2**(bits-1))`` via bias flip."""

    bits: int = 32

    def __post_init__(self):
        if not 2 <= self.bits <= 32:
            raise ValueError(f"IntCodec bits={self.bits}")

    def encode_fn(self, prepped):
        u = _u32_bits(_tensor(prepped))
        return ((u + _i32(1 << (self.bits - 1))) & _mask(self.bits))[:, None]

    def decode(self, words):
        code = words[:, 0]
        if self.bits == 32:
            return code ^ _SIGN
        val = code - (1 << (self.bits - 1))
        return val.to(_int_out_dtype(self.bits, signed=True))


@dataclasses.dataclass(frozen=True)
class UIntCodec(Codec):
    """Unsigned ints in ``[0, 2**bits)``: the identity codec."""

    bits: int = 32

    def __post_init__(self):
        if not 1 <= self.bits <= 32:
            raise ValueError(f"UIntCodec bits={self.bits}")

    def prepare(self, col):
        # torch gathers no uint16/uint32 tensor: hand on int32 storage
        return _u32_bits(_tensor(col))

    def encode_fn(self, prepped):
        return (_u32_bits(_tensor(prepped)) & _mask(self.bits))[:, None]

    def decode(self, words):
        code = words[:, 0]
        if self.bits == 32:
            return code.contiguous().view(torch.uint32)
        return code.to(_int_out_dtype(self.bits, signed=False))


@dataclasses.dataclass(frozen=True)
class Float32Codec(Codec):
    bits: int = 32

    def encode_fn(self, prepped):
        u = _tensor(prepped).to(torch.float32).contiguous().view(torch.int32)
        # u < 0 tests the sign bit (a >> 31 of int32 storage sign-extends)
        return torch.where(u < 0, ~u, u | _SIGN)[:, None]

    def decode(self, words):
        code = words[:, 0]
        u = torch.where(code < 0, code ^ _SIGN, ~code)
        return u.contiguous().view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Float64Codec(Codec):
    """Two-word code.  :meth:`prepare` is a pure bitcast — each float64
    as its two int32 halves ``(n, 2)``, low word first as the device
    (little-endian) stores it — and the sign-magnitude transform runs on
    the halves in :meth:`encode_fn`: the sign lives in the high word's
    top bit, so negative values complement both halves and non-negative
    values set only the high half's sign bit."""

    bits: int = 64

    def prepare(self, col):
        x = _tensor(col).to(torch.float64)
        if x.stride() != (1,):
            # a 0-row array from numpy has stride (0,), which .contiguous()
            # keeps and the bitcast to int32 halves refuses
            x = x.clone(memory_format=torch.contiguous_format)
        return x.view(torch.int32).view(-1, 2)

    def encode_fn(self, prepped):
        lo, hi = prepped[:, 0], prepped[:, 1]
        neg = hi < 0
        return torch.stack([torch.where(neg, ~hi, hi | _SIGN),
                            torch.where(neg, ~lo, lo)], dim=1)

    def decode(self, words):
        hi, lo = words[:, 0], words[:, 1]
        pos = hi < 0  # code's top bit set: the value was non-negative
        halves = torch.stack([torch.where(pos, lo, ~lo),
                              torch.where(pos, hi ^ _SIGN, ~hi)], dim=1)
        return halves.contiguous().view(torch.float64)[:, 0]


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """One component of a composite key: its codec + sort direction."""

    codec: Codec
    ascending: bool = True


class CompositeCodec(Codec):
    """Multi-column key: component codes packed MSB-first in key-priority
    order; descending components are bit-inverted within their width, so
    one unsigned sort realizes any asc/desc mix.  ``encode`` takes a
    sequence of columns (one per spec), ``decode`` returns the tuple back.
    Composites compare and hash by value (their specs), so two queries
    over equal-typed key columns share one cached sort chain."""

    def __init__(self, specs: Sequence[ColumnSpec]):
        if not specs:
            raise ValueError("composite key needs at least one column")
        self.specs = tuple(specs)
        self.bits = sum(s.codec.bits for s in self.specs)

    def __eq__(self, other):
        return type(other) is CompositeCodec and self.specs == other.specs

    def __hash__(self):
        return hash(self.specs)

    def _component_chunks(self, spec: ColumnSpec, words: torch.Tensor):
        """A component's code as (word, width) chunks, inverted if
        descending (order reversal within the component's bits)."""
        chunks = []
        for j, wbits in enumerate(word_widths(spec.codec.bits)):
            w = words[:, j]
            if not spec.ascending:
                w = w ^ _mask(wbits)
            chunks.append((w & _mask(wbits), wbits))
        return chunks

    def _check_count(self, got: int) -> None:
        if got != len(self.specs):
            raise ValueError(f"composite expects {len(self.specs)} columns, "
                             f"got {got}")

    def prepare(self, cols):
        cols = list(cols)
        self._check_count(len(cols))
        return tuple(spec.codec.prepare(col)
                     for spec, col in zip(self.specs, cols))

    def encode_fn(self, prepped) -> torch.Tensor:
        self._check_count(len(prepped))
        chunks = []
        for spec, pre in zip(self.specs, prepped):
            chunks.extend(
                self._component_chunks(spec, spec.codec.encode_fn(pre)))
        first = chunks[0][0]
        zeros = torch.zeros_like(first)
        out, cur, used = [], zeros, 0
        for arr, w in chunks:
            while w > 0:
                take = min(32 - used, w)
                # the arithmetic shift's sign fill lies above the kept bits
                piece = (arr >> (w - take)) & _mask(take)
                cur = piece if take == 32 else ((cur << take) | piece)
                used += take
                w -= take
                if used == 32:
                    out.append(cur)
                    cur, used = zeros, 0
        if used:
            out.append(cur)
        return torch.stack(out, dim=1)

    def _extract(self, words: torch.Tensor, bit: int, w: int) -> torch.Tensor:
        """The ``w``-bit (≤ 32) chunk at stream offset ``bit``."""
        widths = word_widths(self.bits)
        val = torch.zeros_like(words[:, 0])
        while w > 0:
            j, consumed = 0, 0
            while consumed + widths[j] <= bit:
                consumed += widths[j]
                j += 1
            off = bit - consumed
            take = min(widths[j] - off, w)
            piece = (words[:, j] >> (widths[j] - off - take)) & _mask(take)
            val = piece if take == 32 else ((val << take) | piece)
            bit += take
            w -= take
        return val

    def decode(self, words: torch.Tensor):
        cols, bit = [], 0
        for spec in self.specs:
            comp = []
            for wbits in word_widths(spec.codec.bits):
                chunk = self._extract(words, bit, wbits)
                if not spec.ascending:
                    chunk = chunk ^ _mask(wbits)
                comp.append(chunk)
                bit += wbits
            cols.append(spec.codec.decode(torch.stack(comp, dim=1)))
        return tuple(cols)


_DTYPE_CODECS = {
    "bool": BoolCodec(),
    "int8": IntCodec(8),
    "int16": IntCodec(16),
    "int32": IntCodec(32),
    "uint8": UIntCodec(8),
    "uint16": UIntCodec(16),
    "uint32": UIntCodec(32),
    "float32": Float32Codec(),
    "float64": Float64Codec(),
}


def infer_codec(col, bits: Optional[int] = None) -> Codec:
    """The order-preserving codec for a column's dtype (a torch tensor's
    or a numpy array's); ``bits`` narrows integer codecs when the value
    range is known, shrinking the plan."""
    name = str(col.dtype).removeprefix("torch.")
    codec = _DTYPE_CODECS.get(name)
    if codec is None:
        raise TypeError(f"no codec for column dtype {name}")
    if bits is not None and isinstance(codec, (IntCodec, UIntCodec)):
        codec = type(codec)(bits)
    return codec
