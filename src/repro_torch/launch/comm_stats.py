"""Per-rank FLOPs, bytes, collective traffic and peak memory of a program
as it runs (the port's counterpart of ``repro.launch.hlo_stats``).

The reference parses the SPMD-partitioned HLO that XLA compiles.  The
port has no HLO: it runs rank 0's program op by op, on the ``meta``
device for the dry-run (:mod:`repro_torch.launch.dryrun`), under
:class:`CommStats`, a ``TorchDispatchMode`` that sees every ATen and
``c10d`` op below autograd (backward included) and records:

* every ``c10d`` collective: its kind (the reference's names:
  ``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), its result bytes and its group's size, read
  from the process group it runs on; costed with the reference's ring
  model (:func:`_wire_bytes`).  A collective over a one-rank group is not
  issued at all (the port skips it), so none is recorded.  bf16
  collectives count at bf16 width: nothing is promoted, so the
  reference's halving of ``*_promoted`` f32 reductions has no
  counterpart;
* matmul FLOPs, ``2 M N K`` a product (``mm``, ``bmm``, ``addmm``,
  ``baddbmm`` through ``torch.utils.flop_counter``'s formulas), as the
  reference's ``_dot_flops`` counts each ``dot``;
* bytes read and written, op by op (:meth:`CommStats.analyze`);
* the peak of the bytes held by tensors the program allocated while the
  mode was on (:attr:`CommStats.peak_bytes`): each new output adds its
  bytes and a ``weakref.finalize`` on it takes them off when it dies.
  Tensors made before the mode (parameters, inputs) are not in it.

Loops need no trip counts: a layer loop runs, and each of its ops is seen
as often as it runs.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["CollectiveOp", "CommStats", "summarize"]

_aten = torch.ops.aten


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    wire_bytes: float  # per-device ring-model bytes, x loop multiplier
    multiplier: int = 1


def _wire_bytes(kind: str, rb: int, d: int) -> float:
    """Per-device wire bytes of one collective of result bytes ``rb`` over
    ``d`` ranks (a ring: reduce-scatter + all-gather for an all-reduce)."""
    if kind == "all-reduce":
        return 2.0 * rb * (d - 1) / d
    if kind == "all-gather":
        return rb * (d - 1) / d
    if kind == "reduce-scatter":
        return float(rb) * (d - 1)
    if kind == "all-to-all":
        return rb * (d - 1) / d
    return float(rb)  # collective-permute


def summarize(ops):
    """``{"by_kind": {kind: {"count", "wire_bytes", "result_bytes"}},
    "total_wire_bytes", "count"}`` of a list of :class:`CollectiveOp`."""
    by_kind: dict = {}
    for op in ops:
        rec = by_kind.setdefault(op.kind, {"count": 0, "wire_bytes": 0.0,
                                           "result_bytes": 0})
        rec["count"] += 1
        rec["wire_bytes"] += op.wire_bytes
        rec["result_bytes"] += op.result_bytes
    total = sum(r["wire_bytes"] for r in by_kind.values())
    return {"by_kind": by_kind, "total_wire_bytes": total,
            "count": sum(r["count"] for r in by_kind.values())}


# c10d op name -> (kind, index of the argument holding the result)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
    "broadcast_": ("broadcast", 0),
}
_MATMULS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
# allocate without writing
_ALLOC = {"empty", "new_empty", "empty_like", "empty_strided",
          "new_empty_strided"}
# read only the gathered rows (and the indices), not the whole source
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@functools.cache
def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd decomposition."""
    return func.namespace != "c10d" and torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CompositeImplicitAutograd")


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name(
                ).endswith("c10d.ProcessGroup"):
            return torch.distributed.ProcessGroup.unbox(a).size()
    raise ValueError("a c10d op without a process group")


class CommStats(TorchDispatchMode):
    """Records what the ops run under it do (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.flops = 0.0
        self.bytes_read = 0.0
        self.bytes_written = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # a composite op (``matmul`` under inference mode) through its
            # parts, as autograd would have split it
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            if name in _C10D:
                kind, at = _C10D[name]
                rb = sum(_nbytes(t) for t in _tensors(args[at]))
                d = _group_size(args)
                self.ops.append(CollectiveOp(kind, rb, d,
                                             _wire_bytes(kind, rb, d)))
            return out
        if func.is_view:
            return out
        packet = func._overloadpacket
        if packet in _MATMULS:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        name = packet.__name__
        if name in _ALLOC:
            read = written = 0
        else:
            ins = _tensors((args, kwargs))
            written = sum(_nbytes(t) for t in outs)
            if name in _GATHERS:
                read = written + sum(_nbytes(t) for t in ins
                                     if not t.is_floating_point())
            else:
                read = sum(_nbytes(t) for t in ins)
        self.bytes_read += read
        self.bytes_written += written
        if not any(r.alias_info for r in func._schema.returns):
            for t in outs:
                n = _nbytes(t)
                self.live_bytes += n
                weakref.finalize(t, self._free, n)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out

    def analyze(self) -> dict:
        """The reference's ``hlo_stats.analyze`` keys, per rank:

        * ``flops``: matmul FLOPs, 2MNK a product;
        * ``bytes_read`` / ``bytes_written``: each ATen op reads its
          tensor inputs once and writes its outputs once (a gather reads
          the rows it gathers and its indices; an allocation moves
          nothing; views move nothing).  Ops are unfused, so this counts
          every intermediate that an XLA fusion would keep out of memory:
          it is the eager program's traffic, above the reference's
          fusion-level model;
        * ``collectives``: :func:`summarize` of the recorded ops."""
        return {"flops": self.flops, "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "collectives": summarize(self.ops)}
