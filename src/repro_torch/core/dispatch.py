"""Dispatch accounting: how many chain programs a code path ran.

Port of ``repro.core.dispatch``.  The query layer's structural invariant
is a dispatch count — a warm ``order_by`` is one used-bits probe plus
one sort chain, whatever the number of key words, passes or payload
columns — and this module counts executions at the port's own call
sites, so tests assert the invariant directly instead of inferring it
from timings.

Nothing compiles in the port, so :func:`wrap` counts calls.  A chain is
made by an ``lru_cache``-d factory, once per configuration (codec,
active words, plans, backend); the first call of each built chain counts
under ``<tag>:compiles``, so a compile here is a cache miss: a new chain
configuration.

Every count also lands in :mod:`repro_torch.obs.metrics` as
``dispatch.<tag>`` / ``dispatch.<tag>.compiles``.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Callable, Dict

from repro_torch.obs import metrics

__all__ = ["counts", "record", "snapshot_delta", "track", "wrap"]

_counts: Counter = Counter()
_lock = threading.Lock()


def record(tag: str, compiles: int = 0) -> None:
    """Count one execution under ``tag`` (and ``compiles`` new chain
    configurations it built)."""
    with _lock:
        _counts[tag] += 1
        if compiles:
            _counts[tag + ":compiles"] += compiles
    metrics.counter(f"dispatch.{tag}").inc()
    if compiles:
        metrics.counter(f"dispatch.{tag}.compiles").inc(compiles)


def counts() -> Dict[str, int]:
    """All counters since process start (tag → executions; ``:compiles``
    suffixed tags count new chain configurations at the same site)."""
    with _lock:
        return dict(_counts)


def snapshot_delta(before: Dict[str, int]) -> Dict[str, int]:
    """Counters accumulated since ``before`` (a :func:`counts` snapshot),
    zero entries dropped."""
    now = counts()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}


@contextlib.contextmanager
def track():
    """Scoped counting: ``with track() as seen: ...`` — after the block,
    ``seen`` holds only the counters the block accumulated."""
    before = counts()
    seen: Dict[str, int] = {}
    try:
        yield seen
    finally:
        seen.update(snapshot_delta(before))


def wrap(tag: str, fn: Callable) -> Callable:
    """Count every call of ``fn`` under ``tag``; the first call of a
    wrapped function also counts as a compile.  Call it where a cached
    factory creates the chain, so each cache miss wraps a new function
    and counts one compile, however many threads race its first call."""
    state_lock = threading.Lock()
    fresh = [True]

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        with state_lock:
            first, fresh[0] = fresh[0], False
        record(tag, compiles=int(first))
        return out

    wrapped.__wrapped__ = fn
    return wrapped
