"""One process-wide metrics registry for every counter in the repo.

The repo grew four disjoint counter islands — ``core/dispatch.py`` jit-site
counts, ``RunStore.events`` + put/get logs, ``core/faults.py`` retry loops,
autotune consult counts — each with its own ad-hoc snapshot idiom.  This
module is the single sink they all feed: named :class:`Counter` /
:class:`Gauge` / :class:`Histogram` instruments plus structured
:func:`event` records, created on first touch and process-wide for the
life of the interpreter (like ``dispatch``'s counts, values are monotone;
tests diff with :func:`snapshot_delta` instead of resetting).

Histograms keep a bounded reservoir of the most recent observations and
answer p50/p99 — the serving-layer latency primitive the ROADMAP's
sort-as-a-service item builds on, via :func:`track`.

Deliberately dependency-free (stdlib only, no ``repro_torch.*`` imports):
``dispatch``, ``faults``, ``chunks`` and ``autotune`` all import this
module, so it must sit below every other layer.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "event", "events",
    "snapshot", "snapshot_delta", "track",
]

# Newest-wins sample window per histogram: big enough that p99 over a
# bench run is stable, small enough that a million observations cost a
# fixed ~32 KB.  Serving cares about *recent* latency, so a ring (not a
# decaying reservoir) is the right bias.
_RESERVOIR = 4096

# Structured events kept per name; older events fall off but the paired
# ``<name>.count`` counter keeps the exact total.
_MAX_EVENTS = 4096


class Counter:
    """Monotone named counter (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, amount: int = 1) -> None:
        with self._lock:
            self._value += int(amount)

    @property
    def value(self) -> int:
        return self._value

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-write-wins named value, with a high-water mark."""

    __slots__ = ("name", "_value", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            if value > self._max:
                self._max = value

    def set_max(self, value: float) -> None:
        """Raise the gauge to ``value`` if higher (peak-tracking idiom)."""
        with self._lock:
            if value > self._value:
                self._value = value
            if value > self._max:
                self._max = value

    @property
    def value(self) -> float:
        return self._value

    @property
    def max(self) -> float:
        return self._max

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Gauge({self.name}={self._value})"


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus quantiles
    over a bounded ring of the most recent observations."""

    __slots__ = ("name", "count", "sum", "min", "max", "_ring", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._ring: collections.deque = collections.deque(maxlen=_RESERVOIR)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            self._ring.append(v)

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the retained window (None if empty)."""
        assert 0.0 <= q <= 1.0
        with self._lock:
            samples = sorted(self._ring)
        if not samples:
            return None
        idx = min(len(samples) - 1, int(q * len(samples)))
        return samples[idx]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            samples = sorted(self._ring)
            out: Dict[str, Any] = {
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
            }
        if samples:
            for label, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
                idx = min(len(samples) - 1, int(q * len(samples)))
                out[label] = samples[idx]
        return out

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Histogram({self.name}, n={self.count})"


class Registry:
    """Name → instrument map.  A name is bound to one instrument kind for
    the process's lifetime; re-requesting it with another kind raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}
        self._events: Dict[str, collections.deque] = {}

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(inst).__name__}, "
                    f"not a {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def event(self, name: str, **fields: Any) -> None:
        """Record a structured event (bounded ring per name) and bump the
        paired ``<name>.count`` counter (exact even past the ring)."""
        with self._lock:
            ring = self._events.get(name)
            if ring is None:
                ring = self._events[name] = collections.deque(
                    maxlen=_MAX_EVENTS)
            ring.append(dict(fields))
        self.counter(name + ".count").inc()

    def events(self, name: str) -> List[Dict[str, Any]]:
        with self._lock:
            ring = self._events.get(name)
            return [dict(e) for e in ring] if ring is not None else []

    def snapshot(self) -> Dict[str, Any]:
        """All instruments as plain values: counters/gauges → numbers,
        histograms → summary dicts.  Serializable as-is."""
        with self._lock:
            items = list(self._instruments.items())
        out: Dict[str, Any] = {}
        for name, inst in items:
            if isinstance(inst, Counter):
                out[name] = inst.value
            elif isinstance(inst, Gauge):
                out[name] = inst.value
            else:
                out[name] = inst.summary()
        return out

    def snapshot_delta(self, before: Dict[str, Any]) -> Dict[str, Any]:
        """Numeric instruments that changed since ``before`` (a prior
        :meth:`snapshot`), as deltas.  Histogram summaries are skipped —
        diff their ``count`` via the snapshot directly if needed."""
        now = self.snapshot()
        delta: Dict[str, Any] = {}
        for name, value in now.items():
            if not isinstance(value, (int, float)):
                continue
            prev = before.get(name, 0)
            if not isinstance(prev, (int, float)):
                prev = 0
            if value != prev:
                delta[name] = value - prev
        return delta

    @contextlib.contextmanager
    def track(self, name: Optional[str] = None) -> Iterator[Dict[str, Any]]:
        """Per-request accounting scope (the serving primitive): yields a
        dict filled at exit with the wall time and every numeric metric
        delta that landed during the block.  With ``name``, also feeds
        ``<name>.latency_s`` (p50/p99-capable) and ``<name>.requests``.
        """
        before = self.snapshot()
        out: Dict[str, Any] = {}
        t0 = time.perf_counter()
        try:
            yield out
        finally:
            wall = time.perf_counter() - t0
            out.update(self.snapshot_delta(before))
            out["wall_s"] = wall
            if name is not None:
                self.histogram(name + ".latency_s").observe(wall)
                self.counter(name + ".requests").inc()


#: The process-wide registry every repo layer feeds.
REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def event(name: str, **fields: Any) -> None:
    REGISTRY.event(name, **fields)


def events(name: str) -> List[Dict[str, Any]]:
    return REGISTRY.events(name)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def snapshot_delta(before: Dict[str, Any]) -> Dict[str, Any]:
    return REGISTRY.snapshot_delta(before)


def track(name: Optional[str] = None):
    return REGISTRY.track(name)
