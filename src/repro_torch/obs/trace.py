"""Nested spans over the sort pipeline, off by default and near-free when off.

A span is a named, attributed wall-clock interval::

    with trace.span("stream.partition_sort", bytes_in=nbytes):
        ...

A span opened with a CUDA ``device`` (``trace.span("executor.pass",
u.device)``) is device-timed too: while spans are collected it records a
``torch.cuda.Event`` on the current stream as it opens and another as it
closes, and nothing waits for them until the collection ends
(:func:`stop`, or the exit of :func:`tracing`).  Then every finished span
is resolved once: its record gets ``device_s`` (the stream time between
its two events) where it has events, and its wall and device seconds are
observed into the process-wide registry (:mod:`repro_torch.obs.metrics`)
as the histograms ``span.<name>.wall_s`` and ``span.<name>.device_s``.

While a ``torch.profiler`` records, every span also opens a host range
of its name on the profiler's timeline (a non-user-scope record
function, so the profiler mirrors none of it on the device), whether or
not spans are collected: an exported profiler trace then shows the
port's phases around the kernels they launch.

Spans nest through a thread-local stack, so the executor's per-pass spans
land under the stream loop's phase spans without any plumbing.  Worker
threads (the ``REPRO_STREAM_WORKERS`` pool) don't inherit thread-locals;
:func:`wrap_ctx` captures the submitting thread's active span at submit
time and re-enters it around the pooled callable, keeping the tree
connected across the pool.

Collection is **env-gated by** ``REPRO_TRACE``: when off, and no profiler
records, :func:`span` returns a shared no-op handle after two global
reads (asserted by ``tests/test_torch_obs.py``).  :func:`tracing` turns
collection on for a scope (tests), :func:`suspended` turns it off for a
scope (benchmark timing loops must not pay per-span bookkeeping or fill
the buffer).

Finished spans become a :class:`Trace`: exportable as Chrome/Perfetto
trace-event JSON (:meth:`Trace.export` — load in ``ui.perfetto.dev``)
and as a machine-readable aggregate tree (:meth:`Trace.summary`) that
tests and CI gates assert on.

This module imports nothing of ``repro_torch`` outside this package:
every layer above imports it.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

from repro_torch.obs import metrics

__all__ = [
    "TRACE_ENV", "NULL", "Span", "Trace",
    "enabled", "span", "current", "under", "wrap_ctx",
    "start", "stop", "tracing", "suspended",
]

TRACE_ENV = "REPRO_TRACE"


class _NullSpan:
    """Shared do-nothing span handle returned whenever tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def annotate(self, key: str, value: Any) -> "_NullSpan":
        return self

    def end_device(self) -> None:
        pass


NULL = _NullSpan()


class _Range(_NullSpan):
    """A span that only opens a host range of its name on a recording
    profiler's timeline (spans are not being collected)."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self) -> "_Range":
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        return False


class _Collector:
    """Finished-span sink shared by all threads."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.spans: List[Dict[str, Any]] = []
        self.open_count = 0
        self._next_sid = 0
        # finished spans not yet resolved: (record, (start, end) events
        # or None)
        self._unresolved: List[tuple] = []

    def open(self) -> int:
        with self.lock:
            self._next_sid += 1
            self.open_count += 1
            return self._next_sid

    def close(self, record: Dict[str, Any], events) -> None:
        with self.lock:
            self.spans.append(record)
            self._unresolved.append((record, events))
            self.open_count -= 1

    def resolve(self) -> None:
        """Give every span finished since the last call its ``device_s``
        (waiting for its end event) and feed its wall and device seconds
        to the registry.  Each span is resolved once."""
        with self.lock:
            todo, self._unresolved = self._unresolved, []
        for record, events in todo:
            name = record["name"]
            metrics.histogram(f"span.{name}.wall_s").observe(
                record["t1"] - record["t0"])
            if events is None:
                continue
            start, end = events
            end.synchronize()
            record["device_s"] = start.elapsed_time(end) / 1e3
            metrics.histogram(f"span.{name}.device_s").observe(
                record["device_s"])


_collector: Optional[_Collector] = None
_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def enabled() -> bool:
    """True when a collector is installed (spans are being recorded)."""
    return _collector is not None


class Span:
    """A live span: ``with``-entered, attributes settable while open."""

    __slots__ = ("name", "attrs", "sid", "parent_sid", "t0", "_collector",
                 "_device", "_start", "_end", "_rf")

    def __init__(self, collector: _Collector, name: str,
                 attrs: Dict[str, Any],
                 device: Optional[torch.device] = None):
        self._collector = collector
        self.name = name
        self.attrs = attrs
        self.sid = collector.open()
        self.parent_sid: Optional[int] = None
        self.t0 = 0.0
        self._device = (device if device is not None
                        and device.type == "cuda" else None)
        self._start: Optional[torch.cuda.Event] = None
        self._end: Optional[torch.cuda.Event] = None
        self._rf = (torch._C._profiler._RecordFunctionFast(name)
                    if _profiler._is_profiler_enabled else None)

    def set(self, **attrs: Any) -> "Span":
        """Merge attributes into the span (overwrites same-named keys)."""
        self.attrs.update(attrs)
        return self

    def annotate(self, key: str, value: Any) -> "Span":
        """Append ``value`` to the list attribute ``key`` — the idiom for
        events-within-a-span (e.g. fault sites marking the active span)."""
        self.attrs.setdefault(key, []).append(value)
        return self

    def end_device(self) -> None:
        """End the span's device interval now, for a span whose rest only
        waits for the device (a sync launches nothing)."""
        if self._start is not None and self._end is None:
            self._end = self._event()

    def _event(self) -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        return event

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent_sid = stack[-1].sid
        stack.append(self)
        if self._rf is not None:
            self._rf.__enter__()
        if self._device is not None:
            self._start = self._event()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        events = None
        if self._start is not None:
            events = (self._start, self._end or self._event())
        if self._rf is not None:
            self._rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # mis-nested exit: drop self wherever it sits, keep going
            try:
                stack.remove(self)
            except ValueError:
                pass
        self._collector.close({
            "sid": self.sid, "parent": self.parent_sid, "name": self.name,
            "t0": self.t0, "t1": t1, "tid": threading.get_ident(),
            "attrs": dict(self.attrs),
        }, events)
        return False


def span(name: str, device: Optional[torch.device] = None, **attrs: Any):
    """Open a span (use as a context manager); ``device``, where the
    span's work runs, device-times it on a CUDA device.  With tracing
    off this returns a host range on a recording profiler's timeline,
    or, with no profiler either, the shared :data:`NULL` handle after
    two global reads."""
    collector = _collector
    if collector is None:
        if not _profiler._is_profiler_enabled:
            return NULL
        return _Range(name)
    return Span(collector, name, attrs, device)


class _ForeignParent:
    """A borrowed parent context installed at the base of a thread's
    stack by :func:`under` — only its ``sid`` matters."""

    __slots__ = ("sid",)

    def __init__(self, sid: int):
        self.sid = sid


def current():
    """The innermost open span on *this* thread (None outside any span,
    or when tracing is off).  The returned handle is only good for
    :func:`under` / :func:`wrap_ctx` parenting."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def under(ctx) -> Iterator[None]:
    """Adopt ``ctx`` (a handle from :func:`current`, possibly captured on
    another thread) as this thread's parent span for the scope."""
    if ctx is None:
        yield
        return
    stack = _stack()
    stack.append(_ForeignParent(ctx.sid))
    try:
        yield
    finally:
        if stack and isinstance(stack[-1], _ForeignParent):
            stack.pop()


def wrap_ctx(fn):
    """Capture the calling thread's span context *now*; return a callable
    that re-enters it wherever it runs — the pool-submission shim that
    keeps worker-thread spans parented under the submitter's phase span.
    Identity (zero wrapping) when tracing is off or no span is open."""
    if _collector is None:
        return fn
    ctx = current()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with under(ctx):
            return fn(*args, **kwargs)

    return run


def start() -> None:
    """Install the global collector (idempotent).  Called automatically
    at import when ``REPRO_TRACE`` is set truthy."""
    global _collector
    if _collector is None:
        _collector = _Collector()


def stop() -> "Trace":
    """Uninstall the collector, resolve its spans and return everything
    it recorded."""
    global _collector
    collector, _collector = _collector, None
    if collector is None:
        return Trace([], 0)
    collector.resolve()
    with collector.lock:
        return Trace(list(collector.spans), collector.open_count)


class _Session:
    """Handle yielded by :func:`tracing`; ``.trace`` is set at exit."""

    trace: Optional["Trace"] = None


def _swap(collector: Optional[_Collector]) -> Optional[_Collector]:
    global _collector
    prev, _collector = _collector, collector
    return prev


@contextlib.contextmanager
def tracing() -> Iterator[_Session]:
    """Collect spans for a scope, resolved at its exit.  Reentrant under
    an env-enabled global collector: the session then sees the spans
    finished inside the block (a windowed view) and global collection
    keeps running afterwards."""
    was_on = _collector is not None
    start()
    collector = _collector
    assert collector is not None
    with collector.lock:
        mark = len(collector.spans)
    session = _Session()
    try:
        yield session
    finally:
        collector.resolve()
        with collector.lock:
            spans = list(collector.spans[mark:])
            open_count = collector.open_count
        session.trace = Trace(spans, open_count)
        if not was_on:
            _swap(None)


@contextlib.contextmanager
def suspended() -> Iterator[None]:
    """Disable collection for a scope (timing loops: measure the work,
    not the tracer).  No-op when tracing is already off."""
    prev = _swap(None)
    try:
        yield
    finally:
        _swap(prev)


class Trace:
    """An immutable bag of finished spans with export + assertion views.

    Each span is a dict: ``sid``, ``parent`` (sid or None), ``name``,
    ``t0``/``t1`` (perf_counter seconds), ``tid``, ``attrs``, and
    ``device_s`` (stream seconds) where it was opened on a CUDA device.
    """

    #: attribute keys that count as byte traffic for aggregation
    BYTE_KEYS = ("bytes", "bytes_in", "bytes_out", "bytes_read",
                 "bytes_written")

    def __init__(self, spans: List[Dict[str, Any]], unclosed: int = 0):
        self.spans = spans
        self.unclosed = unclosed

    def find(self, name: str) -> List[Dict[str, Any]]:
        return [s for s in self.spans if s["name"] == name]

    def total(self, name: str, key: str) -> float:
        """Sum of numeric attribute ``key`` over spans named ``name``."""
        total = 0
        for s in self.find(name):
            v = s["attrs"].get(key, 0)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                total += v
        return total

    def span_bytes(self, s: Dict[str, Any]) -> int:
        """Byte traffic one span claims (sum over :data:`BYTE_KEYS`)."""
        total = 0
        for k in self.BYTE_KEYS:
            v = s["attrs"].get(k, 0)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                total += int(v)
        return total

    def assert_well_formed(self) -> None:
        """No unclosed spans, no orphaned parents, sane intervals."""
        assert self.unclosed == 0, (
            f"{self.unclosed} span(s) still open when the trace closed")
        sids = {s["sid"] for s in self.spans}
        for s in self.spans:
            parent = s["parent"]
            assert parent is None or parent in sids, (
                f"span {s['name']!r} (sid {s['sid']}) has orphaned "
                f"parent sid {parent}")
            assert s["t1"] >= s["t0"], f"span {s['name']!r} ends before it starts"

    def summary(self) -> Dict[str, Any]:
        """Aggregate tree keyed by span name along the parent path:
        ``{name: {count, wall_s, attrs: {summed numerics}, children}}``,
        and the summed ``device_s`` in a node whose spans carry it.
        Spans whose parent lies outside this trace window root the tree.
        """
        by_sid = {s["sid"]: s for s in self.spans}

        def node(tree: Dict[str, Any], name: str) -> Dict[str, Any]:
            return tree.setdefault(name, {
                "count": 0, "wall_s": 0.0, "attrs": {}, "children": {}})

        tree: Dict[str, Any] = {}
        for s in self.spans:
            path = []
            cursor: Optional[Dict[str, Any]] = s
            while cursor is not None:
                path.append(cursor["name"])
                parent = cursor["parent"]
                cursor = by_sid.get(parent) if parent is not None else None
            path.reverse()
            level = tree
            for name in path[:-1]:
                level = node(level, name)["children"]
            leaf = node(level, path[-1])
            leaf["count"] += 1
            leaf["wall_s"] += s["t1"] - s["t0"]
            if "device_s" in s:
                leaf["device_s"] = leaf.get("device_s", 0.0) + s["device_s"]
            for key, value in s["attrs"].items():
                if isinstance(value, (int, float)) and not isinstance(
                        value, bool):
                    leaf["attrs"][key] = leaf["attrs"].get(key, 0) + value
        return tree

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome/Perfetto trace-event JSON (complete 'X' events, µs)."""
        events = []
        pid = os.getpid()
        for s in self.spans:
            args = {}
            for key, value in s["attrs"].items():
                args[key] = value if isinstance(
                    value, (int, float, str, bool)) else str(value)
            if "device_s" in s:
                args["device_s"] = s["device_s"]
            events.append({
                "ph": "X", "cat": "repro", "name": s["name"],
                "pid": pid, "tid": s["tid"],
                "ts": s["t0"] * 1e6, "dur": (s["t1"] - s["t0"]) * 1e6,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        """Write Perfetto-loadable JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")

    def __len__(self) -> int:
        return len(self.spans)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Trace({len(self.spans)} spans, {self.unclosed} unclosed)"


def _env_enabled() -> bool:
    value = os.environ.get(TRACE_ENV, "").strip().lower()
    return value not in ("", "0", "false", "off", "no")


if _env_enabled():
    start()
