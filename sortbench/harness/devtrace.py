"""The device timeline of a traced window, from ``torch.profiler``.

The window runs inside the profiler between two marker kernels
(``torch.cuda._sleep``), and inside a ``record_function`` span that
gives its bounds on the profiler's clock.  A trace that lacks a marker,
or holds fewer of the port's kernels than its launch counters say were
launched, dropped kernels: it is traced again, and after the last try
the run fails rather than report what the trace lacks.

From the device events (kernels, copies, memsets) inside the window:
the seconds in which something ran on the device (their union), the
device seconds in the port's own kernels and in everything else (torch's
operators), the operations that took most time, and the idle gaps by
what the host was doing meanwhile."""

from __future__ import annotations

import bisect
import dataclasses
import re
import sys
import time

import torch

WINDOW_LABEL = "sortbench.window"
REQUEST_LABEL = "sortbench.request."
MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
# the port's kernels are defined in an anonymous namespace of
# src/repro_torch/kernels/csrc/*.cu; torch's live in at::, cub::, etc.
PORT_KERNEL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")
# the launch counters whose launches each give at least one kernel of the
# port's on the device (K1's counter counts its sweeps and cluster
# launches too; K2 above 256 bins is four kernels a count)
COUNTED = ("fractal_histogram", "fractal_rank_kernel",
           "fractal_rank_scatter_kernel", "fractal_reconstruct",
           "flash_attention_kernel")
TOP = 10


class TraceIncomplete(RuntimeError):
    """The profiler's trace lacks device work that was launched."""


@dataclasses.dataclass
class DeviceTrace:
    window_s: float          # the traced window on the profiler's clock
    busy_s: float            # union of the device events inside it
    port_kernel_s: float     # device seconds in the port's kernels
    other_device_s: float    # device seconds in every other device event
    port_kernels: int        # the port's kernels in the window
    device_ops: list         # [[name, seconds], ...], most time first
    idle_gaps: list          # [[what the host did, seconds], ...]
    requests: int            # requests that completed in the window

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _is_device(ev) -> bool:
    """A device operation: a kernel, copy or memset on the device's
    timeline (the profiler mirrors each ``record_function`` span there as
    a user annotation, which is no operation)."""
    return ("CUDA" in str(ev.device_type)
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("sortbench."))


def _short(name: str) -> str:
    m = PORT_KERNEL.match(name)
    if m:
        return m.group(1)
    return name if len(name) <= 90 else name[:87] + "..."


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label_gaps(gaps: list, cpu: list) -> dict:
    """Seconds of idle device time by what the host was doing at each
    gap's middle: the innermost host event there (a torch operator or a
    CUDA runtime call), under the request kind whose span holds it."""
    cpu = sorted(cpu, key=lambda e: e[0])
    starts = [e[0] for e in cpu]
    by_label: dict = {}
    active: list = []
    k = 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        hi = bisect.bisect_right(starts, mid)
        active.extend(cpu[k:hi])
        k = max(k, hi)
        active = [e for e in active if e[1] >= mid]
        kind, inner = "between requests", None
        for e in active:
            if e[2].startswith(REQUEST_LABEL):
                kind = e[2][len(REQUEST_LABEL):]
            elif e[2] != WINDOW_LABEL and (inner is None or e[0] >= inner[0]):
                inner = e
        what = f"{kind}: {inner[2] if inner else 'host code outside torch ops'}"
        by_label[what] = by_label.get(what, 0.0) + (g1 - g0) / 1e6
    return by_label


def reduce_events(events, requests: int, launched: int) -> DeviceTrace:
    """:class:`DeviceTrace` of the window in ``events`` (the profiler's
    ``events()``); ``launched`` is the port's kernel launches its
    counters saw in the window."""
    window = [e for e in events if e.name == WINDOW_LABEL
              and "CUDA" not in str(e.device_type)]
    if len(window) != 1:
        raise TraceIncomplete(f"the trace holds {len(window)} window spans")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev = [(e.time_range.start, e.time_range.end, e.name)
           for e in events if _is_device(e)]
    markers = sum(MARKER in name for _, _, name in dev)
    inside = [(max(a, w0), min(b, w1), name) for a, b, name in dev
              if MARKER not in name and b > w0 and a < w1]
    port = [(a, b, n) for a, b, n in inside if PORT_KERNEL.match(n)]
    if launched and not port:
        raise TraceIncomplete(
            f"the profiler recorded no kernel of the port's while its "
            f"counters saw {launched} launches in the window")
    if markers != 2 or len(port) < launched:
        raise TraceIncomplete(
            f"the trace holds {markers} of its 2 marker kernels and "
            f"{len(port)} of the port's kernels, of at least {launched} "
            f"launched")
    busy = _union([(a, b) for a, b, _ in inside])
    busy_us = sum(b - a for a, b in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    ops: dict = {}
    for a, b, n in inside:
        ops[_short(n)] = ops.get(_short(n), 0.0) + (b - a) / 1e6
    cpu = [(e.time_range.start, e.time_range.end, e.name)
           for e in events if "CUDA" not in str(e.device_type)]
    idle = _label_gaps(gaps, cpu)
    port_s = sum(b - a for a, b, _ in port) / 1e6
    return DeviceTrace(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        port_kernel_s=port_s,
        other_device_s=sum(b - a for a, b, _ in inside) / 1e6 - port_s,
        port_kernels=len(port),
        device_ops=sorted(([k, v] for k, v in ops.items()),
                          key=lambda kv: -kv[1])[:TOP],
        idle_gaps=sorted(([k, v] for k, v in idle.items()),
                         key=lambda kv: -kv[1])[:TOP],
        requests=requests)


def launched_total(before: dict, after: dict) -> int:
    return sum(after.get(k, 0) - before.get(k, 0) for k in COUNTED)


def traced(run_window, launch_counts, device, tries: int = 3):
    """``run_window(label)`` under the profiler: returns (its window,
    :class:`DeviceTrace`).  ``label(kind)`` is the context manager the
    loop wraps each request in.  Traces again where the trace is not
    whole (see the module's doc), at most ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def label(kind):
        return record_function(REQUEST_LABEL + kind)

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    for attempt in range(1, tries + 1):
        before = launch_counts()
        with profile(activities=activities) as prof:
            if cuda:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize(device)
            with record_function(WINDOW_LABEL):
                window = run_window(label)
            if cuda:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize(device)
        launched = launched_total(before, launch_counts())
        if not cuda:
            return window, None
        try:
            t0 = time.perf_counter()
            events = prof.events()
            reduced = reduce_events(events, len(window.done), launched)
            print(f"[trace] {len(events)} profiler events reduced in "
                  f"{time.perf_counter() - t0:.1f} s; {reduced.port_kernels} "
                  f"kernels of the port's for {launched} counted launches",
                  file=sys.stderr, flush=True)
            return window, reduced
        except TraceIncomplete as exc:
            if attempt == tries:
                raise
            print(f"[trace] try {attempt} of {tries}: {exc}; tracing again",
                  file=sys.stderr, flush=True)
