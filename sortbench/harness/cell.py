"""One run of one cell: set-up, the window, the judge, the metrics.

Device-agnostic: ``run.py`` refuses a machine without the card before it
calls :func:`run_cell`; the CPU tests call it on the CPU at small sizes.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import torch

from sortbench.harness import devtrace
from sortbench.harness.loop import (Sample, Window, closed_loop, request,
                                    synchronize, traffic_order)
from sortbench.harness.manifest import Cell, load_module

# the traced window is at most this long: the profiler's events of a
# longer one cost more to reduce than they add
TRACE_WINDOW_S = 10.0
# blocks of the mix in the traced run's pass of the port's spans
EXTRA_ROUNDS = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (``metrics/<name>.py``)."""

    cell: Cell
    setup_s: float
    window: Window                  # the measured window, or the traced one
    peak_bytes: Optional[int]       # device memory peak over set-up and window
    trace: Optional[devtrace.DeviceTrace] = None
    pass_s: Optional[float] = None  # executor.pass spans' seconds ...
    span_requests: int = 0          # ... over this many requests


@dataclasses.dataclass
class Setup:
    kinds: dict
    states: dict
    counters: dict


def set_up(cell: Cell, seed: int, device, size: Optional[int] = None) -> Setup:
    """The data from the seed, each kind's state, and one call of each
    request kind (the warm-up: every shape the window uses)."""
    t0 = time.perf_counter()
    kinds = {k: load_module("requests", k) for k in cell.traffic["kinds"]}
    t1 = time.perf_counter()
    data = load_module("datagen", cell.config["generator"]).make(
        cell.config, seed, device, size)
    synchronize(device)
    t2 = time.perf_counter()
    states = {k: m.prepare(data, cell.config) for k, m in kinds.items()}
    for k, m in kinds.items():
        log(f"[plan] {m.describe(states[k])}")
    counters = {k: 0 for k in kinds}
    warm = []
    for k, m in kinds.items():
        t = time.perf_counter()
        counters[k] += 1
        request(m, states[k], 0)
        synchronize(device)
        warm.append(f"{k} {time.perf_counter() - t:.2f} s")
    log(f"[setup] port imported in {t1 - t0:.2f} s, data made in "
        f"{t2 - t1:.2f} s, first calls: {', '.join(warm)}")
    return Setup(kinds, states, counters)


def issue(setup: Setup, kinds: list, device) -> None:
    """One more request of each of ``kinds``, each ended in a device
    synchronisation, their results dropped."""
    for kind in kinds:
        j = setup.counters[kind]
        setup.counters[kind] = j + 1
        request(setup.kinds[kind], setup.states[kind], j)
        synchronize(device)


def span_pass_seconds(setup: Setup, kinds: list, device) -> float:
    """Seconds of the port's ``executor.pass`` spans over one request of
    each of ``kinds`` (the spans end in a device synchronisation)."""
    from repro_torch.obs import trace

    trace.start()
    try:
        issue(setup, kinds, device)
    finally:
        spans = trace.stop()
    return sum(s["t1"] - s["t0"] for s in spans.find("executor.pass"))


def judge(setup: Setup, answers, limits: dict) -> dict:
    """``{name: (value, limit)}`` over ``answers``, (kind, answer) pairs:
    each kind's numbers, the largest over its answers, beside the
    configuration's limits; a kind with no answer judged reads as
    missing."""
    worst: dict = {}
    judged_kinds = set()
    for kind, judged in answers:
        judged_kinds.add(kind)
        for name, value in setup.kinds[kind].judge(setup.states[kind],
                                                   judged).items():
            worst[name] = max(worst.get(name, value), value)
        del judged
    missing = sum(k not in judged_kinds for k in setup.kinds)
    checks = {name: (value, limits[name]) for name, value in worst.items()}
    checks["kinds_unjudged"] = (missing, 0)
    return checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, size: Optional[int] = None) -> dict:
    """One run: the result's keys (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and
    ``checks``)."""
    cuda = torch.device(device).type == "cuda"
    setup = set_up(cell, seed, device, size)
    setup_s = time.perf_counter() - t_start
    order = traffic_order(cell.traffic, seed)
    # one block of the mix: each kind as often as its share
    block = [k for k, share in cell.traffic["kinds"].items()
             for _ in range(int(share))]
    record = RunRecord(cell, setup_s, None, None)
    window_s = min(seconds, TRACE_WINDOW_S) if trace else seconds
    samples = []

    def window(label=None):
        # a traced window that is run again draws its sample again; a
        # window holds at least one block of the mix, so every kind is
        # judged
        samples.clear()
        samples.append(Sample(seed, cell.traffic["kinds"], window_s))
        return closed_loop(order, setup.kinds, setup.states, setup.counters,
                           window_s, device, samples[0], label,
                           min_requests=len(block))

    if not trace:
        record.window = window()
    else:
        from repro_torch.kernels import ops

        record.window, record.trace = devtrace.traced(
            window, ops.launch_counts, device)
        extra = EXTRA_ROUNDS * block
        record.span_requests = len(extra)
        record.pass_s = span_pass_seconds(setup, extra, device)
    if cuda:
        record.peak_bytes = torch.cuda.max_memory_allocated(device)
        torch.cuda.empty_cache()
    for err in record.window.errors:
        log(f"[failed] {err}")
    checks = judge(setup, samples.pop().drain(), cell.config["limits"])
    checks["failed_requests"] = (record.window.failed, 0)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": record.peak_bytes or 0}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(record.window.requests),
              "failed": record.window.failed, "metrics": metrics,
              "device": dev}
    if record.trace is not None:
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        result["breakdown"] = {"device_ops": record.trace.device_ops,
                               "idle_gaps": record.trace.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result
