"""Observability: spans + one metrics registry over the whole pipeline.

- :mod:`repro_torch.obs.trace` — nested spans (env-gated by ``REPRO_TRACE``),
  device-timed on a CUDA device, mirrored as host ranges on a recording
  profiler's timeline, fed to the registry; Perfetto export,
  machine-readable summary tree.
- :mod:`repro_torch.obs.metrics` — the process-wide counter/gauge/histogram
  registry every repo layer feeds.
- :func:`bandwidth_report` — measured per-phase byte traffic from a
  trace, side-by-side with the analytic model's prediction: the check
  on the paper's bandwidth-efficiency claim.

Import-order contract: nothing in this package imports ``repro_torch.*``
outside it — ``core/dispatch.py``, ``core/faults.py`` and the stream
stores all sit *above* it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.obs import metrics, trace
from repro_torch.obs.trace import (NULL, Span, Trace, current, enabled, span,
                             start, stop, suspended, tracing, under,
                             wrap_ctx)

__all__ = [
    "metrics", "trace", "bandwidth_report",
    "NULL", "Span", "Trace", "current", "enabled", "span", "start",
    "stop", "suspended", "tracing", "under", "wrap_ctx",
]


def bandwidth_report(tr: Trace,
                     analytic: Optional[Any] = None) -> Dict[str, Any]:
    """Measured per-phase traffic from a :class:`~repro_torch.obs.trace.Trace`,
    next to the analytic model when given a
    :class:`~repro_torch.core.fractal_sort.SortStats`.

    Every span carrying byte attributes (``bytes``, ``bytes_in``,
    ``bytes_out``, ``bytes_read``, ``bytes_written``) contributes its
    traffic and its seconds to its phase (= span name): its ``device_s``
    where it was device-timed, its host wall otherwise (the CPU); phases
    report achieved ``bytes_per_s``.  With ``analytic``, the useful traffic
    ``2 * n * key_bytes`` (one read + one write of the packed keys —
    the same numerator :func:`benchmarks.bench_bandwidth.b_eff` uses)
    divides both the analytic and the measured byte totals, so
    ``measured_b_eff`` lands beside ``analytic_b_eff``: how much of the
    model's predicted efficiency the implementation actually achieves
    in bytes it really moved.
    """
    phases: Dict[str, Dict[str, Any]] = {}
    for s in tr.spans:
        nbytes = tr.span_bytes(s)
        if not nbytes:
            continue
        phase = phases.setdefault(
            s["name"], {"bytes": 0, "seconds": 0.0, "count": 0})
        phase["bytes"] += nbytes
        phase["seconds"] += s.get("device_s", s["t1"] - s["t0"])
        phase["count"] += 1
    for phase in phases.values():
        phase["bytes_per_s"] = (
            phase["bytes"] / phase["seconds"] if phase["seconds"] > 0
            else None)
    bytes_total = sum(p["bytes"] for p in phases.values())
    seconds = sum(p["seconds"] for p in phases.values())
    report: Dict[str, Any] = {
        "phases": phases,
        "measured_bytes_total": bytes_total,
        "measured_seconds": seconds,
        "measured_bytes_per_s": (
            bytes_total / seconds if seconds > 0 else None),
    }
    if analytic is not None:
        key_bytes = 4 if analytic.p > 16 else 2
        useful = 2 * analytic.n * key_bytes
        report["analytic_bytes_total"] = analytic.bytes_total
        report["analytic_b_eff"] = useful / analytic.bytes_total
        report["measured_b_eff"] = (
            useful / bytes_total if bytes_total else None)
    return report
