"""The port's span totals, for the metric readers that read them.

With the port's spans collected (the traced run's requests after the
window, ``cell.span_pass_seconds``), every finished span feeds the
process-wide registry of ``repro_torch.obs.metrics``: its wall seconds
to the histogram ``span.<name>.wall_s``, and where the span was timed
on the device its stream seconds to ``span.<name>.device_s``.  A run is
one cell in one process, and the warm-up and the window run with the
spans off, so the registry's totals are those requests' alone."""

from __future__ import annotations

CALL = "sort.call"  # one span a call of a public sort entry


def ms_a_call(record, name: str, clock: str):
    """Summed ``clock`` seconds (``wall_s`` or ``device_s``) of the spans
    ``name`` over the ``sort.call`` spans, in ms.  None for a run with no
    device trace (on the CPU the harness reads no per-layer metric of the
    card's but the pass walls), and where either histogram has no
    observation (a port without such spans)."""
    if record.trace is None:
        return None
    from repro_torch.obs import metrics

    snap = metrics.snapshot()
    calls = snap.get(f"span.{CALL}.wall_s", {}).get("count", 0)
    total = snap.get(f"span.{name}.{clock}", {})
    if not calls or not total.get("count"):
        return None
    return 1e3 * total["sum"] / calls
