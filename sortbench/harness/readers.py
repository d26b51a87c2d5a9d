"""The arithmetic the metric readers share (``metrics/<name>.py``).

Each reader takes the :class:`~sortbench.harness.cell.RunRecord` and
returns a number, or None where the run holds nothing to read; a None is
left out of the result line, never written as 0."""

from __future__ import annotations

from sortbench.harness import peaks


def per_request(record, seconds):
    """``seconds`` of the traced window's device time a completed
    request, in ms."""
    tr = record.trace
    if tr is None or not tr.requests:
        return None
    return 1e3 * seconds(tr) / tr.requests


def idle_pct(record):
    tr = record.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * tr.idle_share


def port_kernel_ms(record):
    return per_request(record, lambda tr: tr.port_kernel_s)


def torch_op_ms(record):
    return per_request(record, lambda tr: tr.other_device_s)


def pass_ms(record):
    if record.pass_s is None or not record.span_requests:
        return None
    return 1e3 * record.pass_s / record.span_requests


def sort_roofline_pct(record):
    """The least time of the window's sorts (each key read once, each
    output element written once, at the card's published HBM rate) over
    the device-busy time a sort, in %."""
    tr, done = record.trace, record.window.done
    if tr is None or not done or tr.busy_s <= 0:
        return None
    least = sum(peaks.bound_s(peaks.sort_min_bytes(r.work)) for r in done)
    return 100.0 * least / tr.busy_s


def rate(record, work) -> float | None:
    """``work(request)`` summed over the window's completed requests,
    over the window's seconds."""
    w = record.window
    if not w.done or w.seconds <= 0:
        return None
    return sum(work(r) for r in w.done) / w.seconds

