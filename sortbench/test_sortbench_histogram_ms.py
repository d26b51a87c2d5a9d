"""``histogram_ms.sort`` on the CPU: the K1 sweep's device ms a request,
read from a device trace's operations; nothing without a trace or
without the kernel."""

import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from sortbench.harness.devtrace import DeviceTrace  # noqa: E402
from sortbench.harness.manifest import load_module  # noqa: E402

READER = load_module("metrics", "histogram_ms.sort")


def record(ops, requests=171):
    trace = DeviceTrace(window_s=10.0, busy_s=9.8, port_kernel_s=5.0,
                        other_device_s=4.0, port_kernels=2000,
                        device_ops=ops, idle_gaps=[], requests=requests)
    return types.SimpleNamespace(trace=trace)


def test_the_sweep_kernel_over_the_requests():
    ops = [["scatter_words_kernel", 3.134], ["lookback_rank_kernel", 2.285],
           ["histogram_digits_kernel", 0.137]]
    assert READER.read(record(ops)) == pytest.approx(1e3 * 0.137 / 171)


@pytest.mark.parametrize("rec", [
    types.SimpleNamespace(trace=None),
    record([["lookback_rank_kernel", 2.285]]),
    record([["histogram_digits_kernel", 0.137]], requests=0)],
    ids=["no_trace", "no_sweep", "no_request"])
def test_nothing_to_read(rec):
    assert READER.read(rec) is None
