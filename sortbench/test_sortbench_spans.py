"""The metrics that read the port's spans, on the CPU.  A traced run
there has no device trace, so it leaves them out (the harness reads no
per-layer metric of the card's on the CPU but the pass walls); the
readers' arithmetic is checked on the registry that run fed."""

import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from sortbench.harness.cell import run_cell  # noqa: E402
from sortbench.harness.manifest import load_cell, load_module  # noqa: E402

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
DEVICE_PHASES = ("digit_ms.sort", "rank_ms.sort", "scatter_ms.sort")


def run(name):
    cell = load_cell(name)
    return run_cell(cell, (1 << 33) + 29, 0.05, True, torch.device("cpu"),
                    time.perf_counter(), size=cell.config["test_size"])


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reads_the_plan_and_no_device_phase(name):
    from repro_torch.obs import metrics

    result = run(name)
    assert result["correct"], result["checks"]
    for metric in DEVICE_PHASES + ("plan_ms.sort",):
        assert metric not in result["metrics"], metric
    # read as on the card, from the registry the run's spans fed
    card = types.SimpleNamespace(trace=object())
    snap = metrics.snapshot()
    plan = load_module("metrics", "plan_ms.sort").read(card)
    assert plan == pytest.approx(1e3 * snap["span.sort.plan.wall_s"]["sum"]
                                 / snap["span.sort.call.wall_s"]["count"])
    assert plan > 0
    for metric in DEVICE_PHASES:  # the CPU times no span on a device
        assert load_module("metrics", metric).read(card) is None, metric
