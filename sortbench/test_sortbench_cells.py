"""Each cell's run on the CPU at a small size, past the harness's look for
a card: a sound run is correct; a run with the port broken underneath
(each fault its request modules name: its state returned unchanged, half
of it left out, one answer altered where it is produced) is not; and the
control (the reference in the nearest lower precision) fails the
comparison.  On the card, the whole command for every cell.

Everything comes from the files the manifest names: the cells from
``BENCHMARK.json``, their sizes here from each configuration's
``test_size`` and ``control_test_size``, the faults from each request
module's ``PORT_ENTRY``, ``FAULTS`` and ``broken``."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from sortbench.harness.calibrate import (control_readings, fails,  # noqa: E402
                                         program_readings)
from sortbench.harness.cell import run_cell  # noqa: E402
from sortbench.harness.manifest import load_cell, load_module  # noqa: E402

CPU = torch.device("cpu")
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = (1 << 33) + 17


def kinds(name):
    return [load_module("requests", k)
            for k in load_cell(name).traffic["kinds"]]


# every (cell, fault) that some request kind of the cell can have
FAULTS = [(name, fault) for name in CELLS
          for fault in dict.fromkeys(f for mod in kinds(name)
                                     for f in mod.FAULTS)]


def run(name, trace=False, seed=SEED):
    cell = load_cell(name)
    return run_cell(cell, seed, 0.05, trace, CPU, time.perf_counter(),
                    size=cell.config["test_size"])


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = run(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert {"value", "limit"} <= set(next(iter(result["checks"].values())))


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_port_is_not_correct(monkeypatch, name, fault):
    for mod in kinds(name):
        if fault in mod.FAULTS:
            monkeypatch.setattr(mod, mod.PORT_ENTRY, mod.broken(
                fault, getattr(mod, mod.PORT_ENTRY)))
    result = run(name)
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_does_not(name):
    cell = load_cell(name)
    size = cell.config["control_test_size"]
    assert fails(cell, control_readings(cell, SEED + 1, CPU, size))
    assert not fails(cell, program_readings(cell, SEED + 2, 0.05, CPU, size))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_command_on_the_card(card, name):
    for trace in ("0", "1"):
        res = subprocess.run(
            [sys.executable, "sortbench/run.py", "--workload", name,
             "--seed", "2147483901", "--seconds", "2", "--trace", trace],
            cwd=ROOT, capture_output=True, text=True, timeout=360)
        assert res.returncode == 0, res.stderr[-4000:]
        result = json.loads(res.stdout.strip().splitlines()[-1])
        assert result["correct"], result["checks"]
        assert result["device"]["platform"] == "gpu"
        if trace == "1":
            assert 0 < result["device"]["busy_s"] <= result["device"][
                "window_s"]
