"""The data makers, the plain reference and the trace reduction, on the
CPU at small sizes: the makers repeat per seed, the reference agrees
with NumPy, the device timeline reduces as it should, and a traced run
reads what the CPU has to read."""

import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from sortbench.harness import devtrace  # noqa: E402
from sortbench.harness.cell import run_cell  # noqa: E402
from sortbench.harness.manifest import load_cell, load_module  # noqa: E402
from sortbench.reference import compare, sort as rsort  # noqa: E402

CPU = torch.device("cpu")


def config(name):
    return json.loads((ROOT / "sortbench" / "configs" / f"{name}.json")
                      .read_text())


def same_data(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_data(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same_data, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a,
                           b.view(torch.int32) if b.dtype == torch.uint32
                           else b)
    return a == b


CONFIGS = sorted(p.stem for p in (ROOT / "sortbench" / "configs")
                 .glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_data_makers_repeat_per_seed(name):
    cfg = config(name)
    size = cfg["test_size"]
    make = load_module("datagen", cfg["generator"]).make
    big = (1 << 40) + 12345
    a, b = make(cfg, big, CPU, size), make(cfg, big, CPU, size)
    c = make(cfg, big + 1, CPU, size)
    assert same_data(a, b)
    assert not same_data(a, c)


def u32_keys(rng, n, hi=1 << 32):
    raw = rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)
    return raw, torch.from_numpy(raw.view(np.int32)).view(torch.uint32)


@pytest.mark.parametrize("bits", [None, 16])
def test_sort_reference_agrees_with_numpy(bits):
    rng = np.random.default_rng(3)
    raw, keys = u32_keys(rng, 5000, hi=1 << 20)
    raw = raw.astype(np.int64) << 12  # duplicates, and the high bit used
    keys = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).view(
        torch.uint32)
    by = raw if bits is None else raw >> (32 - bits)
    perm = np.argsort(by, kind="stable")
    assert np.array_equal(rsort.stable_perm(keys, 32, bits).numpy(), perm)
    assert np.array_equal(rsort.sorted_keys(keys, 32, bits).numpy(),
                          raw[perm])


def test_compare_counts_mismatches():
    a = torch.tensor([1, 2, 3])
    assert compare.mismatches(a, torch.tensor([1, 2, 4])) == 1
    assert compare.mismatches(a, torch.tensor([1, 2])) == 3
    u = torch.tensor([-1, 5], dtype=torch.int32).view(torch.uint32)
    assert compare.mismatches(u, torch.tensor([0xFFFFFFFF, 5])) == 0
    assert compare.mismatches(torch.tensor([1.0, 2.5]),
                              torch.tensor([1, 2])) == 1


def ev(name, t0, t1, device=False):
    return SimpleNamespace(name=name, device_type="DeviceType.CUDA" if device
                           else "DeviceType.CPU",
                           time_range=SimpleNamespace(start=t0, end=t1))


def test_trace_reduction_busy_idle_and_labels():
    k = "void (anonymous namespace)::lookback_rank_kernel<16>(int)"
    events = [
        ev("void at::cuda::spin_kernel(long)", 0, 5, True),
        ev(devtrace.WINDOW_LABEL, 10, 110),
        ev(devtrace.REQUEST_LABEL + "fractal_sort", 10, 100),
        ev("aten::nonzero", 40, 60),
        ev("cudaStreamSynchronize", 45, 55),
        ev(k, 10, 40, True),
        ev("void at::native::scatter(...)", 30, 45, True),
        ev(k, 60, 100, True),
        ev("void at::cuda::spin_kernel(long)", 120, 125, True),
        # the profiler's device-side mirrors of the record_function spans
        ev(devtrace.WINDOW_LABEL, 10, 110, True),
        ev(devtrace.REQUEST_LABEL + "fractal_sort", 10, 100, True),
    ]
    tr = devtrace.reduce_events(events, requests=1, launched=2)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(75e-6)  # 10-45 and 60-100
    assert tr.port_kernel_s == pytest.approx(70e-6)
    assert tr.other_device_s == pytest.approx(15e-6)
    assert tr.idle_share == pytest.approx(0.25)
    assert tr.device_ops[0] == ["lookback_rank_kernel", pytest.approx(70e-6)]
    gaps = dict(tr.idle_gaps)
    assert gaps["fractal_sort: cudaStreamSynchronize"] == pytest.approx(15e-6)
    assert gaps["between requests: host code outside torch ops"] == \
        pytest.approx(10e-6)


def test_trace_reduction_refuses_a_trace_that_dropped_kernels():
    k = "(anonymous namespace)::histogram_digits_kernel(int)"
    whole = [ev("spin_kernel", 0, 1, True), ev(devtrace.WINDOW_LABEL, 2, 9),
             ev(k, 3, 4, True), ev("spin_kernel", 10, 11, True)]
    devtrace.reduce_events(whole, 1, 1)
    with pytest.raises(devtrace.TraceIncomplete):
        devtrace.reduce_events(whole, 1, 2)   # a launch the trace lacks
    with pytest.raises(devtrace.TraceIncomplete):
        devtrace.reduce_events(whole[1:], 1, 1)  # a marker dropped
    with pytest.raises(devtrace.TraceIncomplete, match="no kernel"):
        devtrace.reduce_events([e for e in whole if e.name != k], 1, 1)


def test_a_traced_run_reports_the_span_metric_on_the_cpu():
    result = run_cell(load_cell("paper-p32.sort"), 5, 0.05, True, CPU,
                      time.perf_counter(), size=1 << 12)
    assert result["correct"], result["checks"]
    # no device here: only the pass loop's spans have something to read
    assert set(result["metrics"]) == {"pass_ms.sort"}


def test_the_sample_judges_the_first_answer_after_its_seeded_moment():
    from sortbench.harness.loop import Sample

    kinds = {"a": 1, "b": 1}
    sample = Sample(11, kinds, 10.0)
    assert sample.at == Sample(11, kinds, 10.0).at
    assert sample.at != Sample(12, kinds, 10.0).at
    assert all(0 <= t < 10.0 for t in sample.at.values())
    answers = {k: [(i, torch.full((4,), float(i))) for i in range(11)]
               for k in kinds}
    for i in range(11):
        sample.offer("a", answers["a"][i], float(i))
    i, col = sample.kept["a"]
    # the first answer's tensor holds the one taken at the moment: a copy
    assert col is answers["a"][0][1]
    assert i == math.ceil(sample.at["a"]) == int(col[0])
    # a kind whose moment no answer reaches keeps its first answer
    sample.at["b"] = 9.5
    for i in range(9):
        sample.offer("b", answers["b"][i], float(i))
    assert sample.kept["b"] is answers["b"][0]
    assert [k for k, _ in sample.drain()] == ["b", "a"]
    assert not sample.kept


def test_copy_into_writes_in_place_where_the_structures_match():
    from sortbench.harness.loop import copy_into

    held = {"x": (1, torch.zeros(3))}
    got = copy_into(held, {"x": (2, torch.ones(3))})
    assert got["x"][0] == 2 and got["x"][1] is held["x"][1]
    assert float(held["x"][1].sum()) == 3.0
    other = torch.ones(4)
    assert copy_into(torch.zeros(3), other) is other
