"""The port's spans (``repro_torch.obs.trace``) on the sort path.

With tracing and the profiler off, a span is the shared no-op handle.
Under a recording ``torch.profiler`` every span is a host range of its
name that is no user annotation, collected or not.  Traced, each public
sort leaves ``sort.call`` over ``sort.plan``, ``executor.histogram`` and
one ``executor.pass`` a plan pass with its phase children, feeds the
registry one ``span.<name>.wall_s`` observation a span, and carries no
``device_s`` on the CPU.  On the card (the ``cuda`` test) every executor
span is device-timed, a pass's phases add up to the pass, and the spans
add no device synchronisation.

The module imports no JAX, so its ``cuda`` test runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_obs.py
"""

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import (fractal_argsort, fractal_sort,
                              fractal_sort_batched, fractal_sort_pairs,
                              make_sort_plan)
from repro_torch.kernels import ops
from repro_torch.obs import metrics, trace

PHASES = ("executor.digit", "executor.rank", "executor.scatter",
          "executor.reconstruct")


@pytest.fixture(autouse=True)
def _empty_autotune_cache(tmp_path, monkeypatch):
    """All-defaults sorts resolve their plan through the autotune cache:
    an empty one gives the static plans."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))


def _keys(rng, n, device="cpu"):
    return torch.from_numpy(
        rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        .view(np.int32)).to(device)


def _sorts(keys, device, backend=None):
    """Each public sort of the tree test: (entry, call, MSD pass
    reconstructs)."""
    kw = dict(device=device, backend=backend)
    return [
        ("fractal_sort", lambda: fractal_sort(keys, 32, **kw), True),
        ("fractal_sort_pairs",
         lambda: fractal_sort_pairs(keys, torch.arange(
             keys.shape[0], dtype=torch.int32, device=keys.device), 32, **kw),
         True),
        ("fractal_argsort", lambda: fractal_argsort(keys, 32, **kw), False),
    ]


def _children(tr, parent):
    return [s for s in tr.spans if s["parent"] == parent["sid"]]


def test_span_is_null_with_collector_and_profiler_off():
    assert not trace.enabled()
    assert trace.span("executor.pass") is trace.NULL
    assert trace.span("sort.call", torch.device("cpu"), n=3) is trace.NULL
    with trace.span("executor.digit") as sp:
        assert sp is trace.NULL


def test_profiler_sees_the_spans_as_host_ranges_with_collection_off(rng):
    keys = _keys(rng, 3000)
    assert not trace.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fractal_sort(keys, 32, device="cpu")
        fractal_argsort(keys, 32, device="cpu")
    seen = {}
    for e in prof.events():
        if e.name.startswith(("sort.", "executor.")):
            assert not e.is_user_annotation, e.name
            assert "CUDA" not in str(e.device_type), e.name
            seen[e.name] = seen.get(e.name, 0) + 1
    passes = make_sort_plan(3000, 32).num_passes
    assert seen["sort.call"] == 2 and seen["sort.plan"] == 2
    assert seen["executor.pass"] == 2 * passes
    for name in ("executor.digit", "executor.rank", "executor.scatter"):
        assert seen[name] == 2 * passes, name
    assert seen["executor.reconstruct"] == 1
    # the profiler is gone: spans are the no-op handle again
    assert trace.span("executor.pass") is trace.NULL


@pytest.mark.parametrize("which", range(3))
def test_each_sort_leaves_the_tree_of_its_passes(rng, which):
    n = 4000
    keys = _keys(rng, n)
    entry, call, reconstructs = _sorts(keys, "cpu", backend="cuda")[which]
    before = metrics.snapshot()
    with obs.tracing() as session:
        call()
    tr = session.trace
    tr.assert_well_formed()
    plan = make_sort_plan(n, 32)

    (root,) = [s for s in tr.spans if s["parent"] is None]
    assert root["name"] == "sort.call"
    assert root["attrs"] == {"entry": entry, "n": n, "p": 32}
    top = [s["name"] for s in _children(tr, root)]
    assert top == (["sort.plan", "executor.histogram"]
                   + ["executor.pass"] * plan.num_passes)
    passes = [s for s in _children(tr, root) if s["name"] == "executor.pass"]
    for i, ps in enumerate(passes):
        names = [s["name"] for s in _children(tr, ps)]
        msd = i == len(passes) - 1 and reconstructs
        # every 4-bit pass fits K2's one sweep: K2 takes the digit from
        # the key stream, and no pass extracts one
        want = (["executor.rank", "executor.scatter"]
                + (["executor.reconstruct"] if msd else []))
        assert names == want, (i, names)
        for child in _children(tr, ps):
            assert not _children(tr, child), child["name"]
    assert not [s for s in tr.spans if "device_s" in s]
    assert "device_s" not in repr(tr.summary())

    # the registry: one wall observation a span, no device time on the CPU
    after = metrics.snapshot()
    for name in {s["name"] for s in tr.spans}:
        key = f"span.{name}.wall_s"
        got = after[key]["count"] - before.get(key, {}).get("count", 0)
        assert got == len(tr.find(name)), name
        assert f"span.{name}.device_s" not in after
    # one count a pass whose digit K2 took
    assert (after["executor.rank.digit_in_kernel"]
            - before.get("executor.rank.digit_in_kernel", 0)
            == plan.num_passes)


def test_every_entry_opens_one_call_span(rng):
    """The batched sort and the kernel entries are calls too, with their
    plan resolution under them."""
    keys = _keys(rng, 2048)
    with obs.tracing() as session:
        fractal_sort_batched(keys, 32, 4, device="cpu", backend="cuda")
        ops.fractal_sort_kernel(keys, 32, device="cpu")
        ops.fractal_sort_pairs_kernel(keys, keys, 32, device="cpu")
    tr = session.trace
    tr.assert_well_formed()
    calls = [s for s in tr.spans if s["parent"] is None]
    assert [s["attrs"]["entry"] for s in calls] == [
        "fractal_sort_batched", "fractal_sort_kernel",
        "fractal_sort_pairs_kernel"]
    for call in calls:
        assert call["name"] == "sort.call"
        assert call["attrs"]["n"] == 2048
        assert _children(tr, call)[0]["name"] == "sort.plan"


def test_resolution_happens_once_per_span(rng):
    """A session under a running collector resolves what it closed; the
    collector's stop resolves nothing twice."""
    keys = _keys(rng, 1000)
    def count():
        return metrics.snapshot().get("span.sort.call.wall_s",
                                      {}).get("count", 0)

    start = count()
    trace.start()
    try:
        with obs.tracing() as session:
            fractal_argsort(keys, 32, device="cpu")
        assert count() == start + 1
        fractal_argsort(keys, 32, device="cpu")
    finally:
        tr = trace.stop()
    assert len(session.trace.find("sort.call")) == 1
    assert len(tr.find("sort.call")) == 2
    assert count() == start + 2


def test_bandwidth_report_takes_device_seconds_where_spans_have_them():
    spans = [
        {"sid": 1, "parent": None, "name": "executor.pass", "t0": 0.0,
         "t1": 1.0, "tid": 0, "attrs": {"bytes_read": 300},
         "device_s": 0.25},
        {"sid": 2, "parent": None, "name": "stream.emit", "t0": 0.0,
         "t1": 2.0, "tid": 0, "attrs": {"bytes": 100}},
    ]
    report = obs.bandwidth_report(trace.Trace(spans))
    assert report["phases"]["executor.pass"]["bytes_per_s"] == 1200.0
    assert report["phases"]["stream.emit"]["bytes_per_s"] == 50.0
    assert report["measured_seconds"] == 2.25


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phases_are_device_timed_and_add_up_to_the_pass(rng, cuda_device,
                                                       monkeypatch):
    """At 2**26 keys a pass takes ~3 ms, so the host's ~20 us from a
    pass's start (the device idled by the previous pass's sync) to its
    first phase is under 1 % of it; at 2**24 that lead alone is 2-5 %."""
    keys = _keys(rng, 1 << 26, cuda_device)
    calls = [c for c in _sorts(keys, cuda_device)
             if c[0] != "fractal_sort_pairs"]
    for _, call, _ in calls:  # build and warm the kernels and the tracer
        call()
        with obs.tracing():
            call()
    torch.cuda.synchronize()
    syncs = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (syncs.append(1), real_sync(*a, **k)))
    for entry, call, _ in calls:
        syncs.clear()
        # a collection pause between two phases would idle the device
        # inside the pass but outside its phases
        gc.disable()
        try:
            with obs.tracing() as session:
                call()
        finally:
            gc.enable()
        tr = session.trace
        tr.assert_well_formed()
        passes = tr.find("executor.pass")
        # the end-of-pass sync is the only one the collector runs
        assert len(syncs) == len(passes), entry
        for s in tr.spans:
            if s["name"].startswith("executor."):
                assert s["device_s"] > 0, (entry, s["name"])
        for ps in passes:
            phases = sum(c["device_s"] for c in _children(tr, ps)
                         if c["name"] in PHASES)
            assert abs(phases - ps["device_s"]) <= 0.05 * ps["device_s"], (
                entry, ps["attrs"]["index"], phases, ps["device_s"])
