"""The port's fault-tolerance layer (``repro_torch.core.faults`` and the
disk ``RunStore``) against the JAX reference's, on the CPU.

The contract under any single injected fault is the reference's:
**bit-exact output, or the matching typed error — never a hang, never
silent corruption.**  The same fault plan goes to both packages (each
has its own injection registry, with the same site names), and the
outcome — the typed error raised, or a bit-exact result — must be the
same in both.  The store's on-disk format is the reference's: each
package reopens a root the other wrote.  Every case that could hang runs
under a wall-clock alarm of its own (``hard_timeout``).
"""

import contextlib
import os
import signal
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import stream as rs
from repro.core import faults as rfaults
from repro_torch import stream as ts
from repro_torch.core import faults
from repro_torch.core.faults import (
    CorruptFragmentError,
    FaultPlan,
    FaultSpec,
    StoreError,
    StorePermanentError,
    TransientStoreError,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the suite runs
    several test processes on the host's cores, where torch's default
    thread pool waits on busy cores (a smoke jamba gradient took 9.4 s
    on 8 threads against 0.15 s on one, beside six busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))


@contextlib.contextmanager
def hard_timeout(seconds: int):
    """SIGALRM-based wall clock: a case that hangs must *fail*, not stall
    the suite (main-thread only, which is where tests run)."""

    def fire(signum, frame):
        raise TimeoutError(f"case exceeded {seconds}s wall clock")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- plan / registry unit behavior ---------------------------------------------


def test_fault_plan_parse_and_determinism():
    for mod in (faults, rfaults):
        plan = mod.FaultPlan.parse(
            "run_store.put:transient:2,run_store.get:corrupt")
        assert plan.spec_for("run_store.put") == mod.FaultSpec(
            "run_store.put", "transient", nth=2)
        assert plan.spec_for("run_store.get").kind == "corrupt"
        assert plan.spec_for("nope") is None
    # seeded single-fault plans fire on the same hit in both packages
    for site in ("run_store.put", "run_store.sort_rows"):
        for kind in ("transient", "corrupt", "permanent"):
            for seed in range(8):
                assert (FaultPlan.single(site, kind, seed=seed).specs[0].nth
                        == rfaults.FaultPlan.single(site, kind, seed=seed)
                        .specs[0].nth)
    nths = {FaultPlan.single("run_store.put", "transient", seed=s)
            .specs[0].nth for s in range(16)}
    assert len(nths) > 1, "the seed must actually move the trigger"


def test_fault_spec_fires():
    s = FaultSpec("x", "transient", nth=3, times=2)
    assert [s.fires(h) for h in range(1, 7)] == [
        False, False, True, True, False, False]
    p = FaultSpec("x", "permanent", nth=3)
    assert [p.fires(h) for h in range(1, 6)] == [
        False, False, True, True, True], "permanent means dead forever"


def test_registered_sites_match_the_reference_disk_store():
    """The disk store's and the device store's sites, the same names in
    both packages."""
    ours = set(faults.registered_sites())
    for prefix in ("run_store.", "device_store."):
        want = {f"{prefix}{op}" for op in
                ("put", "get", "delete", "distribute", "sort_rows")}
        theirs = {s for s in rfaults.registered_sites()
                  if s.startswith(prefix)}
        assert want <= ours and want == theirs
        assert {s for s in ours if s.startswith(prefix)} == theirs


def test_env_plan_is_read_once(monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV, "run_store.put:transient:2")
    assert faults.env_plan() == FaultPlan.parse("run_store.put:transient:2")
    monkeypatch.delenv(faults.FAULTS_ENV)
    assert faults.env_plan() is None


def test_poll_raises_typed_and_returns_corrupt():
    plan = FaultPlan((FaultSpec("s", "transient", nth=1),
                      FaultSpec("t", "permanent", nth=1),
                      FaultSpec("u", "corrupt", nth=1)))
    with faults.inject(plan) as inj:
        with pytest.raises(TransientStoreError):
            faults.poll("s")
        with pytest.raises(StorePermanentError):
            faults.poll("t")
        assert faults.poll("u") == "corrupt"  # caller applies the damage
        assert faults.poll("u") is None       # fired once
        assert len(inj.fired) == 3


def test_with_retries_budget_and_classification(monkeypatch):
    calls = {"n": 0}
    retried = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientStoreError("site", "hiccup")
        return "ok"

    monkeypatch.setenv(faults.RETRIES_ENV, "2")
    assert faults.with_retries(
        "site", flaky, on_retry=lambda: retried.update(
            n=retried["n"] + 1)) == "ok"
    assert calls["n"] == 3 and retried["n"] == 2
    monkeypatch.setenv(faults.RETRIES_ENV, "1")
    calls["n"] = 0
    with pytest.raises(TransientStoreError):
        faults.with_retries("site", flaky)
    assert calls["n"] == 2, "retry budget is REPRO_STORE_RETRIES"

    def eio():
        raise OSError(5, "I/O error")  # EIO

    with pytest.raises(TransientStoreError):
        faults.with_retries("site", eio)

    def eperm():
        raise PermissionError(1, "nope")  # EPERM: not transient

    with pytest.raises(StorePermanentError):
        faults.with_retries("site", eperm)
    for mod in (faults, rfaults):
        assert mod.classify_oserror(OSError(5, "x")) == "transient"
        assert mod.classify_oserror(OSError(2, "x")) == "permanent"
        assert mod.store_retries() == 1


# --- durable spill: atomic puts, CRC-verified gets, reopen ---------------------


def test_put_is_committed_by_meta_and_verified_by_crc(tmp_path):
    store = ts.RunStore(str(tmp_path / "runs"))
    a = np.arange(100, dtype=np.uint32).reshape(-1, 1)
    rid = store.put(a, torch.arange(100, dtype=torch.int64))
    assert os.path.exists(store._meta_path(rid))
    np.testing.assert_array_equal(store.get(rid)[0], a)
    # hand-damage the on-disk bytes: the next get must detect, not consume
    with open(store._path(rid, 0), "r+b") as f:
        f.seek(13)
        f.write(b"\x5a")
    with pytest.raises(CorruptFragmentError):
        store.get(rid)
    with pytest.raises(CorruptFragmentError):
        store.get(rid, mmap=True)  # the merge path verifies too
    store.close()


def test_slice_reads_verify_their_own_rows(tmp_path, rng):
    """A slice fragment verifies the rows it returns: damage inside its
    range is caught, damage in another slice's range is that slice's."""
    store = ts.RunStore(str(tmp_path / "runs"))
    words = rng.integers(0, 1 << 32, (600, 1), dtype=np.uint64) \
        .astype(np.uint32)
    pid = np.repeat(np.arange(3), 200)
    ids = [i[0] for i in store.distribute(words, (), pid, 3)]
    base = store._slices[ids[0]][0]
    np.testing.assert_array_equal(store.get(ids[1])[0], words[200:400])
    off = store._base_maps(base)[0].offset + 300 * 4  # a row of slice 1
    with open(store._path(base, 0), "r+b") as f:
        f.seek(off)
        f.write(b"\xff\xff\xff\x7f")
    with pytest.raises(CorruptFragmentError):
        store.get(ids[1])
    np.testing.assert_array_equal(store.get(ids[0])[0], words[:200])
    np.testing.assert_array_equal(store.get(ids[2])[0], words[400:])
    store.close()


def test_reopen_recovers_committed_and_sweeps_torn(tmp_path):
    root = str(tmp_path / "runs")
    store = ts.RunStore(root)
    a = np.arange(64, dtype=np.uint32).reshape(-1, 1)
    rid = store.put(a)
    with open(os.path.join(root, "run00009999_0.npy"), "wb") as f:
        f.write(b"torn")
    with open(os.path.join(root, "stray.npy.tmp"), "wb") as f:
        f.write(b"half")
    reopened = ts.RunStore(root)  # no close(): the "process died" path
    assert rid in reopened and len(reopened) == 1
    np.testing.assert_array_equal(reopened.get(rid)[0], a)
    assert reopened.events["recover.torn_run"] == 1
    assert reopened.events["recover.tmp_swept"] == 1
    assert not os.path.exists(os.path.join(root, "run00009999_0.npy"))
    assert reopened._next_id > rid, "the id watermark survives reopen"


def test_delete_and_nbytes_count_swallowed_events(tmp_path):
    store = ts.RunStore(str(tmp_path / "runs"))
    rid = store.put(np.arange(32, dtype=np.uint32).reshape(-1, 1))
    os.remove(store._path(rid, 0))
    assert store.nbytes() == 0
    assert store.events["nbytes.missing"] == 1
    store.delete(rid)  # missing file: swallowed but counted, not silent
    assert store.events["delete.missing"] >= 1
    assert rid not in store


def test_transient_faults_retry_and_count(tmp_path):
    store = ts.RunStore(str(tmp_path / "runs"))
    with faults.inject(FaultPlan((
            FaultSpec("run_store.put", "transient", nth=1),))) as inj:
        rid = store.put(np.arange(8, dtype=np.uint32).reshape(-1, 1))
        assert inj.fired and store.events["put.retry"] == 1
    np.testing.assert_array_equal(store.get(rid)[0].ravel(),
                                  np.arange(8, dtype=np.uint32))


def test_log_channel_round_trip_and_verification(tmp_path):
    store = ts.RunStore(str(tmp_path / "runs"))
    store.write_log("manifest", {"phase": "histogram", "counts": [1, 2]})
    assert store.read_log("manifest")["counts"] == [1, 2]
    assert store.read_log("absent") is None
    reopened = ts.RunStore(str(tmp_path / "runs"))
    assert reopened.read_log("manifest")["phase"] == "histogram"
    with open(store._log_path("manifest"), "r+") as f:
        raw = f.read().replace("histogram", "histogrub")
        f.seek(0)
        f.write(raw)
    with pytest.raises(CorruptFragmentError):
        reopened.read_log("manifest")


# --- the store format: each package reopens the other's root -------------------


def _write_root(mod, root, rng_seed):
    """Runs, one distributed chunk (slices) and a log, on a durable root."""
    rng = np.random.default_rng(rng_seed)
    store = mod.RunStore(root)
    runs = [store.put(np.arange(50, dtype=np.uint32).reshape(-1, 1),
                      rng.standard_normal(50)),
            store.put(np.arange(7, dtype=np.int64))]
    words = rng.integers(0, 1 << 32, (300, 2), dtype=np.uint64) \
        .astype(np.uint32)
    pay = np.arange(300, dtype=np.int64)
    pid = rng.integers(-1, 4, 300).astype(np.int64)
    slices = store.distribute(words, (pay,), pid, 4)
    store.write_log("job", {"done": {"0": runs}, "complete": False})
    return words, pay, pid, runs, slices


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_store_format_reopens_across_packages(tmp_path, writer, reader):
    mods = {"reference": rs, "port": ts}
    root = str(tmp_path / "runs")
    words, pay, pid, runs, slices = _write_root(mods[writer], root, 5)
    store = mods[reader].RunStore(root)
    assert sorted(store.run_ids()) == sorted(
        mods[writer].RunStore(root).run_ids())
    assert store.read_log("job") == {"done": {"0": runs}, "complete": False}
    np.testing.assert_array_equal(store.get(runs[1])[0], np.arange(7))
    for i, ids in enumerate(slices):
        got_w = np.concatenate([store.get(r)[0] for r in ids]) if ids \
            else np.zeros((0, 2), np.uint32)
        got_p = np.concatenate([store.get(r)[1] for r in ids]) if ids \
            else np.zeros(0, np.int64)
        np.testing.assert_array_equal(got_w, words[pid == i])
        np.testing.assert_array_equal(got_p, pay[pid == i])
    # the CRCs recorded by one package verify in the other
    with open(store._path(runs[0], 1), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x00" if f.read(1) != b"\x00" else b"\x01")
    with pytest.raises((CorruptFragmentError,
                        rfaults.CorruptFragmentError)):
        store.get(runs[0])
    for ids in slices:
        for r in ids:
            store.delete(r)
    assert len(store) == 2, "the slices' base run goes with its last slice"


# --- MemoryBudget exception-path accounting -----------------------------------


def test_budget_hold_releases_on_exception():
    budget = ts.MemoryBudget(1 << 20)
    a = torch.zeros(1000, dtype=torch.int32)
    with pytest.raises(RuntimeError):
        with budget.hold(a, a):
            assert budget.held_bytes == 2 * a.nbytes
            raise RuntimeError("mid-operation failure")
    assert budget.held_bytes == 0, "a raising operation must release"
    assert budget.peak_bytes == 2 * a.nbytes


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sort_charge_released_when_sort_raises(backend):
    store = ts.RunStore()
    budget = ts.MemoryBudget(1 << 20)
    words = np.arange(4096, dtype=np.uint32)[::-1].copy().reshape(-1, 1)
    with faults.inject(FaultPlan((
            FaultSpec("run_store.sort_rows", "permanent", nth=1),))):
        with pytest.raises(StorePermanentError):
            store.sort_rows(words, (), 16, 16, budget, device="cpu",
                            backend=backend)
    assert budget.held_bytes == 0
    peak_after_failure = budget.peak_bytes
    out, _ = store.sort_rows(words, (), 16, 16, budget, device="cpu",
                             backend=backend)
    np.testing.assert_array_equal(out.ravel(),
                                  np.arange(4096, dtype=np.uint32))
    assert budget.peak_bytes >= peak_after_failure
    store.close()


# --- the chaos matrix ---------------------------------------------------------------

_KINDS = ("transient", "corrupt", "permanent")
_SEEDS = (0, 1, 2)
_DISK_SITES = tuple(s for s in faults.registered_sites()
                    if s.startswith("run_store."))


def _chaos_keys():
    rng = np.random.default_rng(42)
    return rng.integers(0, 1 << 16, 4000, dtype=np.int32)


def _chaos_run(mod, inject, src_keys, site, kind, seed):
    """(error or None, bit-exact, the injector) of one argsort under one
    seeded single fault."""
    expect = np.sort(src_keys, kind="stable")
    expect_ids = np.argsort(src_keys, kind="stable")
    budget = mod.MemoryBudget(16 * 1024)
    src = mod.ArraySource(src_keys, budget.rows(12))
    kw = {"device": "cpu"} if mod is ts else {}
    raised, out, ids = None, None, None
    plan_cls = rfaults.FaultPlan if mod is rs else FaultPlan
    with inject(plan_cls.single(site, kind, seed=seed)) as inj:
        try:
            pieces = list(mod.external_argsort(src, 16, budget, **kw))
            out = np.concatenate([_np(w) for w, _ in pieces])
            ids = np.concatenate([_np(r) for _, r in pieces])
        except (StoreError, rfaults.StoreError) as e:
            raised = e
    exact = (out is not None and np.array_equal(out, expect)
             and np.array_equal(ids, expect_ids))
    return raised, exact, inj


def _assert_chaos_contract(site, kind, inj, raised, bit_exact, errors):
    """The single-fault contract: bit-exact output or the matching typed
    error — and a *fired* data-damaging fault is never silently
    absorbed."""
    if raised is None:
        assert bit_exact, f"{site}:{kind} emitted wrong bytes silently"
        if kind == "corrupt" and site.endswith((".put", ".get")):
            assert not inj.fired, (
                f"{site} corruption fired yet output passed verification")
    else:
        assert isinstance(raised, errors[0]), (
            f"{site}:{kind} raised untyped {type(raised).__name__}")
        assert inj.fired, "a typed error without a fired fault"
        if kind == "corrupt":
            assert isinstance(raised, errors[1])
    if kind == "transient":
        assert raised is None, "one transient must be absorbed by retries"


@pytest.mark.parametrize("seed", _SEEDS)
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("site", _DISK_SITES)
def test_chaos_matrix_disk(site, kind, seed):
    keys = _chaos_keys()
    with hard_timeout(120):
        got = _chaos_run(ts, faults.inject, keys, site, kind, seed)
        want = _chaos_run(rs, rfaults.inject, keys, site, kind, seed)
    _assert_chaos_contract(site, kind, got[2], got[0], got[1],
                           (StoreError, CorruptFragmentError))
    _assert_chaos_contract(site, kind, want[2], want[0], want[1],
                           (rfaults.StoreError, rfaults.CorruptFragmentError))
    # the same outcome in both packages: the same typed error, or both
    # bit-exact
    assert (type(got[0]).__name__ if got[0] else None,
            got[1]) == (type(want[0]).__name__ if want[0] else None, want[1])


_DEVICE_SITES = tuple(s for s in faults.registered_sites()
                      if s.startswith("device_store."))


@pytest.fixture(scope="module")
def gloo_group(tmp_path_factory):
    """A one-rank gloo group in this process, for the device store."""
    dist.init_process_group(
        "gloo", init_method="file://" + str(
            tmp_path_factory.mktemp("gloo") / "store"), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _chaos_run_device(mod, inject, src_keys, site, kind, seed):
    """(error or None, bit-exact, the injector) of one external sort on a
    one-device ``DeviceShardStore`` under one seeded single fault."""
    expect = np.sort(src_keys, kind="stable")
    budget = mod.MemoryBudget(16 * 1024)
    src = mod.ArraySource(src_keys, budget.rows(12))
    kw = {"device": "cpu"} if mod is ts else {}
    raised, out = None, None
    plan_cls = rfaults.FaultPlan if mod is rs else FaultPlan
    with inject(plan_cls.single(site, kind, seed=seed)) as inj:
        store = mod.DeviceShardStore(**kw)
        try:
            out = np.concatenate([_np(c) for c in mod.external_sort(
                src, 16, budget, store=store, **kw)])
        except (StoreError, rfaults.StoreError) as e:
            raised = e
    return raised, out is not None and np.array_equal(out, expect), inj


@pytest.mark.parametrize("seed", _SEEDS)
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("site", _DEVICE_SITES)
def test_chaos_matrix_device(gloo_group, site, kind, seed):
    keys = _chaos_keys()
    with hard_timeout(120):
        got = _chaos_run_device(ts, faults.inject, keys, site, kind, seed)
        want = _chaos_run_device(rs, rfaults.inject, keys, site, kind, seed)
    _assert_chaos_contract(site, kind, got[2], got[0], got[1],
                           (StoreError, CorruptFragmentError))
    _assert_chaos_contract(site, kind, want[2], want[0], want[1],
                           (rfaults.StoreError, rfaults.CorruptFragmentError))
    assert (type(got[0]).__name__ if got[0] else None,
            got[1]) == (type(want[0]).__name__ if want[0] else None, want[1])
    if site == "device_store.sort_rows" and kind == "permanent":
        assert got[0] is None and got[1], (
            "a permanent mid-sort device fault must fail over to disk and "
            "still emit bit-exact output")


def test_device_store_refuses_a_missing_group_or_another_device(
        gloo_group, monkeypatch):
    store = ts.DeviceShardStore(device="cpu")
    assert (store.num_devices, store.site_prefix) == (1, "device_store")
    assert store.failover_to_disk and not store.supports_concurrent_sorts
    assert not store.supports_batched_sorts
    assert store.owner(3, 4) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.DeviceShardStore()
    words = np.arange(8, dtype=np.uint32).reshape(-1, 1)
    with pytest.raises(ValueError, match="the store works on cpu"):
        store.sort_rows(words, (), 32, 32, ts.MemoryBudget(1 << 20),
                        device="meta")
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        ts.DeviceShardStore(device="cpu")


def test_chaos_stream_table_order_by():
    """StreamTable ops ride the same boundaries: a transient is absorbed,
    injected spill corruption surfaces typed — never wrong rows."""
    from repro_torch.query import Table, order_by

    rng = np.random.default_rng(3)
    n = 3000
    k = rng.integers(0, 500, n).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    ref = order_by(Table({"k": k, "v": v}, device="cpu"), "k").to_numpy()

    def chunks():
        for lo in range(0, n, 350):
            yield Table({"k": k[lo:lo + 350], "v": v[lo:lo + 350]},
                        device="cpu")

    with hard_timeout(120):
        with faults.inject(FaultPlan((
                FaultSpec("run_store.put", "transient", nth=2),))) as inj:
            st = ts.StreamTable(chunks, ts.MemoryBudget(4 * 1024),
                                device="cpu")
            res = ts.stream_order_by(st, "k")
            got = res.to_table().to_numpy()
            assert inj.fired
        for name in ("k", "v"):
            np.testing.assert_array_equal(got[name], ref[name])
        res.close()
        with faults.inject(FaultPlan((
                FaultSpec("run_store.get", "corrupt", nth=3),))):
            st = ts.StreamTable(chunks, ts.MemoryBudget(4 * 1024),
                                device="cpu")
            with pytest.raises(CorruptFragmentError):
                ts.stream_order_by(st, "k").to_table()


# --- kill-and-resume --------------------------------------------------------------


def _crash_and_resume(mod, inject, keys, root, crash_after):
    kw = {"device": "cpu"} if mod is ts else {}

    def run(store, budget, **more):
        return [_np(c) for c in mod.external_sort(
            mod.ArraySource(keys, budget.rows(4)), 20, budget, store=store,
            **kw, **more)]

    store = mod.RunStore(root)
    plan = (FaultPlan if mod is ts else rfaults.FaultPlan)((
        (FaultSpec if mod is ts else rfaults.FaultSpec)(
            "run_store.sort_rows", "permanent", nth=crash_after + 1),))
    with inject(plan):
        with pytest.raises((StorePermanentError,
                            rfaults.StorePermanentError)):
            run(store, mod.MemoryBudget(16 * 1024), journal="job")
    manifest = mod.RunStore(root).read_log("job")
    resumed = mod.RunStore(root)  # "process death": a cold store
    out = np.concatenate(run(resumed, mod.MemoryBudget(16 * 1024),
                             resume="job"))
    return manifest, resumed, out


@pytest.mark.parametrize("crash_after", [1, 4, 9])
def test_kill_and_resume_bit_exact_zero_recompute(tmp_path, crash_after):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1 << 20, 12000, dtype=np.int32)
    expect = np.sort(keys, kind="stable")
    with hard_timeout(180):
        outs = {}
        for name, mod, inject in (("port", ts, faults.inject),
                                  ("reference", rs, rfaults.inject)):
            manifest, resumed, out = _crash_and_resume(
                mod, inject, keys, str(tmp_path / name), crash_after)
            assert manifest is not None and not manifest["complete"]
            done = manifest["done"]
            assert len(done) == crash_after, "one commit per emitted part"
            done_frags = {rid for idx in done
                          for rid in manifest["frag_ids"][int(idx)]}
            done_runs = {rid for rids in done.values() for rid in rids}
            # zero recomputation, by the counting logs
            assert not (set(resumed.get_log) & done_frags)
            assert done_runs <= set(resumed.get_log)
            assert len(resumed.put_log) == \
                len(manifest["frag_ids"]) - len(done)
            assert resumed.read_log("job")["complete"]
            assert len(resumed) == 0, "result runs are dropped at completion"
            outs[name] = out
    np.testing.assert_array_equal(outs["port"], expect)
    np.testing.assert_array_equal(outs["port"], outs["reference"])


def test_resume_requires_same_budget(tmp_path):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 16, 6000, dtype=np.int32)
    root = str(tmp_path / "spill")
    store = ts.RunStore(root)
    with faults.inject(FaultPlan((FaultSpec(
            "run_store.sort_rows", "permanent", nth=2),))):
        with pytest.raises(StorePermanentError):
            budget = ts.MemoryBudget(16 * 1024)
            list(ts.external_sort(ts.ArraySource(keys, budget.rows(4)), 16,
                                  budget, store=store, journal="job",
                                  device="cpu"))
    resumed = ts.RunStore(root)
    budget = ts.MemoryBudget(32 * 1024)  # different budget → different plan
    with pytest.raises(ValueError, match="same memory budget"):
        list(ts.external_sort(ts.ArraySource(keys, budget.rows(4)), 16,
                              budget, store=resumed, resume="job",
                              device="cpu"))


# --- worker pool: raising sorts must cancel and surface promptly ---------------


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_worker_pool_failure_surfaces_no_deadlock(workers, monkeypatch):
    """A permanent fault on the third partition sort surfaces at every
    worker count, promptly, and leaves no worker thread behind."""
    monkeypatch.setenv("REPRO_STREAM_WORKERS", str(workers))
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 18, 12000, dtype=np.int32)
    before = set(threading.enumerate())
    with hard_timeout(120):
        with faults.inject(FaultPlan.parse(
                "run_store.sort_rows:permanent:3")) as inj:
            budget = ts.MemoryBudget(16 * 1024)
            with pytest.raises(StorePermanentError):
                list(ts.external_sort(ts.ArraySource(keys, budget.rows(4)),
                                      18, budget, device="cpu"))
            assert inj.fired
    live = [t for t in threading.enumerate()
            if t not in before and t.is_alive() and not t.daemon]
    assert not live, f"leaked worker threads: {live}"
