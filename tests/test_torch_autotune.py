"""repro_torch.core.autotune against the reference's autotuner, on the CPU.

The reference's cases (winners cached in memory and on disk, hits never
re-measure, the empty cache is exactly the static plan, pinned plans
reach every entry point) on the ``"torch"`` backend with ``repeat=1``;
then parity: the same grid and buckets, the same plans from an empty
cache, and with one cache entry written into both packages' files the
same plans and bit-exact outputs from every all-defaults entry point,
``order_by`` and ``external_sort``."""

import datetime
import json
import platform

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import query as rq
from repro import stream as rs
from repro.core import autotune as rat
from repro.core import fractal_argsort as jax_argsort
from repro.core import fractal_sort as jax_sort
from repro.core import fractal_sort_batched as jax_sort_batched
from repro.core import fractal_sort_pairs as jax_sort_pairs
from repro_torch import query as tq
from repro_torch import stream as ts
from repro_torch.core import (
    DEFAULT_MAX_BINS_LOG2,
    autotune_plan,
    convert_plan,
    fractal_argsort,
    fractal_sort,
    fractal_sort_batched,
    fractal_sort_pairs,
    make_sort_plan,
    pass_cost,
    pick_engine,
    plan_cost,
    scatter_tile_len,
    tuned_plan,
)
from repro_torch.core import autotune as at
from repro_torch.obs import metrics
from repro_torch.stream.external import row_cost_bytes

CARD = "NVIDIA H100 80GB HBM3"


def _clear_caches():
    for mod in (at, rat):
        mod._FILE_CACHE.clear()
        mod._MEM_CACHE.clear()


@pytest.fixture
def cache_path(tmp_path):
    """A fresh cache file per test, with the process-level caches cleared
    so disk behaviour is actually exercised."""
    _clear_caches()
    yield str(tmp_path / "autotune.json")
    _clear_caches()


@pytest.fixture
def count_measures(monkeypatch):
    """Wrap the measurement primitive with a call counter (cheap repeat=1
    so sweeps stay fast in tests)."""
    calls = []
    orig = at._measure_plan

    def counting(n, p, plan, backend, repeat=1):
        calls.append((n, p, plan.describe()))
        return orig(n, p, plan, backend, repeat=1)

    monkeypatch.setattr(at, "_measure_plan", counting)
    return calls


def _keys(rng, n, p):
    return rng.integers(0, 1 << p, n, dtype=np.uint64).astype(np.uint32)


def _u32(x) -> np.ndarray:
    """An int32/uint32 result (torch or jax) as numpy uint32 bits."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64).astype(np.uint32) if a.dtype != np.uint32 else a


# --- the reference's cases, on the "torch" backend ---------------------------


def test_autotune_measures_once_then_hits_cache(cache_path, count_measures):
    n, p = 4096, 16
    plan1 = autotune_plan(n, p, backend="torch", cache_path=cache_path,
                          widths=(4, 8), engines=("onehot", "scatter"))
    measured = len(count_measures)
    assert measured == 4, "2 widths x 2 engines"
    plan2 = autotune_plan(n, p, backend="torch", cache_path=cache_path,
                          widths=(4, 8), engines=("onehot", "scatter"))
    assert len(count_measures) == measured
    assert plan2 == plan1
    # a different n in the same power-of-two bucket also hits, with the
    # winner re-instantiated for the exact n
    plan3 = autotune_plan(n - 7, p, backend="torch", cache_path=cache_path)
    assert len(count_measures) == measured
    assert plan3.p == p and plan3.n == n - 7
    assert {dp.engine for dp in plan3.passes} == \
        {dp.engine for dp in plan1.passes}


def test_autotune_cache_persists_to_disk(cache_path, count_measures):
    n, p = 4096, 16
    plan1 = autotune_plan(n, p, backend="torch", cache_path=cache_path,
                          widths=(4, 8))
    measured = len(count_measures)
    with open(cache_path) as f:
        data = json.load(f)
    (key,) = data.keys()
    assert at.host_key("torch") in key and f"p{p}" in key
    entry = data[key]
    assert set(entry) == {"max_bins_log2", "engine", "wall_s", "n_measured",
                          "sweep", "date"}
    assert entry["engine"] in ("onehot", "scatter")
    assert len(entry["sweep"]) == measured, "full sweep recorded"
    at._FILE_CACHE.clear()
    at._MEM_CACHE.clear()
    plan2 = autotune_plan(n, p, backend="torch", cache_path=cache_path)
    assert len(count_measures) == measured
    assert plan2 == plan1


def test_autotune_force_remeasures(cache_path, count_measures):
    autotune_plan(4096, 16, backend="torch", cache_path=cache_path,
                  widths=(4,), engines=("onehot",))
    assert len(count_measures) == 1
    autotune_plan(4096, 16, backend="torch", cache_path=cache_path,
                  widths=(4,), engines=("onehot",), force=True)
    assert len(count_measures) == 2


def test_tuned_plan_never_measures(cache_path, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("tuned_plan must not measure")

    monkeypatch.setattr(at, "_measure_plan", boom)
    n, p = 1 << 14, 32
    for backend in ("torch", "cuda"):
        plan = tuned_plan(n, p, backend=backend, cache_path=cache_path)
        assert plan == make_sort_plan(n, p), \
            "cache miss must fall back to the static default plan"


def test_tuned_plan_resolves_recorded_winner(cache_path, count_measures):
    n, p = 4096, 12
    won = autotune_plan(n, p, backend="torch", cache_path=cache_path,
                        widths=(6,), engines=("scatter",))
    got = tuned_plan(n, p, backend="torch", cache_path=cache_path)
    assert got == won
    assert all(dp.engine == "scatter" for dp in got.passes)


def test_entry_points_accept_pinned_plans(rng):
    n, p = 2048, 16
    keys = torch.from_numpy(rng.integers(0, 1 << p, n).astype(np.int32))
    want = np.sort(keys.numpy())
    want_perm = np.argsort(keys.numpy(), kind="stable")
    plan = make_sort_plan(n, p, max_bins_log2=8, engine="scatter")
    np.testing.assert_array_equal(
        fractal_sort(keys, p, plan=plan, device="cpu").numpy(), want)
    np.testing.assert_array_equal(
        fractal_argsort(keys, p, plan=plan, device="cpu").numpy(), want_perm)
    vals = torch.arange(n, dtype=torch.int32)
    _, sv = fractal_sort_pairs(keys, vals, p, plan=plan, device="cpu")
    np.testing.assert_array_equal(sv.numpy(), want_perm)
    streamed, _ = fractal_sort_batched(keys, p, 4, plan=plan, device="cpu")
    np.testing.assert_array_equal(streamed.numpy(), want)
    with pytest.raises(ValueError):
        fractal_sort(keys, 12, plan=plan, device="cpu")  # plan/p mismatch


def test_candidate_grid_respects_key_width():
    grid = at.candidate_grid(9)
    assert all(w <= 9 for w, _ in grid)
    assert {e for _, e in grid} == {"onehot", "scatter"}
    assert (9, "scatter") in grid, "full-width single pass is a candidate"


def test_cost_model_shape():
    n = 1 << 15
    assert pass_cost(n, 11, "onehot") > 16 * pass_cost(n, 4, "onehot")
    assert pass_cost(n, 11, "scatter") < 2 * pass_cost(n, 4, "scatter")
    assert pick_engine(n, 2) == "onehot"
    assert pick_engine(n, 11) == "scatter"
    wide = make_sort_plan(n, 32, max_bins_log2=11, engine="scatter")
    narrow = make_sort_plan(n, 32, max_bins_log2=4, engine="onehot")
    assert plan_cost(wide) < plan_cost(narrow)
    assert scatter_tile_len(1 << 11) >= scatter_tile_len(1 << 4)


def test_default_resolution_matches_static_plan_without_cache(
        cache_path, monkeypatch):
    monkeypatch.setenv(at.CACHE_ENV, cache_path)
    n, p = 1024, 16
    for backend in ("torch", "cuda"):
        assert tuned_plan(n, p, backend=backend) == make_sort_plan(n, p)
        assert tuned_plan(n, p, backend=backend).passes[-1].bits \
            <= DEFAULT_MAX_BINS_LOG2


# --- the port's own rules ----------------------------------------------------


def test_counters_p0_identity_and_restricted_grid_resweep(cache_path,
                                                          count_measures):
    before = metrics.snapshot()
    consults = at.consult_count()
    assert autotune_plan(100, 0, backend="torch",
                         cache_path=cache_path) == make_sort_plan(100, 0)
    assert at.consult_count() == consults, "p = 0 consults nothing"
    autotune_plan(4096, 16, backend="torch", cache_path=cache_path,
                  widths=(4,), engines=("onehot",))
    autotune_plan(4096, 16, backend="torch", cache_path=cache_path)
    # the winner (4, onehot) is outside this grid: a new sweep
    autotune_plan(4096, 16, backend="torch", cache_path=cache_path,
                  widths=(8,), engines=("scatter",))
    assert len(count_measures) == 2
    delta = metrics.snapshot_delta(before)
    assert delta["autotune.consults"] == 3
    assert delta["autotune.hit"] == 1 and delta["autotune.miss"] == 2
    assert at.consult_count() == consults + 3


def test_backend_names_and_no_card(cache_path, monkeypatch):
    with pytest.raises(ValueError):
        tuned_plan(4096, 16, backend="jnp", cache_path=cache_path)
    with pytest.raises(ValueError):
        at._measure_plan(4096, 16, make_sort_plan(4096, 16), "pallas")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert at.host_key("cuda").endswith("-no-card")
    # the kernels' plain versions on CPU tensors resolve the static plan
    assert tuned_plan(4096, 16, backend="cuda",
                      cache_path=cache_path) == make_sort_plan(4096, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune_plan(4096, 16, backend="cuda", cache_path=cache_path,
                      widths=(4,), engines=("onehot",))


def test_cuda_host_key_names_the_card(cache_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    name = {"card": CARD}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: name["card"])
    assert at.host_key("cuda") == f"{at.host_key('torch')}-{CARD}"
    key = at.cache_key("cuda", 32, None, 27)
    assert key == f"{at.host_key('torch')}-{CARD}|cuda|p32|l0|n2^27"
    entry = {"max_bins_log2": 8, "engine": "scatter", "wall_s": 1e-3,
             "n_measured": 1 << 18, "sweep": [], "date": "2026-01-01"}
    with open(cache_path, "w") as f:
        json.dump({key: entry}, f)
    n = 1 << 27
    won = make_sort_plan(n, 32, max_bins_log2=8, engine="scatter")
    assert tuned_plan(n, 32, backend="cuda", cache_path=cache_path) == won
    # another card on the same host never takes that winner
    name["card"] = "NVIDIA A100-SXM4-80GB"
    assert tuned_plan(n, 32, backend="cuda",
                      cache_path=cache_path) == make_sort_plan(n, 32)
    assert tuned_plan(n, 32, backend="torch",
                      cache_path=cache_path) == make_sort_plan(n, 32)


def test_host_part_of_the_key_is_read_once_a_process(monkeypatch):
    """Every all-defaults sort consults the cache, so the host name and
    core count are read once; the card's name is read at each consult."""
    first = at.host_key("torch")
    monkeypatch.setattr(platform, "node", lambda: "another-host")
    assert at.host_key("torch") == first
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: CARD)
    assert at.host_key("cuda") == f"{first}-{CARD}"
    with pytest.raises(TypeError):
        tuned_plan(4096, 16)  # no default backend: callers name theirs


def test_default_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(at.CACHE_ENV, raising=False)
    monkeypatch.delenv(rat.CACHE_ENV, raising=False)
    assert at.CACHE_ENV != rat.CACHE_ENV
    assert at.default_cache_path() != rat.default_cache_path()
    assert at.default_cache_path().endswith(
        "repro-fractalsort-torch/autotune.json")
    monkeypatch.setenv(rat.CACHE_ENV, "/nonexistent/reference.json")
    assert at.default_cache_path() != "/nonexistent/reference.json"


# --- parity with the reference -----------------------------------------------


def test_grid_and_bucket_parity():
    for p in range(1, 33):
        assert at.candidate_grid(p) == rat.candidate_grid(p)
        assert at.candidate_grid(p, widths=(1, 5, 9), engines=("scatter",)) \
            == rat.candidate_grid(p, widths=(1, 5, 9), engines=("scatter",))
    for n in (0, 1, 2, 3, 4, 5, 1000, 1024, 1025, (1 << 27) - 1, 1 << 27):
        assert at.shape_bucket(n) == rat.shape_bucket(n)
    assert (at.MEASURE_CAP_LOG2, at._MEASURE_REPEAT,
            at._ONEHOT_WIDTH_CAP) == (rat.MEASURE_CAP_LOG2,
                                      rat._MEASURE_REPEAT,
                                      rat._ONEHOT_WIDTH_CAP)


def test_empty_cache_plans_equal_the_references(cache_path):
    for n in (1, 100, 4096, 100_000, 1 << 27):
        for p in (1, 7, 9, 16, 24, 31, 32):
            for l_n in (None, 3, 8):
                want = rat.tuned_plan(n, p, l_n=l_n, cache_path=cache_path)
                for backend in ("torch", "cuda"):
                    got = tuned_plan(n, p, backend=backend, l_n=l_n,
                                     cache_path=cache_path)
                    assert got == convert_plan(want), (n, p, l_n, backend)


SHARED_ENTRY = {"max_bins_log2": 6, "engine": "scatter", "wall_s": 1e-3,
                "n_measured": 4096, "sweep": [],
                "date": datetime.date(2026, 1, 1).isoformat()}


@pytest.fixture
def shared_cache(tmp_path, monkeypatch):
    """One entry written into both packages' cache files under every key
    of this host (p 1..32, buckets 1..20; backend "jnp" for the
    reference, "torch" for the port), both env vars pointing at them and
    the reference's jit caches cleared before and after (its all-defaults
    sorts resolve their plan at trace time)."""
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    for path, key_of in ((ref_path, lambda p, b: rat.cache_key("jnp", p,
                                                                None, b)),
                         (port_path, lambda p, b: at.cache_key("torch", p,
                                                               None, b))):
        path.write_text(json.dumps({key_of(p, b): SHARED_ENTRY
                                    for p in range(1, 33)
                                    for b in range(1, 21)}))
    monkeypatch.setenv(rat.CACHE_ENV, str(ref_path))
    monkeypatch.setenv(at.CACHE_ENV, str(port_path))
    _clear_caches()
    jax.clear_caches()
    yield
    _clear_caches()
    jax.clear_caches()


def test_shared_entry_gives_the_same_plans(shared_cache):
    for n, p in ((1500, 16), (1500, 32), (4096, 9), (1 << 20, 32)):
        got = tuned_plan(n, p, backend="torch")
        assert got == convert_plan(rat.tuned_plan(n, p))
        assert got == make_sort_plan(n, p, max_bins_log2=6, engine="scatter")
        assert got != make_sort_plan(n, p), "the entry must change the plan"


def test_shared_entry_sorts_bit_exact_against_reference(shared_cache, rng):
    n = 1500
    for p in (16, 32):
        keys = _keys(rng, n, p)
        jk = jnp.asarray(keys, jnp.uint32 if p == 32 else jnp.int32)
        tk = torch.from_numpy(keys if p == 32 else keys.astype(np.int32))
        np.testing.assert_array_equal(
            _u32(fractal_sort(tk, p, device="cpu")), _u32(jax_sort(jk, p)))
    vals = np.arange(n, dtype=np.int32)
    sk, sv = fractal_sort_pairs(tk, torch.from_numpy(vals), 32, device="cpu")
    wk, wv = jax_sort_pairs(jk, jnp.asarray(vals), 32)
    np.testing.assert_array_equal(_u32(sk), _u32(wk))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(
        fractal_argsort(tk, 32, device="cpu").numpy(),
        np.asarray(jax_argsort(jk, 32)))
    k16 = _keys(rng, n, 16).astype(np.int32)
    got, _ = fractal_sort_batched(torch.from_numpy(k16), 16, 4, device="cpu")
    want, _ = jax_sort_batched(jnp.asarray(k16), 16, 4)
    np.testing.assert_array_equal(_u32(got), _u32(want))


def test_shared_entry_order_by_and_external_sort_match_reference(
        shared_cache, rng):
    n = 2048
    cols = {"k": rng.integers(0, 1 << 16, n).astype(np.int32),
            "row": np.arange(n, dtype=np.int32)}
    by = [("k", "desc")]
    consults = at.consult_count()
    got = tq.order_by(tq.Table(cols, device="cpu"), by).to_numpy()
    assert at.consult_count() > consults, "order_by consults the tuner"
    want = rq.order_by(rq.Table(cols), by).to_numpy()
    for name in cols:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]))
    keys = _keys(rng, 1 << 13, 32)
    rb, tb = rs.MemoryBudget(len(keys) * 4 // 8), \
        ts.MemoryBudget(len(keys) * 4 // 8)
    want = np.concatenate(list(rs.external_sort(
        rs.ArraySource(keys, rb.rows(row_cost_bytes(1))), 32, rb)))
    got = np.concatenate([_u32(c) for c in ts.external_sort(
        ts.ArraySource(keys, tb.rows(row_cost_bytes(1))), 32, tb,
        device="cpu")])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_autotune_consults_per_bucket_not_per_partition(cache_path,
                                                        monkeypatch):
    """One external sort resolves tuned plans O(distinct (length,
    sort-bits) buckets) times: with 8 budget-packed uniform partitions
    sharing one bucket, a handful of consults, never one a partition."""
    monkeypatch.setenv(at.CACHE_ENV, cache_path)
    rng = np.random.default_rng(9)
    n = 1 << 14
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    budget = ts.MemoryBudget(n * 4 // 8)
    src = ts.ArraySource(keys, budget.rows(row_cost_bytes(1)))
    before = at.consult_count()
    chunks = list(ts.external_sort(src, 32, budget, device="cpu"))
    consults = at.consult_count() - before
    assert np.array_equal(np.concatenate([_u32(c) for c in chunks]),
                          np.sort(keys))
    assert len(chunks) >= 8, "expected >= 8 partitions for this ratio"
    assert 0 < consults <= 4, (
        f"{consults} autotune consults for {len(chunks)} partitions: plan "
        "resolution regressed to per-partition lookups")
