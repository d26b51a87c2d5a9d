"""repro_torch planner, trie histogram and traffic model vs the JAX
reference: equal plans over the (n, p, max_bins_log2, engine) grid, equal
cost-model numbers, a convert_plan round trip, equal histogram levels and
queries, and equal fractal_sort_stats."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fractal_tree as jft
from repro.core import sort_plan as jsp
from repro.core.fractal_sort import fractal_sort_stats as jax_stats
from repro_torch.core import fractal_tree as tft
from repro_torch.core import sort_plan as tsp
from repro_torch.core.fractal_sort import fractal_sort, fractal_sort_stats

NS = [0, 1, 64, 1000, 1 << 17, 1 << 27]
WIDTHS = [None, 1, 4, 8, 11, 16]
ENGINES = [None, "onehot", "scatter"]


@pytest.fixture(autouse=True)
def _empty_autotune_cache(tmp_path, monkeypatch):
    """All-defaults sorts resolve their plan through the autotune cache:
    an empty one gives the static plans, whatever cache the machine
    holds."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))


def _passes(plan):
    return tuple((d.shift, d.bits, d.kind, d.engine) for d in plan.passes)


def _summary(plan):
    return (plan.n, plan.p, _passes(plan), plan.depth, plan.trailing_bits,
            plan.num_passes, plan.grouped_table_log2,
            plan.supports_grouped_trailing, plan.describe(),
            tuple(d.rank_batch(b) for d in plan.passes for b in (64, 1024)))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n", NS)
def test_make_sort_plan_grid_matches_reference(n, engine):
    for p in range(33):
        for w in WIDTHS:
            want = jsp.make_sort_plan(n, p, max_bins_log2=w, engine=engine)
            got = tsp.make_sort_plan(n, p, max_bins_log2=w, engine=engine)
            assert _summary(got) == _summary(want), (n, p, w, engine)


@pytest.mark.parametrize("l_n", [1, 4, 8, 13, 16])
def test_make_sort_plan_explicit_l_n_matches_reference(l_n):
    for n in NS:
        for p in range(1, 33):
            for w in WIDTHS:
                want = jsp.make_sort_plan(n, p, l_n=l_n, max_bins_log2=w)
                got = tsp.make_sort_plan(n, p, l_n=l_n, max_bins_log2=w)
                assert _summary(got) == _summary(want), (n, p, l_n, w)


def test_cost_model_and_hints_match_reference():
    for n_bins in [1, 2, 3, 16, 255, 256, 1000, 2048, 4096, 1 << 16]:
        for base in [8, 64, 1024, 4096, 1 << 14]:
            assert tsp.rank_chunk_len(n_bins, base) == jsp.rank_chunk_len(n_bins, base)
            assert tsp.scatter_tile_len(n_bins, base) == jsp.scatter_tile_len(n_bins, base)
    for n in NS:
        for bits in range(1, 17):
            for engine in ("onehot", "scatter"):
                assert tsp.pass_cost(n, bits, engine) == jsp.pass_cost(n, bits, engine)
            assert tsp.pick_engine(n, bits) == jsp.pick_engine(n, bits)
        for p in (8, 16, 32):
            for w in WIDTHS:
                for engine in ENGINES:
                    got = tsp.plan_cost(tsp.make_sort_plan(n, p, max_bins_log2=w), engine)
                    want = jsp.plan_cost(jsp.make_sort_plan(n, p, max_bins_log2=w), engine)
                    assert got == want, (n, p, w, engine)
    for eff in range(-1, 40):
        for width in (16, 32):
            for step in (1, 4, 8):
                assert (tsp.quantize_sort_bits(eff, width, step)
                        == jsp.quantize_sort_bits(eff, width, step))
    assert tsp.DEFAULT_MAX_BINS_LOG2 == jsp.DEFAULT_MAX_BINS_LOG2


def test_convert_plan_round_trip(rng):
    """A reference plan (the reference's state: the plan is the only
    thing a sort carries) converts to the port's types pass for pass, and
    the port sorts with it exactly as with its own plan."""
    hints = ["scatter", "onehot", None, "scatter"]
    base = jsp.make_sort_plan(4096, 32, max_bins_log2=8)
    mixed = jsp.SortPlan(n=base.n, p=base.p, passes=tuple(
        jsp.DigitPass(shift=d.shift, bits=d.bits, kind=d.kind, engine=e)
        for d, e in zip(base.passes, hints)))
    for ref_plan in (base, mixed, jsp.make_sort_plan(777, 16, l_n=5),
                     jsp.make_sort_plan(10, 0)):
        got = tsp.convert_plan(ref_plan)
        assert isinstance(got, tsp.SortPlan)
        assert _summary(got) == _summary(ref_plan)
        assert tsp.convert_plan(got) == got
    keys = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    out = fractal_sort(torch.from_numpy(keys), 32, plan=tsp.convert_plan(mixed),
                       device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.sort(keys))


def test_invalid_plans_are_refused():
    with pytest.raises(ValueError):
        tsp.make_sort_plan(10, 33)
    with pytest.raises(ValueError):
        tsp.make_sort_plan(10, 8, max_bins_log2=17)
    with pytest.raises(ValueError):
        tsp.make_sort_plan(10, 8, l_n=0)
    with pytest.raises(ValueError):
        tsp.make_sort_plan(10, 8, engine="bogus")
    with pytest.raises(ValueError):
        tsp.pass_cost(10, 4, "bogus")


def test_tree_helpers_match_reference():
    for n in range(0, 70):
        assert tft.ceil_log2(n) == jft.ceil_log2(n)
        for p in (1, 8, 16, 32):
            assert tft.trie_depth(n, p) == jft.trie_depth(n, p)
    for level in range(17):
        for log2n in (0, 5, 10, 20, 30):
            assert tft.tapered_bits(level, log2n) == jft.tapered_bits(level, log2n)
            assert (tft.tapered_dtype(level, log2n).itemsize
                    == jnp.dtype(jft.tapered_dtype(level, log2n)).itemsize)
    counts = np.array([3, 0, 7, 1, 0, 9], np.int32)
    np.testing.assert_array_equal(
        tft.exclusive_cumsum(torch.from_numpy(counts)).numpy(),
        np.asarray(jft.exclusive_cumsum(jnp.asarray(counts))))
    x = np.arange(0, 1 << 10, 7).astype(np.int32)
    for width in (1, 5, 10):
        np.testing.assert_array_equal(
            tft.bit_reverse(torch.from_numpy(x), width).numpy(),
            np.asarray(jft.bit_reverse(jnp.asarray(x), width)))


@pytest.mark.parametrize("n,p,depth,dist", [
    (1000, 16, 8, "uniform"), (4096, 32, 12, "uniform"),
    (777, 12, 12, "uniform"), (64, 8, 1, "uniform"), (2048, 16, 10, "skewed"),
])
def test_histogram_levels_and_queries_match_reference(rng, n, p, depth, dist):
    if dist == "uniform":
        keys = rng.integers(0, 1 << p, n, dtype=np.uint64).astype(np.uint32)
    else:  # one hot bin: saturates the tapered counters
        keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 1 << p, n)
                        ).astype(np.uint32)
    jkeys = jnp.asarray(keys, jnp.uint32)
    tkeys = torch.from_numpy(keys)
    half = n // 2
    jh = jft.build_histogram(jkeys, p, depth)
    th = tft.build_histogram(tkeys, p, depth)
    merged_j = jft.merge_histograms(jft.build_histogram(jkeys[:half], p, depth),
                                    jft.build_histogram(jkeys[half:], p, depth))
    merged_t = tft.merge_histograms(tft.build_histogram(tkeys[:half], p, depth),
                                    tft.build_histogram(tkeys[half:], p, depth))
    assert (th.p, th.depth, len(th.levels)) == (jh.p, jh.depth, len(jh.levels))
    for tl, jl, mt, mj in zip(th.levels, jh.levels, merged_t.levels,
                              merged_j.levels):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int(th.total) == int(jh.total) == n
    np.testing.assert_array_equal(th.leaf_counts.numpy(), np.asarray(jh.leaf_counts))
    idx = np.arange(n, dtype=np.int32)
    np.testing.assert_array_equal(tft.get_item(th, torch.from_numpy(idx)).numpy(),
                                  np.asarray(jft.get_item(jh, jnp.asarray(idx))))
    leaves = np.arange(1 << depth, dtype=np.int32)
    np.testing.assert_array_equal(
        tft.get_index(th, torch.from_numpy(leaves)).numpy(),
        np.asarray(jft.get_index(jh, jnp.asarray(leaves))))
    for n_hint in (None, n, 16):
        t_levels, t_sat = tft.taper_levels(th, n_hint)
        j_levels, j_sat = jft.taper_levels(jh, n_hint)
        assert bool(t_sat) == bool(j_sat)
        for tl, jl in zip(t_levels, j_levels):
            assert tl.dtype.itemsize == jl.dtype.itemsize
            np.testing.assert_array_equal(tl.numpy().astype(np.int64),
                                          np.asarray(jl).astype(np.int64))
        for tapered in (False, True):
            assert (tft.histogram_nbytes(th, tapered, n_hint)
                    == jft.histogram_nbytes(jh, tapered, n_hint))


@pytest.mark.parametrize("n,p", [(1, 8), (777, 12), (4096, 16), (1 << 20, 24),
                                 (1 << 27, 32), (1 << 29, 16)])
def test_fractal_sort_stats_match_reference(n, p):
    plans = [(None, None), (tsp.make_sort_plan(n, p), jsp.make_sort_plan(n, p)),
             (tsp.make_sort_plan(n, p, max_bins_log2=8),
              jsp.make_sort_plan(n, p, max_bins_log2=8))]
    for with_index in (False, True):
        for tplan, jplan in plans:
            for l_n in ((None, 4) if tplan is None else (None,)):
                got = fractal_sort_stats(n, p, l_n=l_n, with_index=with_index,
                                         plan=tplan)
                want = jax_stats(n, p, l_n=l_n, with_index=with_index,
                                 plan=jplan)
                fields = ("n", "p", "l_n", "passes", "bytes_read",
                          "bytes_written", "histogram_bytes", "bytes_total",
                          "bytes_per_key")
                assert ([getattr(got, f) for f in fields]
                        == [getattr(want, f) for f in fields])
                assert ([(s.shift, s.bits, s.kind, s.bytes_read,
                          s.bytes_written, s.n_bins) for s in got.pass_stats]
                        == [(s.shift, s.bits, s.kind, s.bytes_read,
                             s.bytes_written, s.n_bins) for s in want.pass_stats])
