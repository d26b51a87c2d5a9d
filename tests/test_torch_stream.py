"""The port's out-of-core stream subsystem (``repro_torch.stream``) against
the JAX reference (``repro.stream``) on the CPU.

The same numpy inputs, made from a seed, go through the reference and
through the port with ``device="cpu"`` — on ``TorchBackend``, or on
``CudaBackend`` (``backend="cuda"``), whose kernel wrappers compute their
plain versions on CPU tensors.  Sorted keys, permutations, partition
plans, merged runs and integer operator outputs must be bit-exact
(tolerance 0) and dtypes equal; float64 group sums add in another order
than the reference's ``reduceat`` and are held within 1e-12.  Sizes are
cut from the reference's own tests (``tests/test_stream.py``) so that
both packages run each case together in the suite's time; every sort
still streams about 4x its budget or more (8x where the reference's
case does), and the port's ``peak_bytes`` stays under the limit wherever the
reference asserts that of its own.
"""

import contextlib
import signal

import numpy as np
import pytest
import torch

from repro import query as rq
from repro import stream as rs
from repro.core.sort_plan import DigitPass as JDigitPass
from repro_torch import query as tq
from repro_torch import stream as ts
from repro_torch.core import CudaBackend, PlanExecutor
from repro_torch.core.sort_plan import DigitPass
from repro_torch.stream import external as text
from repro_torch.stream import partition as tpart

F64_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _empty_autotune_cache(tmp_path, monkeypatch):
    """The reference resolves partition plans through its autotune cache,
    and so do the port's; empty ones give both sides the static plans."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))


@contextlib.contextmanager
def hard_timeout(seconds: int):
    """SIGALRM-based wall clock: a case that hangs (a worker pool that
    never returns) must fail, not stall the suite."""

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


def _dist_keys(rng, name: str, n: int, p: int) -> np.ndarray:
    hi = 1 << p
    if name == "uniform":
        k = rng.integers(0, hi, n, dtype=np.uint64)
    elif name == "zipf":
        k = np.minimum(rng.zipf(1.3, n), hi - 1)
    elif name == "all_equal":
        k = np.full(n, hi // 3, np.uint64)
    elif name == "reverse_sorted":
        k = np.sort(rng.integers(0, hi, n, dtype=np.uint64))[::-1]
    elif name == "onehot_bin":
        # ~95% of keys land in one MSD bin: the recursion (skew) path
        bin_lo = (hi // 2) & ~((hi >> 10) - 1) if p >= 10 else 0
        skew = bin_lo + rng.integers(0, max(hi >> 10, 1), n, dtype=np.uint64)
        k = np.where(rng.random(n) < 0.95, skew,
                     rng.integers(0, hi, n, dtype=np.uint64))
    else:
        raise AssertionError(name)
    return k.astype(np.uint32).astype(np.int32 if p < 32 else np.uint32)


def _cat(pieces, dtype) -> np.ndarray:
    return (np.concatenate([_np(p) for p in pieces]) if pieces
            else np.zeros((0,), dtype))


def _both_sort(keys, p, limit, chunk_bytes, backend="torch", **kw):
    """(reference output, port output, port budget) of one external sort
    of ``keys`` under a ``limit``-byte budget, source chunks of
    ``budget.rows(chunk_bytes)`` rows."""
    rb, tb = rs.MemoryBudget(limit), ts.MemoryBudget(limit)
    want = _cat(list(rs.external_sort(
        rs.ArraySource(keys, rb.rows(chunk_bytes)), p, rb, **kw)), keys.dtype)
    got = _cat(list(ts.external_sort(
        ts.ArraySource(keys, tb.rows(chunk_bytes)), p, tb, device="cpu",
        backend=backend, **kw)), keys.dtype)
    return want, got, tb


def _both_argsort(keys, p, limit, chunk_bytes, backend="torch"):
    rb, tb = rs.MemoryBudget(limit), ts.MemoryBudget(limit)
    want = list(rs.external_argsort(
        rs.ArraySource(keys, rb.rows(chunk_bytes)), p, rb))
    got = list(ts.external_argsort(
        ts.ArraySource(keys, tb.rows(chunk_bytes)), p, tb, device="cpu",
        backend=backend))
    return ((_cat([k for k, _ in want], keys.dtype),
             _cat([i for _, i in want], np.int64)),
            (_cat([k for k, _ in got], keys.dtype),
             _cat([i for _, i in got], np.int64)), tb)


def _same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# --- external_sort against the reference --------------------------------------


@pytest.mark.parametrize("dist", ["uniform", "zipf", "all_equal",
                                  "reverse_sorted", "onehot_bin"])
@pytest.mark.parametrize("p", [12, 20, 32])
def test_external_sort_matches_reference(rng, dist, p):
    keys = _dist_keys(rng, dist, 3000, p)
    want, got, tb = _both_sort(keys, p, 3 * 1024, 8,  # data = 4x the budget
                               backend="cuda" if p == 32 else "torch")
    _same(got, want)
    _same(got, np.sort(keys))
    assert tb.peak_bytes <= tb.limit_bytes


@pytest.mark.parametrize("n,chunk_rows", [
    (1, 7), (7, 7), (8, 7), (9, 7), (4097, 64), (5000, 999),
])
def test_external_sort_chunk_boundaries(rng, n, chunk_rows):
    """Ragged tails, single-row data sets, chunks that divide n exactly."""
    keys = _dist_keys(rng, "uniform", n, 16)
    rb, tb = rs.MemoryBudget(2048), ts.MemoryBudget(2048)
    want = _cat(list(rs.external_sort(rs.ArraySource(keys, chunk_rows), 16,
                                      rb)), keys.dtype)
    got = _cat(list(ts.external_sort(ts.ArraySource(keys, chunk_rows), 16,
                                     tb, device="cpu")), keys.dtype)
    _same(got, want)


def test_external_sort_budget_smaller_than_one_partition(rng):
    """Every key in one MSD bin and the budget below the bin count: the
    recursive re-partition carries the whole sort, several levels deep."""
    keys = ((3 << 20) | rng.integers(0, 1 << 6, 1500, dtype=np.uint64)
            .astype(np.uint32)).astype(np.int32)
    want, got, tb = _both_sort(keys, 24, 1024, 8)
    _same(got, want)
    assert tb.peak_bytes <= tb.limit_bytes


def test_external_sort_generator_source():
    """GeneratorSource: the data set is produced per pass, never stored;
    the port's factory yields tensors."""
    def factory(as_tensor):
        g = np.random.default_rng(7)  # fresh per pass: identical streams
        for _ in range(12):
            a = g.integers(0, 1 << 16, 500).astype(np.int32)
            yield torch.from_numpy(a) if as_tensor else a

    want = np.concatenate(list(rs.external_sort(
        rs.GeneratorSource(lambda: factory(False)), 16,
        rs.MemoryBudget(4 * 1024))))
    got = _cat(list(ts.external_sort(
        ts.GeneratorSource(lambda: factory(True)), 16,
        ts.MemoryBudget(4 * 1024), device="cpu")), np.int32)
    _same(got, want)


def test_external_sort_empty_and_p0():
    budget = ts.MemoryBudget(1024)
    empty = np.zeros(0, np.int32)
    assert list(ts.external_sort(ts.ArraySource(empty, 4), 16, budget,
                                 device="cpu")) == []
    assert list(ts.external_argsort(ts.ArraySource(empty, 4), 16, budget,
                                    device="cpu")) == []
    # p=0: every key is the zero-width value; output is arrival order
    keys = np.zeros(3000, np.int32)
    want = np.concatenate(list(rs.external_sort(
        rs.ArraySource(keys, 500), 0, rs.MemoryBudget(1024))))
    got = _cat(list(ts.external_sort(ts.ArraySource(keys, 500), 0,
                                     ts.MemoryBudget(1024), device="cpu")),
               np.int32)
    _same(got, want)
    pieces = list(ts.external_argsort(ts.ArraySource(keys, 500), 0,
                                      ts.MemoryBudget(1024), device="cpu"))
    _same(_cat([i for _, i in pieces], np.int64), np.arange(3000))


# --- the acceptance bar: >= 8x budget, bit-exact, peak under the cap ---------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_external_sort_8x_budget_bit_exact_within_peak(rng, backend):
    limit = 4 * 1024
    keys = _dist_keys(rng, "uniform", 8 * limit // 4, 32)  # 8x the budget
    want, got, tb = _both_sort(keys, 32, limit, 8, backend=backend)
    _same(got, want)
    assert got.dtype == np.uint32
    assert tb.peak_bytes <= tb.limit_bytes, (
        f"peak resident {tb.peak_bytes} B exceeded {tb.limit_bytes} B")
    assert tb.peak_bytes > 0, "the tracker must have seen the arrays"


def test_external_argsort_8x_budget_stable(rng):
    limit = 4 * 1024
    # duplicate-heavy: stability is observable on every spilled run
    keys = rng.integers(0, 97, 8 * limit // 4).astype(np.int32)
    # chunks of one partition's rows: the port's budget also counts each
    # chunk's split copy and its device working set beside the chunk
    want, got, tb = _both_argsort(keys, 7, limit,
                                  text.row_cost_bytes(1, 8), backend="cuda")
    _same(got[0], want[0])
    _same(got[1], want[1])
    _same(got[1], np.argsort(keys, kind="stable"))
    assert tb.peak_bytes <= tb.limit_bytes


@pytest.mark.parametrize("dist", ["zipf", "onehot_bin"])
def test_external_argsort_stable_under_skew(rng, dist):
    keys = _dist_keys(rng, dist, 3000, 16)
    want, got, _ = _both_argsort(keys, 16, 2 * 1024, 16)
    _same(got[1], want[1])
    _same(got[0], want[0])


def test_external_sort_rejects_float_keys():
    gen = ts.external_sort(ts.ArraySource(np.ones(8, np.float32), 4), 32,
                           ts.MemoryBudget(1024), device="cpu")
    with pytest.raises(TypeError, match="int32/uint32"):
        list(gen)
    with pytest.raises(ValueError, match="out of range"):
        ts.external_sort(ts.ArraySource(np.ones(8, np.int32), 4), 33,
                         ts.MemoryBudget(1024), device="cpu")


def test_external_sort_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.external_sort(ts.ArraySource(np.ones(8, np.int32), 4), 16,
                         ts.MemoryBudget(1024))


# --- partition planning ----------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_streamed_counts_carry_spill_window(rng, monkeypatch, backend):
    """The int32 carry spills onto the host int64 total before a window
    can overflow — a tiny window makes several spills over ordinary data;
    the counts equal the reference's with the same window."""
    from repro.stream import partition as rpart

    monkeypatch.setattr(rpart, "_CARRY_SPILL_ROWS", 1000)
    monkeypatch.setattr(tpart, "_CARRY_SPILL_ROWS", 1000)
    keys = rng.integers(0, 1 << 8, 5000).astype(np.uint32)
    chunks = [keys[lo:lo + 700] for lo in range(0, 5000, 700)]
    want, wtotal = rpart.streamed_field_counts(iter(chunks),
                                               JDigitPass(shift=4, bits=4))
    ex = PlanExecutor(CudaBackend()) if backend == "cuda" else None
    got, total = tpart.streamed_field_counts(
        iter(chunks), DigitPass(shift=4, bits=4), ex, device="cpu")
    assert total == wtotal == 5000 and got.dtype == np.int64
    _same(got, want)


@pytest.mark.parametrize("counts,budget_rows", [
    ([5, 3, 0, 9, 2, 0, 0, 4], 10),
    ([0, 0, 50, 1, 1], 10),
    ([20, 30], 10),
    ([0, 0, 0, 7], 3),
])
def test_partition_plan_matches_reference(counts, budget_rows):
    """Greedy packing, lone oversized bins, empty bins: the same counts
    give the same partitions and the same bin → partition table."""
    counts = np.asarray(counts, np.int64)
    want = rs.partition_bins(counts, budget_rows)
    got = ts.partition_bins(counts, budget_rows)
    assert [(p.lo, p.hi, p.count) for p in got] == \
        [(p.lo, p.hi, p.count) for p in want]
    assert [p.oversized(budget_rows) for p in got] == \
        [p.oversized(budget_rows) for p in want]
    _same(tpart.bin_to_partition(got, counts.shape[0]),
          rs.partition.bin_to_partition(want, counts.shape[0]))


def test_shared_field_bits_matches_reference():
    for lo, hi, w in [(5, 6, 10), (4, 8, 10), (0, 1 << 10, 10), (0, 3, 10),
                      (7, 9, 4), (1, 2, 1)]:
        assert ts.KeyPartition(lo, hi, 1).shared_field_bits(w) == \
            rs.KeyPartition(lo, hi, 1).shared_field_bits(w)


# --- the k-way merge (pure-streaming path) ------------------------------------


def _spill_runs(store, rng, sizes):
    ids = []
    for i, m in enumerate(sizes):
        k = np.sort(rng.integers(0, 300, m).astype(np.int32))
        ids.append(store.put(k, np.full(m, i, np.int32),
                             np.arange(m, dtype=np.int32)))
    return ids


def test_merge_runs_matches_reference(rng):
    sizes = [int(s) for s in rng.integers(1, 4000, 5)]
    with rs.RunStore() as rstore, ts.RunStore() as tstore:
        rids = _spill_runs(rstore, np.random.default_rng(1), sizes)
        tids = _spill_runs(tstore, np.random.default_rng(1), sizes)
        want = list(rs.merge_runs(rstore, rids, rs.MemoryBudget(4096)))
        got = list(ts.merge_runs(tstore, tids, ts.MemoryBudget(4096)))
        for j in range(3):
            _same(np.concatenate([o[j] for o in got]),
                  np.concatenate([o[j] for o in want]))


def test_merge_runs_single_and_empty():
    with ts.RunStore() as store:
        rid = store.put(np.array([1, 2, 3], np.int32))
        assert list(ts.merge_runs(store, [], ts.MemoryBudget(64))) == []
        _same(np.concatenate([o[0] for o in ts.merge_runs(
            store, [rid], ts.MemoryBudget(64))]), np.array([1, 2, 3],
                                                          np.int32))


# --- RunStore / MemoryBudget ---------------------------------------------------


def test_run_store_round_trip_and_logs(tmp_path):
    store = ts.RunStore(str(tmp_path / "runs"))
    a = np.arange(10, dtype=np.int32)
    b = torch.arange(10, dtype=torch.float32)  # a tensor goes to the host
    rid = store.put(a, b)
    got = store.get(rid)
    _same(got[0], a)
    _same(got[1], b.numpy())
    assert store.put_log == [rid] and store.get_log == [rid]
    assert store.nbytes() > 0
    store.delete(rid)
    assert len(store) == 0
    store.close()


def test_memory_budget_rows_and_charge():
    for mod in (rs, ts):
        b = mod.MemoryBudget(1024, headroom=2)
        assert b.rows(4) == 128 and b.rows(100000) == 1
    b = ts.MemoryBudget(1024)
    b.charge(np.zeros(100, np.int32), torch.zeros(10, dtype=torch.int64))
    assert b.peak_bytes == 480
    b.charge(np.zeros(1, np.int8))
    assert b.peak_bytes == 480, "peak is a high-water mark"


def test_run_store_distribute_groups_rows_by_partition(rng):
    """The device split (here on the CPU, through both backends) puts each
    partition's rows in arrival order and drops pruned rows, as the
    reference's host split does."""
    words = rng.integers(0, 1 << 32, (1000, 1), dtype=np.uint64) \
        .astype(np.uint32)
    pay = np.arange(1000, dtype=np.int64)
    pid = rng.integers(-1, 3, 1000).astype(np.int64)  # -1: pruned rows
    with rs.temp_store() as ref:
        want = [[ref.get(r) for r in ids]
                for ids in ref.distribute(words, (pay,), pid, 3)]
    for backend in ("torch", "cuda"):
        with ts.temp_store() as store:
            ids = store.distribute(torch.from_numpy(words.view(np.int32)),
                                   (torch.from_numpy(pay),),
                                   torch.from_numpy(pid), 3,
                                   backend=backend)
            for i in range(3):
                got = [store.get(r) for r in ids[i]]
                assert len(got) == len(want[i])
                for g, w in zip(got, want[i]):
                    _same(g[0], w[0])
                    _same(g[1], w[1])


# --- StreamTable operators against the reference ------------------------------


def _stream_cols(rng, n):
    return {"k": rng.integers(-200, 200, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32),
            "w": rng.standard_normal(n).astype(np.float32)}


def _both_streams(cols, limit):
    rt, tt = rq.Table(cols), tq.Table(cols, device="cpu")
    return (rt, rs.StreamTable.from_table(rt, rs.MemoryBudget(limit)),
            tt, ts.StreamTable.from_table(tt, ts.MemoryBudget(limit),
                                          device="cpu"))


def _check_table(got: "tq.Table", want, rtol=None) -> None:
    g, w = got.to_numpy(), want.to_numpy() if hasattr(want, "to_numpy") \
        else {n: np.asarray(want.column(n)) for n in want.column_names}
    assert list(g) == list(w)
    for name in w:
        a, b = g[name], np.asarray(w[name])
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if rtol and name in rtol:
            np.testing.assert_allclose(a, b, rtol=rtol[name])
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_stream_order_by_matches_reference(rng, backend):
    cols = _stream_cols(rng, 3000)
    _, rst, tt, tst = _both_streams(cols, 8 * 1024)
    by = [("k", "asc"), ("v", "desc")]
    res = tq.order_by(tst, by, backend=backend)
    assert isinstance(res, ts.StreamTable), "streaming in, streaming out"
    want = rq.order_by(rst, by)
    _check_table(res.to_table(), want.to_table())
    _check_table(res.to_table(), tq.order_by(tt, by))
    assert tst.budget.peak_bytes <= tst.budget.limit_bytes
    res.close()
    want.close()


def test_stream_order_by_result_is_reiterable(rng):
    _, _, _, tst = _both_streams(_stream_cols(rng, 2000), 8 * 1024)
    res = tq.order_by(tst, "k")
    first, second = res.to_table(), res.to_table()
    _check_table(first, second)
    assert all(c.device.type == "cpu" for c in
               (first.column(n) for n in first.column_names))
    res.close()


def test_stream_group_by_matches_reference(rng):
    cols = _stream_cols(rng, 1500)
    cols["f"] = rng.standard_normal(1500)
    _, rst, tt, tst = _both_streams(cols, 8 * 1024)
    aggs = {"s": ("v", "sum"), "c": (None, "count"),
            "mn": ("v", "min"), "mx": ("w", "max"), "fs": ("f", "sum")}
    got = tq.group_by(tst, "k", aggs, backend="cuda")
    _check_table(got, rq.group_by(rst, "k", aggs), rtol={"fs": F64_RTOL})
    _check_table(got, tq.group_by(tt, "k", aggs), rtol={"fs": F64_RTOL})
    assert tst.budget.peak_bytes <= tst.budget.limit_bytes


def test_stream_group_by_all_equal_keys(rng):
    """One group split across every partition chunk: the boundary merge
    folds the partials back into a single row."""
    n = 1500
    cols = {"k": np.zeros(n, np.int32),
            "v": rng.integers(0, 100, n).astype(np.int32)}
    _, rst, _, tst = _both_streams(cols, 2048)
    aggs = {"s": ("v", "sum"), "c": (None, "count")}
    got = tq.group_by(tst, "k", aggs)
    assert got.num_rows == 1
    _check_table(got, rq.group_by(rst, "k", aggs))


def test_stream_group_by_code_identity_at_boundaries():
    """Boundary groups merge by ENCODED code: -0.0 and 0.0 are distinct
    float32 codes (two groups), NaN keys share a code (one group)."""
    n = 1500
    aggs = {"c": (None, "count")}
    for k in (np.where(np.arange(n) % 2 == 0, -0.0, 0.0).astype(np.float32),
              np.full(n, np.nan, np.float32)):
        _, rst, _, tst = _both_streams({"k": k, "v": np.ones(n, np.int32)},
                                       2048)
        got = tq.group_by(tst, "k", aggs)
        want = rq.group_by(rst, "k", aggs)
        np.testing.assert_array_equal(got.to_numpy()["k"].view(np.uint32),
                                      np.asarray(want.column("k"))
                                      .view(np.uint32))
        _same(got.to_numpy()["c"], np.asarray(want.column("c")))


def test_stream_top_k_matches_reference(rng):
    _, rst, tt, tst = _both_streams(_stream_cols(rng, 3000), 8 * 1024)
    by = [("v", "desc"), ("k", "asc")]
    for k in (0, 1, 37, 1000):
        got = tq.top_k(tst, by, k, backend="cuda" if k % 2 else "torch")
        _check_table(got, rq.top_k(rst, by, k))
        _check_table(got, tq.top_k(tt, by, k))


class _CountingStore(ts.RunStore):
    def __init__(self):
        super().__init__()
        self.rows_put = 0

    def put(self, *arrays, partition=None):
        self.rows_put += int(arrays[0].shape[0])
        return super().put(*arrays, partition=partition)


def test_stream_top_k_prunes_spill_and_never_loads_skipped_runs(rng):
    """The MSD histogram proves which partitions can reach rank k; the rest
    are never spilled and never loaded — counted, not eyeballed."""
    n = 6000
    cols = {"k": rng.integers(0, 1 << 30, n).astype(np.int32),
            "v": rng.integers(0, 10, n).astype(np.int32)}
    _, rst, tt, tst = _both_streams(cols, 8 * 1024)
    store = _CountingStore()
    got = ts.stream_top_k(tst, "k", 50, store=store)
    _check_table(got, rs.stream_top_k(rst, "k", 50))
    _check_table(got, tq.top_k(tt, "k", 50))
    assert store.rows_put < n // 2, (
        f"pruning must skip most partitions at spill time "
        f"(spilled {store.rows_put}/{n} rows)")
    assert set(store.get_log) <= set(store.put_log), \
        "loads only of spilled runs"
    store.close()


def test_stream_table_from_chunks_callable(rng):
    n = 3000
    k = rng.integers(0, 100, n).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)

    def chunks(mod, **kw):
        def gen():
            for lo in range(0, n, 400):
                yield mod.Table({"k": k[lo:lo + 400], "v": v[lo:lo + 400]},
                                **kw)
        return gen

    tst = ts.StreamTable(chunks(tq, device="cpu"), ts.MemoryBudget(4 * 1024),
                         device="cpu")
    assert tst.column_names == ("k", "v")
    assert tst.num_rows_streamed() == n
    res = tq.order_by(tst, "k")
    want = rq.order_by(rs.StreamTable(chunks(rq), rs.MemoryBudget(4 * 1024)),
                       "k")
    _check_table(res.to_table(), want.to_table())
    res.close()


def test_stream_operators_refuse_what_the_reference_refuses(rng):
    t = tq.Table({"k": np.arange(8, dtype=np.int32)}, device="cpu")
    st = ts.StreamTable.from_table(t, ts.MemoryBudget(1024), device="cpu")
    with pytest.raises(TypeError, match="distinct is in-memory only"):
        tq.distinct(st)
    with pytest.raises(ValueError, match="pinned plans"):
        tq.order_by(st, "k", plans=())
    with pytest.raises(TypeError,
                       match="is not a repro_torch.stream.PlacementStore"):
        tq.order_by(st, "k", placement=object())
    with ts.RunStore() as store:  # any PlacementStore places fragments
        got = tq.order_by(st, "k", placement=store).to_table()
        _same(got.to_numpy()["k"], np.arange(8, dtype=np.int32))


# --- external sort with a caller-provided store -------------------------------


def test_external_sort_caller_store_left_open(rng, tmp_path):
    keys = _dist_keys(rng, "uniform", 3000, 16)
    for mod, root in ((rs, "ref"), (ts, "port")):
        store = mod.RunStore(str(tmp_path / root))
        budget = mod.MemoryBudget(3 * 1024)
        kw = {"device": "cpu"} if mod is ts else {}
        out = _cat(list(mod.external_sort(
            mod.ArraySource(keys, budget.rows(8)), 16, budget, store=store,
            **kw)), keys.dtype)
        _same(out, np.sort(keys))
        assert len(store) == 0, "fragments are dropped as partitions finish"
        store.close()


# --- narrowed partition sorts ----------------------------------------------------


@pytest.mark.parametrize("bits,low_bits", [(32, 22), (32, 5), (48, 17),
                                           (48, 40), (20, 20), (20, 0)])
def test_sort_rowids_narrowed_matches_reference(rng, bits, low_bits):
    """A narrowed sort (shared high bits implied) equals the reference's
    and the full stable sort whenever the shared bits really are
    constant — the external sort's per-partition invariant."""
    import jax.numpy as jnp
    from repro.query.codec import word_widths
    from repro.query.operators import sort_rowids as rsort

    n = 2048
    widths = word_widths(bits)
    shared = int(rng.integers(0, 1 << min(bits - low_bits, 30))) if \
        bits > low_bits else 0
    vals = (np.full(n, shared, np.uint64) << np.uint64(low_bits)) | \
        rng.integers(0, max(1 << min(low_bits, 60), 1), n, dtype=np.uint64)
    words = np.zeros((n, len(widths)), np.uint32)
    off = bits
    for j, wj in enumerate(widths):
        off -= wj
        words[:, j] = ((vals >> np.uint64(off)) &
                       np.uint64((1 << wj) - 1)).astype(np.uint32)
    want_w, want_r = rsort(jnp.asarray(words), bits, low_bits=low_bits)
    for backend in ("torch", "cuda"):
        sw, rowids = tq.sort_rowids(torch.from_numpy(words.view(np.int32)),
                                    bits, low_bits=low_bits, backend=backend)
        _same(rowids.numpy().astype(np.int64),
              np.asarray(want_r).astype(np.int64))
        _same(sw.numpy().view(np.uint32), np.asarray(want_w))
        _same(rowids.numpy().astype(np.int64),
              np.argsort(vals, kind="stable"))


def test_external_sort_narrowing_matches_reference_tight_partitions(rng):
    """A small budget → many partitions → deep narrowing."""
    keys = _dist_keys(rng, "zipf", 4096, 32)
    want, got, _ = _both_sort(keys, 32, 2 * 1024, 8, backend="cuda")
    _same(got, want)


# --- overlapped sort + spill I/O (REPRO_STREAM_WORKERS) -----------------------


@pytest.mark.parametrize("dist", ["uniform", "onehot_bin", "all_equal"])
def test_external_argsort_worker_count_invariant(rng, dist, monkeypatch):
    """Output is bit-identical at 1 vs N workers and equal to the
    reference's — the lookahead pool only overlaps load+sort."""
    keys = _dist_keys(rng, dist, 8000, 32)

    def run(mod, workers):
        monkeypatch.setenv("REPRO_STREAM_WORKERS", str(workers))
        budget = mod.MemoryBudget(8 * 1024)
        kw = {"device": "cpu", "backend": "cuda"} if mod is ts else {}
        parts = list(mod.external_argsort(
            mod.ArraySource(keys, budget.rows(12)), 32, budget, **kw))
        return (_cat([p[0] for p in parts], keys.dtype),
                _cat([p[1] for p in parts], np.int64))

    with hard_timeout(120):
        k1, r1 = run(ts, 1)
        k3, r3 = run(ts, 3)
    _same(k3, k1)
    _same(r3, r1)
    wk, wr = run(rs, 1)
    _same(k1, wk)
    _same(r1, wr)


def test_stream_workers_env_parsing(monkeypatch):
    from repro.stream.external import _stream_workers as rworkers

    for value, want in ((None, 1), ("4", 4), ("0", 1), ("not-a-number", 1)):
        if value is None:
            monkeypatch.delenv("REPRO_STREAM_WORKERS", raising=False)
        else:
            monkeypatch.setenv("REPRO_STREAM_WORKERS", value)
        assert text._stream_workers() == rworkers() == want


# --- the byte model ---------------------------------------------------------------


def test_row_cost_covers_the_partition_sort_and_the_distribute():
    """At the most rows a partition may hold and at 2x padding, the
    partition sort's working set fits the budget, and so does a chunk of
    as many rows with its distribute."""
    from repro_torch.stream.chunks import distribute_bytes, partition_sort_bytes

    for limit in (4096, 64 << 20):
        for num_words, pay in ((1, 0), (1, 8), (2, 12), (3, 30)):
            b = ts.MemoryBudget(limit)
            rows = b.rows(text.row_cost_bytes(num_words, pay))
            pad = 1 << max(rows - 1, 0).bit_length()
            assert pad < 2 * rows + 1
            assert partition_sort_bytes(pad, rows, num_words, pay) <= limit
            chunk = rows * (4 * num_words + pay)
            assert chunk + distribute_bytes(rows, rows, num_words,
                                            pay) <= limit
