"""The port's query layer (``repro_torch.query``) against the JAX
reference (``repro.query``) on the CPU.

The same numpy columns, made from a seed, go through the reference (jax
on the CPU, pointed at an empty autotune cache so it resolves the static
plans the port resolves) and through the port with ``device="cpu"`` on
both port backends: ``TorchBackend`` and ``CudaBackend``, whose kernel
wrappers compute their plain versions on CPU tensors.  Codes, row ids,
counts, integer aggregates, min and max must be bit-exact (compared as
numpy views, floats by their bits) and dtypes equal; float sums add in
another order than the reference's ``reduceat`` and are held within
rtol 1e-5 (float32) and 1e-12 (float64).
"""

import numpy as np
import pytest
import torch

from repro import query as rq
from repro.core import make_sort_plan as jax_make_sort_plan
from repro.query import operators as rops
from repro_torch import query as tq
from repro_torch.core import convert_plan, dispatch, make_sort_plan
from repro_torch.query import operators as tops

BACKENDS = ("torch", "cuda")
F32_RTOL, F64_RTOL = 1e-5, 1e-12


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
    """The reference resolves plans through its autotune cache, and so
    does this package; empty ones give both sides the static plans."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a: np.ndarray) -> np.ndarray:
    """Floats by their bit patterns (NaN and -0.0 compare exactly)."""
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


def _words_equal(got, want) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g.view(np.uint32), w.astype(np.uint32))


def _tables(cols: dict):
    return rq.Table(cols), tq.Table(cols, device="cpu")


def _check_table(got: "tq.Table", want, rtol=None) -> None:
    """Same columns in the same order, equal dtypes, bit-exact values
    (columns named in ``rtol`` within that relative tolerance)."""
    g, w = got.to_numpy(), want.to_numpy()
    assert list(g) == list(w)
    for name in w:
        a, b = g[name], np.asarray(w[name])
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if rtol and name in rtol:
            np.testing.assert_allclose(a, b, rtol=rtol[name])
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def _each_backend(port_op, want, rtol=None) -> None:
    for backend in BACKENDS:
        _check_table(port_op(backend), want, rtol)


# --- codecs -------------------------------------------------------------------

CODEC_CASES = {
    "bool": ("BoolCodec", (), lambda rng, n: rng.random(n) < 0.5),
    "int8": ("IntCodec", (8,), lambda rng, n:
             rng.integers(-128, 128, n).astype(np.int8)),
    "int16": ("IntCodec", (16,), lambda rng, n:
              rng.integers(-(1 << 15), 1 << 15, n).astype(np.int16)),
    "int32": ("IntCodec", (32,), lambda rng, n:
              rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
              .astype(np.int32)),
    "int20_of_int32": ("IntCodec", (20,), lambda rng, n:
                       rng.integers(-(1 << 19), 1 << 19, n).astype(np.int32)),
    "uint8": ("UIntCodec", (8,), lambda rng, n:
              rng.integers(0, 256, n).astype(np.uint8)),
    "uint16": ("UIntCodec", (16,), lambda rng, n:
               rng.integers(0, 1 << 16, n).astype(np.uint16)),
    "uint32": ("UIntCodec", (32,), lambda rng, n:
               rng.integers(0, 1 << 32, n, dtype=np.uint64)
               .astype(np.uint32)),
    "float32": ("Float32Codec", (), lambda rng, n: np.concatenate([
        (rng.standard_normal(n - 9) * 10.0 ** rng.integers(-20, 20, n - 9))
        .astype(np.float32),
        np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45,
                    -1e-40, 3.4e38], np.float32)])),
    "float64": ("Float64Codec", (), lambda rng, n: np.concatenate([
        rng.standard_normal(n - 8) * 10.0 ** rng.integers(-200, 200, n - 8),
        np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324, -5e-324,
                    1.7e308])])),
}


@pytest.mark.parametrize("name", sorted(CODEC_CASES))
def test_codec_encode_decode_match_reference(rng, name):
    """Same code words as the reference's codec, and a bitwise round trip
    to the reference's decoded dtype."""
    cls, args, gen = CODEC_CASES[name]
    x = gen(rng, 512)
    want_codec, codec = getattr(rq, cls)(*args), getattr(tq, cls)(*args)
    assert codec.bits == want_codec.bits
    assert codec.num_words == want_codec.num_words
    words = codec.encode(x)
    assert words.dtype == torch.int32 and words.shape == (512, codec.num_words)
    _words_equal(words, want_codec.encode(x))
    back, want_back = _np(codec.decode(words)), np.asarray(
        want_codec.decode(want_codec.encode(x)))
    assert back.dtype == want_back.dtype, (back.dtype, want_back.dtype)
    np.testing.assert_array_equal(_bits(back), _bits(want_back))
    np.testing.assert_array_equal(_bits(back), _bits(np.asarray(x)))


def test_composite_codec_matches_reference(rng):
    """A 41-bit (int8 asc, float32 desc, bool) composite: same two code
    words and the same decoded columns."""
    n = 400
    cols = [rng.integers(-50, 50, n).astype(np.int32),
            rng.standard_normal(n).astype(np.float32), rng.random(n) < 0.5]

    def specs(m):
        return m.CompositeCodec([m.ColumnSpec(m.IntCodec(8)),
                                 m.ColumnSpec(m.Float32Codec(), False),
                                 m.ColumnSpec(m.BoolCodec())])

    codec, want_codec = specs(tq), specs(rq)
    assert codec.bits == want_codec.bits == 41
    assert codec == specs(tq) and hash(codec) == hash(specs(tq))
    words = codec.encode(cols)
    _words_equal(words, want_codec.encode(cols))
    for got, col in zip(codec.decode(words), cols):
        np.testing.assert_array_equal(_bits(_np(got).astype(col.dtype)),
                                      _bits(col))


def test_word_widths_infer_codec_and_word_plans():
    for bits in (1, 9, 32, 33, 41, 64, 65, 80, 96):
        assert tq.word_widths(bits) == rq.word_widths(bits)
    for dtype in (np.bool_, np.int8, np.int16, np.int32, np.uint8,
                  np.uint16, np.uint32, np.float32, np.float64):
        x = np.zeros(3, dtype)
        got, want = tq.infer_codec(x), rq.infer_codec(x)
        assert (type(got).__name__, got.bits) == (type(want).__name__,
                                                  want.bits)
        assert tq.infer_codec(torch.from_numpy(x)) == got
    assert tq.infer_codec(np.zeros(3, np.int32), bits=9).bits == 9
    with pytest.raises(TypeError):
        tq.infer_codec(np.zeros(3, np.complex64))
    codec = tq.CompositeCodec([tq.ColumnSpec(tq.IntCodec(32)),
                               tq.ColumnSpec(tq.IntCodec(9))])
    plans = codec.word_plans(4096, backend="torch")
    want = rq.CompositeCodec([rq.ColumnSpec(rq.IntCodec(32)),
                              rq.ColumnSpec(rq.IntCodec(9))]).word_plans(4096)
    assert plans == tuple(convert_plan(p) for p in want)


# --- fused sort: the nine codec families of tests/test_fused_dispatch.py -------


def _codec_tables():
    rng = np.random.default_rng(11)
    n = 2048
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[:64] = np.nan
    f32[64:96] = 0.0
    f32[96:128] = -0.0
    f32[128:160] = np.float32(1e-40)  # denormal
    f32[160:192] = -np.float32(1e-40)
    f32[192:224] = [np.inf, -np.inf] * 16
    f64 = rng.standard_normal(n)
    f64[:64] = np.nan
    f64[64:96] = -0.0
    f64[96:128] = 5e-324  # denormal
    return {
        "int32_asc": ({"a": rng.integers(-2**31, 2**31, n,
                                         dtype=np.int64).astype(np.int32)},
                      [("a", "asc")]),
        "int32_desc": ({"a": rng.integers(-1000, 1000, n).astype(np.int32)},
                       [("a", "desc")]),
        "bool": ({"a": rng.random(n) < 0.5}, [("a", "asc")]),
        "float32_special": ({"a": f32}, [("a", "desc")]),
        "float64_multiword": ({"a": f64}, [("a", "asc")]),
        "composite_wide": ({"a": rng.integers(0, 1 << 20, n).astype(np.int32),
                            "b": f32, "c": rng.integers(0, 4, n).astype(
                                np.int32)},
                           [("a", "asc"), ("b", "desc"), ("c", "asc")]),
        "low_entropy": ({"a": rng.integers(0, 7, n).astype(np.int32)},
                        [("a", "asc")]),
        "strided": ({"a": (rng.integers(0, 64, n) * 4096).astype(np.int32)},
                    [("a", "desc")]),
        "constant": ({"a": np.full(n, 42, np.int32)}, [("a", "asc")]),
    }


@pytest.mark.parametrize("case", sorted(_codec_tables()))
def test_fused_sort_matches_reference(case):
    """sort_rowids_fused (probe-narrowed, encode inside the chain) returns
    the reference's sorted words and row ids on both backends, equals the
    port's own eager encode-then-sort, and order_by gathers the same
    rows."""
    cols, by = _codec_tables()[case]
    ref_t, t = _tables(cols)
    ref_codec, ref_pre = rops._key_data(ref_t, rops._normalize_by(by), None)
    want_w, want_rid = rops.sort_rowids_fused(ref_codec, ref_pre)
    codec, pre = tops._key_data(t, tops._normalize_by(by), None)
    _words_equal(codec.encode_fn(pre), ref_codec.encode_fn(ref_pre))
    for backend in BACKENDS:
        w, rid = tops.sort_rowids_fused(codec, pre, backend=backend)
        _words_equal(w, want_w)
        np.testing.assert_array_equal(_np(rid), np.asarray(want_rid))
        eager_w, eager_rid = tops.sort_rowids(codec.encode_fn(pre),
                                              codec.bits, backend=backend)
        np.testing.assert_array_equal(_np(eager_rid), _np(rid))
        _words_equal(eager_w, want_w)
    _each_backend(lambda b: tq.order_by(t, by, backend=b),
                  rq.order_by(ref_t, by))


# --- operators ------------------------------------------------------------------


def _mk_cols(rng, n, key_space):
    return {"k": rng.integers(0, key_space, n).astype(np.int32),
            "f": (rng.standard_normal(n) * 100).astype(np.float32),
            "row": np.arange(n, dtype=np.int32)}


@pytest.mark.parametrize("dist", ["uniform", "duplicate_heavy", "all_equal"])
def test_order_by_matches_reference(rng, dist):
    space = {"uniform": 1 << 30, "duplicate_heavy": 7, "all_equal": 1}[dist]
    ref_t, t = _tables(_mk_cols(rng, 2048, space))
    by = [("k", "asc"), ("f", "desc")]
    _each_backend(lambda b: tq.order_by(t, by, backend=b),
                  rq.order_by(ref_t, by))


def test_order_by_stability_desc_and_negative_keys(rng):
    n = 3000
    k = rng.integers(0, 5, n).astype(np.int32)  # heavy duplicates
    ref_t, t = _tables({"k": k, "a": rng.integers(-(1 << 20), 1 << 20, n)
                        .astype(np.int32), "row": np.arange(n, dtype=np.int32)})
    for by in ("k", [("k", "desc")], ["a", ("k", "desc")]):
        want = rq.order_by(ref_t, by)
        _each_backend(lambda b: tq.order_by(t, by, backend=b), want)
    rows = tq.order_by(t, [("k", "desc")]).column("row").numpy()
    np.testing.assert_array_equal(rows, np.argsort(-k.astype(np.int64),
                                                   kind="stable"))


def test_order_by_float64_multiword(rng):
    x = rng.standard_normal(700) * 1e12
    ref_t, t = _tables({"x": x, "i": np.arange(700, dtype=np.int32)})
    _each_backend(lambda b: tq.order_by(t, "x", backend=b),
                  rq.order_by(ref_t, "x"))


def test_sort_rowids_three_words_and_pinned_plans(rng):
    """Random 96-bit codes: the reference's permutation; pinned 8-bit
    scatter plans sort identically; a plan count that does not match the
    active words raises."""
    n = 1200
    words = rng.integers(0, 1 << 32, (n, 3), dtype=np.uint64).astype(np.uint32)
    want_w, want_rid = rq.sort_rowids(words, 96)
    plans = tuple(make_sort_plan(n, 32, max_bins_log2=8, engine="scatter")
                  for _ in range(3))
    for backend in BACKENDS:
        for pinned in (None, plans):
            w, rid = tq.sort_rowids(torch.from_numpy(words), 96, pinned,
                                    backend=backend)
            np.testing.assert_array_equal(_np(rid), np.asarray(want_rid))
            _words_equal(w, want_w)
    with pytest.raises(ValueError, match="plans"):
        tq.sort_rowids(torch.from_numpy(words), 96, plans[:1])


@pytest.mark.parametrize("dist", ["uniform", "zipf", "all_equal"])
def test_group_by_matches_reference(rng, dist):
    n = 4000
    if dist == "uniform":
        g = rng.integers(0, 50, n)
    elif dist == "zipf":
        g = np.clip(rng.zipf(1.3, n) - 1, 0, 63)
    else:
        g = np.zeros(n)
    cols = {"g": g.astype(np.int32),
            "v": rng.integers(-1000, 1000, n).astype(np.int32),
            "w": rng.integers(-100, 100, n).astype(np.int8),
            "u": rng.integers(0, 1 << 16, n).astype(np.uint16),
            "x": (rng.random(n) * 100).astype(np.float32),
            "d": rng.random(n) * 1e6}
    ref_t, t = _tables(cols)
    aggs = {"total": ("v", "sum"), "cnt": (None, "count"),
            "lo": ("v", "min"), "hi": ("v", "max"), "w_sum": ("w", "sum"),
            "u_max": ("u", "max"), "u_sum": ("u", "sum"),
            "x_sum": ("x", "sum"), "x_min": ("x", "min"),
            "d_sum": ("d", "sum"), "d_max": ("d", "max")}
    _each_backend(lambda b: tq.group_by(t, "g", aggs, backend=b),
                  rq.group_by(ref_t, "g", aggs),
                  rtol={"x_sum": F32_RTOL, "d_sum": F64_RTOL})


def test_group_by_composite_key_with_float64(rng):
    n = 2500
    ref_t, t = _tables({"a": rng.integers(0, 4, n).astype(np.int32),
                        "x": np.round(rng.standard_normal(n) * 3, 1),
                        "v": rng.integers(0, 100, n).astype(np.int32)})
    aggs = {"s": ("v", "sum"), "c": (None, "count")}
    _each_backend(lambda b: tq.group_by(t, ["a", ("x", "desc")], aggs,
                                        backend=b),
                  rq.group_by(ref_t, ["a", ("x", "desc")], aggs))


@pytest.mark.parametrize("dup", ["unique_right", "dup_both"])
def test_join_matches_reference(rng, dup):
    nl, nr = 1500, 400
    if dup == "unique_right":
        rk = rng.permutation(1 << 10)[:nr].astype(np.int32)
    else:
        rk = rng.integers(0, 64, nr).astype(np.int32)  # duplicate-heavy
    lk = rng.integers(0, 1 << 10 if dup == "unique_right" else 64,
                      nl).astype(np.int32)
    ref_l, left = _tables({"k": lk, "lv": np.arange(nl, dtype=np.int32),
                           "amt": rng.random(nl)})
    ref_r, right = _tables({"k": rk, "rv": np.arange(nr, dtype=np.int32),
                            "amt": rng.random(nr).astype(np.float32)})
    _each_backend(lambda b: tq.sort_merge_join(left, right, "k", backend=b),
                  rq.sort_merge_join(ref_l, ref_r, "k"))


def test_join_composite_key_with_narrow_codecs(rng):
    n, m = 800, 300

    def side(rows):
        return {"a": rng.integers(0, 8, rows).astype(np.int32),
                "b": rng.integers(-4, 4, rows).astype(np.int32),
                "amt": rng.integers(0, 100, rows).astype(np.int32)}

    ref_l, left = _tables(side(n))
    ref_r, right = _tables(side(m))
    want = rq.sort_merge_join(ref_l, ref_r, ["a", "b"], codecs={
        "a": rq.IntCodec(4), "b": rq.IntCodec(4)})
    _each_backend(lambda b: tq.sort_merge_join(
        left, right, ["a", "b"], codecs={"a": tq.IntCodec(4),
                                         "b": tq.IntCodec(4)}, backend=b),
        want)


def _multiword_join(rng, left_keys: dict, right_keys: dict):
    nl = len(next(iter(left_keys.values())))
    nr = len(next(iter(right_keys.values())))
    ref_l, left = _tables({**left_keys, "lv": np.arange(nl, dtype=np.int32)})
    ref_r, right = _tables({**right_keys,
                            "rv": np.arange(nr, dtype=np.int32)})
    on = list(left_keys)
    _each_backend(lambda b: tq.sort_merge_join(left, right, on, backend=b),
                  rq.sort_merge_join(ref_l, ref_r, on))


@pytest.mark.parametrize("kind", ["float64", "composite_64",
                                  "three_words_uneven_tail"])
def test_join_multiword_matches_reference(rng, kind):
    """Two- and three-word join keys with duplicates, including rows that
    tie in the high word and differ only in a lower one (the 80-bit case
    differs only inside the short 16-bit tail word)."""
    if kind == "float64":
        pool = np.array([1.0, 1.0 + 2.0 ** -40, 1.0 + 2.0 ** -20, -3.5,
                         -3.5 - 2.0 ** -41, 0.0, 7.25], np.float64)
        _multiword_join(rng, {"x": pool[rng.integers(0, 7, 400)]},
                        {"x": pool[rng.integers(0, 7, 150)]})
    elif kind == "composite_64":
        _multiword_join(
            rng, {"a": rng.integers(-4, 4, 600).astype(np.int32),
                  "b": rng.integers(-3, 3, 600).astype(np.int32)},
            {"a": rng.integers(-4, 4, 200).astype(np.int32),
             "b": rng.integers(-3, 3, 200).astype(np.int32)})
    else:
        def keys(rows):
            return {"a": rng.integers(-2, 2, rows).astype(np.int32),
                    "b": rng.integers(-2, 2, rows).astype(np.int32),
                    "c": rng.integers(-8, 8, rows).astype(np.int16)}
        _multiword_join(rng, keys(300), keys(120))


@pytest.mark.parametrize("W,bits", [(1, 32), (1, 9), (2, 64), (2, 41),
                                    (3, 96), (3, 80)])
def test_words_searchsorted_matches_reference(rng, W, bits):
    """The probe of sorted code words: packed int64 up to two words, the
    flagged merge sort above; the same insertion points as the
    reference's numpy probe, with duplicates everywhere."""
    widths = tq.word_widths(bits)
    m, n = 500, 300
    sorted_words = np.stack([rng.integers(0, 4, m).astype(np.uint32)
                             << np.uint32(w - 2) for w in widths], axis=1)
    sorted_words = sorted_words[np.lexsort(sorted_words.T[::-1])]
    queries = np.stack([rng.integers(0, 5, n).astype(np.uint32)
                        << np.uint32(w - 3) for w in widths], axis=1)
    queries &= np.asarray([(1 << w) - 1 for w in widths], np.uint32)
    for side in ("left", "right"):
        want = rops._words_searchsorted(sorted_words, queries, side)
        for backend in BACKENDS:
            got = tops._words_searchsorted(
                torch.from_numpy(sorted_words.view(np.int32)),
                torch.from_numpy(queries.view(np.int32)), bits, side,
                backend)
            np.testing.assert_array_equal(_np(got), want)


def test_join_rejects_mismatched_column_widths():
    cols_l = {"a": np.zeros(4, np.int8), "b": np.zeros(4, np.int16)}
    cols_r = {"a": np.zeros(4, np.int16), "b": np.zeros(4, np.int8)}
    with pytest.raises(ValueError, match="identically"):
        tq.sort_merge_join(tq.Table(cols_l, device="cpu"),
                           tq.Table(cols_r, device="cpu"), ["a", "b"])
    with pytest.raises(ValueError, match="direction"):
        t = tq.Table(cols_l, device="cpu")
        tq.sort_merge_join(t, t, [("a", "desc")])


def test_operator_outputs_compose(rng):
    """Key columns decode to their inferred dtype, so an operator's output
    joins back: group_by → join and distinct → join, as the reference."""
    n = 600
    ref_t, t = _tables({"u": rng.integers(0, 1 << 16, n).astype(np.uint16),
                        "v": rng.integers(0, 50, n).astype(np.int32)})
    ref_g = rq.group_by(ref_t, "u", {"s": ("v", "sum")})
    g = tq.group_by(t, "u", {"s": ("v", "sum")})
    _check_table(g, ref_g)
    _check_table(tq.sort_merge_join(t, g, "u"),
                 rq.sort_merge_join(ref_t, ref_g, "u"))
    ref_t8, t8 = _tables({"k": rng.integers(-128, 128, n).astype(np.int8),
                          "v": np.arange(n, dtype=np.int32)})
    ref_d, d = rq.distinct(ref_t8, "k"), tq.distinct(t8, "k")
    _check_table(d, ref_d)
    _check_table(tq.sort_merge_join(t8, d, "k"),
                 rq.sort_merge_join(ref_t8, ref_d, "k"))


def test_distinct_matches_reference(rng):
    n = 2000
    ref_t, t = _tables({"k": rng.integers(0, 9, n).astype(np.int32),
                        "f": (rng.random(n) < 0.5),
                        "row": np.arange(n, dtype=np.int32)})
    for by in ("k", ["f", ("k", "desc")], None):
        _each_backend(lambda b: tq.distinct(t, by, backend=b),
                      rq.distinct(ref_t, by))


@pytest.mark.parametrize("dist", ["uniform", "all_equal", "skew_low",
                                  "boundary_ties"])
def test_top_k_pruned_matches_reference(rng, dist):
    """The prune histogram keeps exactly the reference's candidates:
    rows, payload and tie order equal at k across the cut bin."""
    n = 1500
    if dist == "uniform":
        k_col = rng.integers(-5000, 5000, n).astype(np.int32)
    elif dist == "all_equal":
        k_col = np.full(n, 42, np.int32)  # every row lands in the cut bin
    elif dist == "skew_low":
        k_col = np.minimum(rng.zipf(1.3, n), 1 << 20).astype(np.int32)
    else:  # ties straddling k at the boundary value
        k_col = np.where(rng.random(n) < 0.5, 7, 9999).astype(np.int32)
    ref_t, t = _tables({"k": k_col, "row": np.arange(n, dtype=np.int32),
                        "v": rng.standard_normal(n).astype(np.float32)})
    for k in (13, 700, n + 10):
        _each_backend(lambda b: tq.top_k(t, "k", k, backend=b),
                      rq.top_k(ref_t, "k", k))
        _check_table(tq.top_k(t, "k", k), rq.order_by(ref_t, "k").head(k))


def test_top_k_multiword_desc_and_k_at_most_zero(rng):
    n = 1000
    ref_t, t = _tables({"d": rng.standard_normal(n),
                        "row": np.arange(n, dtype=np.int32)})
    for by in ("d", [("d", "desc")]):
        _each_backend(lambda b: tq.top_k(t, by, 25, backend=b),
                      rq.top_k(ref_t, by, 25))
    for k in (0, -3):
        assert tq.top_k(t, "d", k).num_rows == 0


def test_operators_on_empty_table():
    ref_t, t = _tables({"k": np.zeros(0, np.int32),
                        "v": np.zeros(0, np.int32)})
    aggs = {"s": ("v", "sum"), "c": (None, "count")}
    for backend in BACKENDS:
        _check_table(tq.order_by(t, "k", backend=backend),
                     rq.order_by(ref_t, "k"))
        _check_table(tq.distinct(t, "k", backend=backend),
                     rq.distinct(ref_t, "k"))
        _check_table(tq.group_by(t, "k", aggs, backend=backend),
                     rq.group_by(ref_t, "k", aggs))
        _check_table(tq.sort_merge_join(t, t, "k", backend=backend),
                     rq.sort_merge_join(ref_t, ref_t, "k"))
        assert tq.top_k(t, "k", 3, backend=backend).num_rows == 0


_EMPTY_F64_OPS = {
    "order_by": lambda m, e, f: m.order_by(e, "k"),
    "group_by": lambda m, e, f: m.group_by(
        e, "k", {"s": ("v", "sum"), "c": (None, "count"), "mx": ("v", "max")}),
    "distinct": lambda m, e, f: m.distinct(e, "k"),
    "top_k": lambda m, e, f: m.top_k(e, [("k", "desc")], 3),
    "join_left_empty": lambda m, e, f: m.sort_merge_join(e, f, "k"),
    "join_right_empty": lambda m, e, f: m.sort_merge_join(f, e, "k"),
    "join_both_empty": lambda m, e, f: m.sort_merge_join(e, e, "k"),
}


@pytest.mark.parametrize("op", sorted(_EMPTY_F64_OPS))
def test_operators_on_empty_float64_key_column(rng, op):
    """A 0-row float64 column built from numpy has stride (0,); the codec's
    bitcast to int32 halves must still take it, and every operator return
    the reference's 0-row result."""
    # int32 values: the reference hands back an empty float64 aggregate
    # as float32 (jax without x64), a dtype the port does not copy
    ref_e, e = _tables({"k": np.zeros(0, np.float64),
                        "v": np.zeros(0, np.int32)})
    full = {"k": rng.standard_normal(9),
            "v": rng.integers(-5, 5, 9).astype(np.int32)}
    ref_f, f = _tables(full)
    run = _EMPTY_F64_OPS[op]
    want = run(rq, ref_e, ref_f)
    assert want.num_rows == 0
    for backend in BACKENDS:
        _check_table(run(_BackendOps(backend), e, f), want)


class _BackendOps:
    """``repro_torch.query``'s operators with ``backend=`` bound."""

    def __init__(self, backend: str):
        self._backend = backend

    def __getattr__(self, name):
        op = getattr(tq, name)
        return lambda *a, **kw: op(*a, backend=self._backend, **kw)


def test_operators_accept_pinned_plans(rng):
    """Pinned plans (the reference's, converted) sort as the defaults do,
    in every operator."""
    n = 1200
    ref_t, t = _tables({"k": rng.integers(0, 100, n).astype(np.int32),
                        "v": rng.integers(0, 10, n).astype(np.int32)})
    ref_plans = (jax_make_sort_plan(n, 32, max_bins_log2=8,
                                    engine="scatter"),)
    plans = tuple(convert_plan(p) for p in ref_plans)
    want = rq.order_by(ref_t, "k", plans=ref_plans)
    _each_backend(lambda b: tq.order_by(t, "k", plans=plans, backend=b), want)
    _check_table(tq.order_by(t, "k", plans=plans), rq.order_by(ref_t, "k"))
    aggs = {"c": (None, "count")}
    _check_table(tq.group_by(t, "k", aggs, plans=plans),
                 rq.group_by(ref_t, "k", aggs, plans=ref_plans))
    _check_table(tq.top_k(t, "k", 17, plans=plans),
                 rq.top_k(ref_t, "k", 17, plans=ref_plans))


def test_sort_rowids_batched_matches_reference(rng):
    """Four 512-row partitions of 64-bit codes, the last padded with
    all-ones sentinel rows, each sorted within its own segment."""
    L_log2, parts = 9, 4
    words = rng.integers(0, 1 << 32, (parts << L_log2, 2),
                         dtype=np.uint64).astype(np.uint32)
    words[:, 0] &= np.uint32(0xFF)  # duplicate-heavy high word
    words[-100:] = np.uint32(0xFFFFFFFF)
    for low_bits in (None, 40):
        want_w, want_rid = rq.operators.sort_rowids_batched(
            words, 64, L_log2, low_bits=low_bits)
        for backend in BACKENDS:
            w, rid = tq.operators.sort_rowids_batched(
                torch.from_numpy(words), 64, L_log2, low_bits=low_bits,
                backend=backend)
            np.testing.assert_array_equal(_np(rid), np.asarray(want_rid))
            _words_equal(w, want_w)
    with pytest.raises(ValueError, match="multiple"):
        tq.operators.sort_rowids_batched(torch.from_numpy(words[:100]), 64,
                                         L_log2)


def test_active_words_match_reference():
    for bits, low in ((96, None), (96, 40), (80, 20), (64, 0), (9, 5)):
        assert tops.active_words(bits, low) == rops.active_words(bits, low)


# --- dispatch accounting ----------------------------------------------------------


def test_order_by_is_one_probe_plus_one_chain(rng):
    """A warm order_by records one used-bits probe and one chain, whatever
    its number of key words and payload columns; the first call of a new
    chain configuration records one compile."""
    t = tq.Table({"k": rng.integers(0, 1 << 10, 4096).astype(np.int32),
                  "v": rng.standard_normal(4096).astype(np.float32)},
                 device="cpu")
    by = [("k", "asc"), ("v", "desc")]
    tops._fused_chain.cache_clear()
    with dispatch.track() as cold:
        tq.order_by(t, by)
    assert cold.get("query.chain:compiles") == 1, cold
    with dispatch.track() as seen:
        tq.order_by(t, by)
    execs = {k: v for k, v in seen.items() if k.startswith("query.")}
    assert execs == {"query.probe": 1, "query.chain": 1}, execs
    info = tops._fused_chain.cache_info()
    assert info.misses == 1 and info.hits == 1


def test_dispatch_counts_land_in_the_metrics_registry():
    from repro_torch.obs import metrics

    before = metrics.snapshot()
    with dispatch.track() as seen:
        dispatch.record("test.tag", compiles=2)
    assert seen == {"test.tag": 1, "test.tag:compiles": 2}
    delta = metrics.snapshot_delta(before)
    assert delta["dispatch.test.tag"] == 1
    assert delta["dispatch.test.tag.compiles"] == 2


# --- the port's own contract ------------------------------------------------------


def test_stream_inputs_and_placement_name_the_stream_item(rng):
    """A placement on an in-memory Table is refused (ValueError, as the
    reference refuses it); inputs that are neither a Table nor a
    StreamTable are a TypeError; so is a StreamTable's placement that is
    not a PlacementStore (the message names both stores)."""
    from repro_torch.stream import MemoryBudget, StreamTable

    t = tq.Table({"k": np.arange(8, dtype=np.int32)}, device="cpu")
    for call in (lambda: tq.order_by(t, "k", placement=object()),
                 lambda: tq.top_k(t, "k", 3, placement=object()),
                 lambda: tq.group_by(t, "k", {}, placement=object())):
        with pytest.raises(ValueError, match="placement"):
            call()
    for call in (lambda: tq.order_by({"k": np.arange(8)}, "k"),
                 lambda: tq.distinct(object()),
                 lambda: tq.sort_merge_join(t, object(), "k")):
        with pytest.raises(TypeError):
            call()
    st = StreamTable.from_table(t, MemoryBudget(1024), device="cpu")
    with pytest.raises(TypeError,
                       match="is not a repro_torch.stream.PlacementStore"):
        tq.top_k(st, "k", 3, placement=object())


def test_table_defaults_to_the_card_and_gathers_every_dtype(rng):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tq.Table({"k": np.arange(4)})
    cols = {"b": rng.random(6) < 0.5, "i8": np.arange(6, dtype=np.int8),
            "u16": np.arange(6, dtype=np.uint16),
            "u32": np.arange(6, dtype=np.uint32) << np.uint32(30),
            "f64": rng.standard_normal(6)}
    t = tq.Table(cols, device="cpu")
    taken = t.take(torch.tensor([5, 0, 3], dtype=torch.int32)).to_numpy()
    for name, col in cols.items():
        assert taken[name].dtype == col.dtype
        np.testing.assert_array_equal(taken[name], col[[5, 0, 3]])
    assert t.head(2).num_rows == 2 and t.select(["b"]).column_names == ("b",)
    with pytest.raises(ValueError, match="rows"):
        tq.Table({"a": np.zeros(3), "b": np.zeros(4)}, device="cpu")


def test_example_pipeline_runs_on_the_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, str(root / "examples" / "torch_query_pipeline.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src"),
                           OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "query pipeline OK on cpu" in res.stdout
