"""repro_torch public sorts, executor modes and rank engines vs the JAX
reference, on the CPU (``device="cpu"``).

Every public entry point — ``fractal_sort``, ``fractal_sort_pairs``,
``fractal_argsort`` on both port backends (``TorchBackend``, and
``CudaBackend`` whose kernel wrappers compute their plain versions on
CPU tensors), plus ``fractal_sort_kernel`` / ``fractal_sort_pairs_kernel``
— must return exactly what the reference returns (``JnpBackend`` through
the jitted public sorts, ``PallasBackend`` in interpret mode), compared
as numpy uint32 views.  Inputs are numpy arrays from a seed; every JAX
call gets an explicit plan, so no autotune cache can make the sides
diverge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import JnpBackend, PallasBackend
from repro.core import PlanExecutor as JaxExecutor
from repro.core import sort_plan as jsp
from repro.core.fractal_sort import fractal_argsort as jax_argsort
from repro.core.fractal_sort import fractal_rank as jax_rank
from repro.core.fractal_sort import fractal_rank_scatter as jax_rank_scatter
from repro.core.fractal_sort import fractal_rank_serial as jax_rank_serial
from repro.core.fractal_sort import fractal_sort as jax_sort
from repro.core.fractal_sort import fractal_sort_pairs as jax_sort_pairs
from repro.core.fractal_sort import reconstruct as jax_reconstruct
from repro.kernels import ops as jops
from repro_torch import obs
from repro_torch.core import (CudaBackend, PlanExecutor, TorchBackend,
                              convert_plan, fractal_argsort, fractal_rank,
                              fractal_rank_scatter, fractal_rank_serial,
                              fractal_sort, fractal_sort_pairs,
                              fractal_sort_stats, make_sort_plan)
from repro_torch.kernels import ops

BACKENDS = ["torch", "cuda"]


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
    """All-defaults sorts resolve their plan through the autotune cache:
    an empty one gives the static plans, whatever cache the machine
    holds."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))


def _keys(rng, n, p):
    return rng.integers(0, 1 << p, n, dtype=np.uint64).astype(np.uint32)


def _jax_keys(keys, p):
    return jnp.asarray(keys, jnp.uint32 if p == 32 else jnp.int32)


def _torch_keys(keys, p):
    return torch.from_numpy(keys if p == 32 else keys.astype(np.int32))


def _u32(x) -> np.ndarray:
    """Any int32/uint32 result (torch or jax) as numpy uint32 bits."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64).astype(np.uint32) if a.dtype != np.uint32 else a


def _port_results(keys, p, plan=None, max_bins_log2=None):
    """Every port entry point on every backend: yields (label, keys, perm)
    with perm None for key-only sorts."""
    t = _torch_keys(keys, p)
    rowid = torch.arange(len(keys), dtype=torch.int32)
    for be in BACKENDS:
        kw = dict(plan=plan, max_bins_log2=max_bins_log2, device="cpu",
                  backend=be)
        out = fractal_sort(t, p, **kw)
        assert out.dtype == (torch.uint32 if p == 32 else torch.int32) or len(keys) == 0
        yield f"fractal_sort[{be}]", out, None
        sk, sv = fractal_sort_pairs(t, rowid, p, **kw)
        yield f"fractal_sort_pairs[{be}]", sk, sv
        yield f"fractal_argsort[{be}]", None, fractal_argsort(t, p, **kw)
    if plan is None:
        out = ops.fractal_sort_kernel(t, p, max_bins_log2=max_bins_log2,
                                      device="cpu")
        assert out.dtype == t.dtype
        yield "fractal_sort_kernel", out, None
        sk, sv = ops.fractal_sort_pairs_kernel(t, rowid, p,
                                               max_bins_log2=max_bins_log2,
                                               device="cpu")
        yield "fractal_sort_pairs_kernel", sk, sv


def _assert_port_matches(keys, p, want_keys, want_perm, **kw):
    for label, got_keys, got_perm in _port_results(keys, p, **kw):
        if got_keys is not None:
            np.testing.assert_array_equal(_u32(got_keys), _u32(want_keys),
                                          err_msg=label)
        if got_perm is not None:
            np.testing.assert_array_equal(got_perm.numpy(),
                                          np.asarray(want_perm), err_msg=label)


# --- the (p, n) grid against JnpBackend, and PallasBackend at n=777 -------------


@pytest.mark.parametrize("n", [0, 1, 777, 4096])
@pytest.mark.parametrize("p", [1, 8, 12, 16, 24, 31, 32])
def test_entry_points_match_reference(rng, p, n):
    keys = _keys(rng, n, p)
    jk = _jax_keys(keys, p)
    jplan = jsp.make_sort_plan(n, p)
    want_keys, want_perm = jax_sort_pairs(
        jk, jnp.arange(n, dtype=jnp.int32), p, plan=jplan)
    np.testing.assert_array_equal(
        _u32(jax_sort(jk, p, plan=jplan)), _u32(want_keys))
    if n == 4096:
        np.testing.assert_array_equal(
            np.asarray(jax_argsort(jk, p, plan=jplan)),
            np.asarray(want_perm))
    if n == 777:  # the Pallas kernel path (interpret mode)
        np.testing.assert_array_equal(_u32(jops.fractal_sort_kernel(jk, p)),
                                      _u32(want_keys))
        _, pallas_perm = jops.fractal_sort_pairs_kernel(
            jk, jnp.arange(n, dtype=jnp.int32), p)
        np.testing.assert_array_equal(np.asarray(pallas_perm),
                                      np.asarray(want_perm))
    _assert_port_matches(keys, p, want_keys, want_perm)
    # the port's own plan is the reference's
    assert convert_plan(jplan) == make_sort_plan(n, p)


# --- explicit plans: default, 8-bit, mixed engine hints, paper 16b+16b --------------


def _mixed(plan):
    hints = ["scatter", "onehot", None, "scatter"]
    return jsp.SortPlan(n=plan.n, p=plan.p, passes=tuple(
        jsp.DigitPass(shift=d.shift, bits=d.bits, kind=d.kind,
                      engine=hints[i % len(hints)])
        for i, d in enumerate(plan.passes)))


@pytest.mark.parametrize("plan_kind", ["default", "8bit", "mixed", "16bit"])
@pytest.mark.parametrize("p", [16, 32])
def test_plans_match_jnp_and_pallas_backends(rng, p, plan_kind):
    n = 4096
    keys = _keys(rng, n, p)
    jk = _jax_keys(keys, p)
    jplan = {"default": jsp.make_sort_plan(n, p),
             "8bit": jsp.make_sort_plan(n, p, max_bins_log2=8),
             "mixed": _mixed(jsp.make_sort_plan(n, p, max_bins_log2=8)),
             "16bit": jsp.make_sort_plan(n, p, max_bins_log2=16,
                                         engine="scatter")}[plan_kind]
    rowid = jnp.arange(n, dtype=jnp.int32)
    want_keys, want_perm = jax_sort_pairs(jk, rowid, p, plan=jplan)
    if plan_kind != "16bit":  # the one-hot Pallas tile at 2**16 bins is slow
        pk, pv = JaxExecutor(PallasBackend(interpret=True)).run_pairs(
            jk, rowid, jplan)
        np.testing.assert_array_equal(_u32(pk), _u32(want_keys))
        np.testing.assert_array_equal(np.asarray(pv), np.asarray(want_perm))
    _assert_port_matches(keys, p, want_keys, want_perm,
                         plan=convert_plan(jplan))


# --- adversarial distributions and stability on duplicates --------------------------


def _dist(rng, dist, n, p):
    top = (1 << p) - 1
    if dist == "all_equal":
        k = np.full(n, min(77, top))
    elif dist == "two_value":
        k = rng.choice([7, top], n)
    elif dist == "two_hot":
        k = np.where(rng.random(n) < 0.95, 3, top - 3)
    elif dist == "ramp":
        k = np.arange(n) % (1 << min(p, 16))
    elif dist == "zipf":
        k = np.minimum(rng.zipf(1.2, n), top)
    else:  # reverse-sorted
        k = np.sort(rng.integers(0, top, n, dtype=np.uint64))[::-1]
    return k.astype(np.uint64).astype(np.uint32)


ADVERSARIAL = [(p, dist, 4096) for p in (16, 32)
               for dist in ("all_equal", "two_value", "two_hot", "ramp",
                            "zipf", "reverse")]
# Zipf(1.2) at p = 32 on 2**16 keys: the skewed deployment's keys, where
# nine in ten are ties and the high digits sit in one bin
ADVERSARIAL.append((32, "zipf", 1 << 16))


@pytest.mark.parametrize(
    "p,dist,n", ADVERSARIAL,
    ids=[f"{p}-{d}" + ("" if n == 4096 else f"-{n}") for p, d, n in ADVERSARIAL])
def test_adversarial_distributions_match_reference(rng, p, dist, n):
    keys = _dist(rng, dist, n, p)
    jk = _jax_keys(keys, p)
    jplan = jsp.make_sort_plan(n, p)
    want_keys, want_perm = jax_sort_pairs(
        jk, jnp.arange(n, dtype=jnp.int32), p, plan=jplan)
    # stability on duplicates: the payload is numpy's stable argsort
    np.testing.assert_array_equal(np.asarray(want_perm),
                                  np.argsort(keys, kind="stable"))
    if p == 16:
        perm = JaxExecutor(PallasBackend(interpret=True)).run_argsort(jk, jplan)
        np.testing.assert_array_equal(np.asarray(perm), np.asarray(want_perm))
    _assert_port_matches(keys, p, want_keys, want_perm)


# --- executor modes: tuple payloads, the encode hook, empty input ----------------


def test_run_pairs_tuple_payloads_match_reference(rng):
    n, p = 3000, 24
    keys = _keys(rng, n, p)
    cols = (rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32),
            rng.random(n).astype(np.float32),
            _keys(rng, n, 32))  # uint32: torch moves its bits as int32
    jplan = jsp.make_sort_plan(n, p)
    run = jax.jit(lambda k, c: JaxExecutor(JnpBackend()).run_pairs(
        k, c, jplan))
    wk, wcols = run(_jax_keys(keys, p), tuple(jnp.asarray(c) for c in cols))
    plan = convert_plan(jplan)
    for backend in (TorchBackend(), CudaBackend()):
        gk, payloads = PlanExecutor(backend).run_pairs(
            _torch_keys(keys, p), tuple(torch.from_numpy(c) for c in cols),
            plan)
        assert isinstance(payloads, tuple) and len(payloads) == len(cols)
        np.testing.assert_array_equal(_u32(gk), _u32(wk))
        for got, want, col in zip(payloads, wcols, cols):
            assert got.numpy().dtype == col.dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encode_hook_matches_reference(rng):
    """A raw signed column enters through ``encode`` (the bias flip that
    makes int32 order unsigned order) on every run mode."""
    n = 2048
    raw = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    jplan = jsp.make_sort_plan(n, 32, max_bins_log2=8)
    plan = convert_plan(jplan)

    def jenc(k):
        return k.astype(jnp.uint32) ^ jnp.uint32(1 << 31)

    def tenc(k):
        return k ^ -(1 << 31)

    jex = JaxExecutor(JnpBackend())
    want_sorted = jax.jit(lambda k: jex.run(k, jplan, encode=jenc))(raw)
    want_pairs = jax.jit(lambda k, v: jex.run_pairs(k, v, jplan,
                                                    encode=jenc))(
        raw, jnp.arange(n, dtype=jnp.int32))
    want_perm = jax.jit(lambda k: jex.run_argsort(k, jplan, encode=jenc))(raw)
    np.testing.assert_array_equal(np.asarray(want_perm),
                                  np.argsort(raw, kind="stable"))
    traw = torch.from_numpy(raw)
    for backend in (TorchBackend(), CudaBackend()):
        ex = PlanExecutor(backend)
        np.testing.assert_array_equal(_u32(ex.run(traw, plan, encode=tenc)),
                                      _u32(want_sorted))
        gk, gv = ex.run_pairs(traw, torch.arange(n, dtype=torch.int32), plan,
                              encode=tenc)
        np.testing.assert_array_equal(_u32(gk), _u32(want_pairs[0]))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(want_pairs[1]))
        np.testing.assert_array_equal(
            ex.run_argsort(traw, plan, encode=tenc).numpy(),
            np.asarray(want_perm))


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_and_identity_inputs(backend):
    for dtype, p in [(torch.int32, 16), (torch.uint32, 32), (torch.int32, 8)]:
        out = fractal_sort(torch.zeros((0,), dtype=dtype), p, device="cpu",
                           backend=backend)
        assert out.shape == (0,) and out.dtype == dtype
    perm = fractal_argsort(torch.zeros((0,), dtype=torch.int32), 8,
                           device="cpu", backend=backend)
    assert perm.shape == (0,) and perm.dtype == torch.int32
    keys = torch.tensor([3, 1, 2], dtype=torch.int32)
    assert torch.equal(fractal_sort(keys, 0, device="cpu", backend=backend),
                       keys)  # p=0: the identity plan
    assert torch.equal(fractal_argsort(keys, 0, device="cpu", backend=backend),
                       torch.arange(3, dtype=torch.int32))


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = torch.tensor([3, 1, 2], dtype=torch.int32)
    for call in (lambda: fractal_sort(keys, 8),
                 lambda: fractal_argsort(keys, 8),
                 lambda: fractal_sort_pairs(keys, keys, 8),
                 lambda: ops.fractal_sort_kernel(keys, 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError):
        fractal_sort(keys, 8, device="cpu", backend="bogus")
    # the kernel rank takes a streaming carry-in as part of its bin starts
    carry = torch.arange(16, dtype=torch.int32)
    for got, want in zip(CudaBackend().rank(keys, 16, carry_in=carry),
                         TorchBackend().rank(keys, 16, carry_in=carry,
                                             engine="onehot")):
        assert torch.equal(got, want)


def test_pass_spans_carry_the_traffic_model(rng):
    n, p = 2048, 32
    keys = torch.from_numpy(_keys(rng, n, p))
    plan = make_sort_plan(n, p, max_bins_log2=8)
    with obs.tracing() as session:
        PlanExecutor(CudaBackend()).run(keys, plan)
    tr = session.trace
    tr.assert_well_formed()
    spans = tr.find("executor.pass")
    stats = fractal_sort_stats(n, p, plan=plan)
    assert len(spans) == plan.num_passes
    assert [(s["attrs"]["bytes_read"], s["attrs"]["bytes_written"])
            for s in spans] == [(ps.bytes_read, ps.bytes_written)
                                for ps in stats.pass_stats]


# --- the torch rank engines vs the reference engines ---------------------------------

ENGINES = [("onehot", fractal_rank, jax_rank),
           ("scatter", fractal_rank_scatter, jax_rank_scatter),
           ("serial", fractal_rank_serial, jax_rank_serial)]


@pytest.mark.parametrize("engine", ENGINES, ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("n_bins", [2, 16, 256])
def test_rank_engines_match_reference(rng, engine, n_bins):
    """Chunk and tile boundaries land mid-stream (batch 64, ragged n), with
    and without injected carry_in / bin_start."""
    _, port_fn, jax_fn = engine
    jax_fn = jax.jit(jax_fn, static_argnames=("n_bins", "batch"))
    ci = rng.integers(0, 50, n_bins).astype(np.int32)
    bs = rng.integers(0, 100, n_bins).astype(np.int32)
    for n in (1, 1000, 4097):
        d = rng.integers(0, n_bins, n).astype(np.int32)
        for kw in ({}, {"carry_in": ci, "bin_start": bs}, {"carry_in": ci}):
            want = jax_fn(jnp.asarray(d), n_bins, batch=64,
                          **{k: jnp.asarray(v) for k, v in kw.items()})
            got = port_fn(torch.from_numpy(d), n_bins, batch=64,
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"{n} {list(kw)}")


def test_scatter_engine_wide_bins_both_table_paths(rng):
    """The scatter engine's probe (narrow) and scatter-add (wide) table
    paths, including 2**16 bins, against the reference engine."""
    n = 3000
    for n_bins, batch in [(2048, 4096), (4096, 256), (65536, 8192)]:
        d = rng.integers(0, n_bins, n).astype(np.int32)
        want = jax_rank_scatter(jnp.asarray(d), n_bins, batch=batch)
        got = fractal_rank_scatter(torch.from_numpy(d), n_bins, batch=batch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    empty = fractal_rank(torch.zeros((0,), dtype=torch.int32), 16)
    assert empty[0].shape == (0,)
    assert torch.equal(empty[1], torch.zeros(16, dtype=torch.int32))


@pytest.mark.parametrize("l_n,p", [(4, 12), (8, 16)])
def test_reconstruct_matches_reference(rng, l_n, p):
    from repro_torch.core import reconstruct

    n = 1500
    keys = np.sort(_keys(rng, n, p))
    t = p - l_n
    counts = np.bincount(keys >> t, minlength=1 << l_n).astype(np.int32)
    trailing = (keys & ((1 << t) - 1)).astype(np.int32)
    for lsb in (False, True):
        want = jax_reconstruct(jnp.asarray(counts), jnp.asarray(trailing),
                               l_n, p, lsb_tree_order=lsb)
        got = reconstruct(torch.from_numpy(counts), torch.from_numpy(trailing),
                          l_n, p, lsb_tree_order=lsb)
        np.testing.assert_array_equal(_u32(got), _u32(want))


def test_quickstart_example_runs_on_the_cpu(monkeypatch, capsys):
    """``examples/torch_quickstart.py --device cpu``: the sort, the batched
    stream, the trie queries and the MoE dispatch, each checked in it."""
    import runpy
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_quickstart.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu"])
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    assert "streamed in 4 batches -> identical output" in out
    assert out.rstrip().endswith("quickstart OK")
