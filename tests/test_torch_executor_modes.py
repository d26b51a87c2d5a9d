"""The port's executor modes beyond run/pairs/argsort, against the JAX
reference on the CPU: ``run_segmented_argsort`` (the batched partition
sort), ``run_grouped_trailing``, ``run_streaming`` and the public
``fractal_sort_batched``.

The same numpy inputs, made from a seed, go through the reference's
``PlanExecutor(JnpBackend())`` (or its jitted ``fractal_sort_batched``)
and the port's ``PlanExecutor`` on ``TorchBackend`` and on
``CudaBackend`` (whose kernel wrappers compute their plain versions on
CPU tensors).  Results are compared bit for bit as numpy uint32 views."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import JnpBackend
from repro.core import PlanExecutor as JaxExecutor
from repro.core import sort_plan as jsp
from repro.core.fractal_sort import fractal_sort_batched as jax_batched
from repro_torch.core import (CudaBackend, PlanExecutor, TorchBackend,
                              convert_plan, fractal_sort_batched)

BACKENDS = {"torch": TorchBackend, "cuda": CudaBackend}


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


def _u32(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64).astype(np.uint32) if a.dtype != np.uint32 else a


def _keys(rng, n, p, dist):
    if dist == "uniform":
        k = rng.integers(0, 1 << p, n, dtype=np.uint64)
    elif dist == "all_equal":
        k = np.full(n, (1 << p) // 3, np.uint64)
    else:  # two hot values at both ends of the range
        k = rng.choice(np.asarray([1, (1 << p) - 2], np.uint64), n)
    return k.astype(np.uint32)


@pytest.mark.parametrize("p,seg_log2,n,max_bins_log2,engine", [
    (16, 8, 2048, None, None),      # 4-bit passes, 8 segments
    (32, 10, 4096, None, None),     # the p=32 default plan, 4 segments
    (12, 11, 2048, 8, "scatter"),   # one segment, wide scatter passes
    (7, 4, 512, None, "onehot"),    # many tiny segments
    (0, 6, 256, None, None),        # identity plan
])
@pytest.mark.parametrize("dist", ["uniform", "two_hot"])
def test_segmented_argsort_matches_reference(rng, p, seg_log2, n,
                                             max_bins_log2, engine, dist):
    keys = _keys(rng, n, p, dist) if p else np.zeros(n, np.uint32)
    L = 1 << seg_log2
    ref_plan = jsp.make_sort_plan(L, p, max_bins_log2=max_bins_log2,
                                  engine=engine)
    want = JaxExecutor(JnpBackend()).run_segmented_argsort(
        jnp.asarray(keys), ref_plan, seg_log2)
    for backend in BACKENDS.values():
        got = PlanExecutor(backend()).run_segmented_argsort(
            torch.from_numpy(keys), convert_plan(ref_plan), seg_log2)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every segment sorted in place, stably
    perm = got.numpy().astype(np.int64)
    for b in range(n // L):
        seg = keys[b * L:(b + 1) * L]
        np.testing.assert_array_equal(perm[b * L:(b + 1) * L] - b * L,
                                      np.argsort(seg, kind="stable"))


@pytest.mark.parametrize("depth,t", [(4, 8), (4, 12), (3, 5), (4, 0)])
def test_grouped_trailing_matches_reference(rng, depth, t):
    """Prefix-grouped entries with the trailing bits scrambled inside each
    segment: the port's re-rank within segments equals the reference's,
    and both equal the sorted keys."""
    n, p = 4096, depth + t
    plan = jsp.make_sort_plan(n, p, l_n=depth)
    assert plan.depth == depth and plan.trailing_bits == t
    keys = rng.integers(0, 1 << p, n).astype(np.uint32)
    grouped = np.sort(keys)
    counts = np.bincount(grouped >> t, minlength=1 << depth).astype(np.int32)
    entries = grouped & np.uint32((1 << t) - 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for s, c in zip(starts, counts):
        entries[s:s + c] = rng.permutation(entries[s:s + c])
    want = JaxExecutor(JnpBackend()).run_grouped_trailing(
        jnp.asarray(entries, jnp.uint32), jnp.asarray(counts), plan)
    for backend in BACKENDS.values():
        got = PlanExecutor(backend()).run_grouped_trailing(
            torch.from_numpy(entries.astype(np.int32)),
            torch.from_numpy(counts), convert_plan(plan))
        np.testing.assert_array_equal(_u32(got), _u32(want))
        np.testing.assert_array_equal(_u32(got), np.sort(keys))


@pytest.mark.parametrize("p,num_batches,max_bins_log2,dist", [
    (24, 1, None, "uniform"),
    (24, 3, None, "all_equal"),
    (16, 8, None, "two_hot"),
    (32, 4, 16, "uniform"),   # 16b+16b: too wide for grouped trailing
    (3, 2, None, "uniform"),  # t = 0: reconstruct from counts alone
])
def test_run_streaming_matches_reference(rng, p, num_batches, max_bins_log2,
                                         dist):
    n = 2000
    keys = _keys(rng, n, p, dist)
    ref_plan = jsp.make_sort_plan(n, p, max_bins_log2=max_bins_log2)
    jkeys = jnp.asarray(keys, jnp.uint32 if p == 32 else jnp.int32)
    want, want_h = JaxExecutor(JnpBackend()).run_streaming(
        jkeys, ref_plan, num_batches)
    tkeys = torch.from_numpy(keys if p == 32 else keys.astype(np.int32))
    for backend in BACKENDS.values():
        got, got_h = PlanExecutor(backend()).run_streaming(
            tkeys, convert_plan(ref_plan), num_batches)
        assert got.dtype == tkeys.dtype
        np.testing.assert_array_equal(_u32(got), _u32(want))
        np.testing.assert_array_equal(_u32(got), np.sort(keys))
        assert len(got_h) == len(want_h) == num_batches
        for gh, wh in zip(got_h, want_h):
            for gl, wl in zip(gh.levels, wh.levels):
                np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("engine", [None, "scatter"])
@pytest.mark.parametrize("with_bin_start", [True, False])
def test_kernel_backend_rank_folds_the_carry_into_bin_starts(
        rng, engine, with_bin_start):
    """``CudaBackend.rank`` with a streaming ``carry_in`` gives the
    torch-op engines' ``(rank, counts, carry_out)``: rank = bin start +
    carry + arrival, carry_out = carry_in + counts."""
    n_bins = 16
    digit = torch.from_numpy(rng.integers(0, n_bins, 1000).astype(np.int32))
    carry = torch.from_numpy(rng.integers(0, 50, n_bins).astype(np.int32))
    bin_start = (torch.from_numpy(
        rng.integers(0, 5000, n_bins).astype(np.int32))
        if with_bin_start else None)
    want = TorchBackend().rank(digit, n_bins, carry_in=carry,
                               bin_start=bin_start, engine=engine or "onehot")
    got = CudaBackend().rank(digit, n_bins, carry_in=carry,
                             bin_start=bin_start, engine=engine)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("p,num_batches,max_bins_log2", [
    (16, 2, None), (20, 3, 8)])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fractal_sort_batched_matches_reference(rng, p, num_batches,
                                                max_bins_log2, backend):
    n = 4096
    keys = _keys(rng, n, p, "uniform")
    jkeys = jnp.asarray(keys, jnp.uint32 if p == 32 else jnp.int32)
    want, want_h = jax_batched(jkeys, p, num_batches,
                               max_bins_log2=max_bins_log2)
    tkeys = torch.from_numpy(keys if p == 32 else keys.astype(np.int32))
    got, got_h = fractal_sort_batched(tkeys, p, num_batches,
                                      max_bins_log2=max_bins_log2,
                                      device="cpu", backend=backend)
    np.testing.assert_array_equal(_u32(got), _u32(want))
    np.testing.assert_array_equal(
        got_h[0].leaf_counts.numpy(), np.asarray(want_h[0].leaf_counts))


def test_fractal_sort_batched_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fractal_sort_batched(np.zeros(8, np.int32), 4, 2)


@pytest.mark.parametrize("seg_log2,slices", [(8, 1), (3, 2)])
def test_segment_tables_use_the_backend_histogram_at_every_width(
        rng, seg_log2, slices):
    """The (segment, digit) table of each pass is the backend's histogram
    (K1 on the card) at every width: a table of more than 2^16 cells
    (here 512 segments x 256 bins) is counted 2^16 cells a call.  The
    rank takes the table's column sums as the digit's counts, so the
    pass counts its digit once."""
    seen = []

    class Spy(CudaBackend):
        def histogram(self, digit, n_bins, init=None):
            seen.append(n_bins)
            return super().histogram(digit, n_bins, init=init)

        def rank(self, digit, n_bins, **kw):
            assert kw["counts"] is not None
            return super().rank(digit, n_bins, **kw)

    n = 1 << 12
    keys = _keys(rng, n, 8, "uniform")
    plan = convert_plan(jsp.make_sort_plan(n, 8, l_n=8))  # one 8-bit pass
    got = PlanExecutor(Spy()).run_segmented_argsort(
        torch.from_numpy(keys), plan, seg_log2)
    cells = (n >> seg_log2) * 256
    assert len(seen) == slices and sum(seen) == cells
    assert max(seen) <= 1 << 16
    want = PlanExecutor(TorchBackend()).run_segmented_argsort(
        torch.from_numpy(keys), plan, seg_log2)
    assert torch.equal(got, want)
