"""K1's one-sweep digit histograms, the executor's per-plan counts hook,
and the host-side sizing of the redesigned K1 and K3, on the CPU.

The CUDA kernels cannot run here; their plain versions (what the wrappers
compute on CPU tensors) are held against the JAX package: the multi-digit
histogram against ``repro.kernels.fractal_histogram.digit_histograms`` in
interpret mode, and ``PlanExecutor(CudaBackend())`` -- which takes every
pass's counts from the hook before its pass loop -- against the
reference's ``JnpBackend`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import JnpBackend
from repro.core import PlanExecutor as JaxExecutor
from repro.core import make_sort_plan as jax_plan
from repro.kernels.fractal_histogram import (
    digit_histograms as jax_digit_histograms)
from repro_torch.core import (CudaBackend, DigitPass, PlanExecutor, SortPlan,
                              TorchBackend, convert_plan, make_sort_plan)
from repro_torch.kernels import ref
from repro_torch.kernels.fractal_histogram import (
    SWEEP_MAX_BINS, digit_histograms, fractal_histogram_digits,
    sweep_eligible, sweep_groups)
from repro_torch.kernels.fractal_rank import (LOOKBACK_MAX_BINS, SCATTER_TILE,
                                              TABLE_CAP, lookback_tiles,
                                              scatter_table_entries)


def _u32(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64).astype(np.uint32) if a.dtype != np.uint32 else a


# --- the plain multi-digit histogram against the reference --------------------


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_digit_histograms_match_reference_with_carried_counts(rng, bits):
    """4-, 8- and 16-bit plans over two ragged chunks, each chunk's counts
    carried onto the next (the streaming accumulation)."""
    n = 600
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    jplan = jax_plan(1 << 27, 32, max_bins_log2=bits)  # the n = 2**27 plans
    assert {dp.bits for dp in jplan.passes} == {bits}
    passes = convert_plan(jplan).passes
    carried_j = carried_t = carried_r = None
    for lo, hi in ((0, 257), (257, n)):
        chunk = keys[lo:hi]
        carried_j = jax_digit_histograms(jnp.asarray(chunk, jnp.uint32),
                                         jplan.passes, block=256,
                                         init=carried_j)
        carried_t = digit_histograms(torch.from_numpy(chunk), passes,
                                     init=carried_t)
        carried_r = ref.digit_histograms_ref(torch.from_numpy(chunk), passes,
                                             init=carried_r)
    assert len(carried_t) == len(carried_j) == len(jplan.passes)
    for dp, got, plain, want in zip(passes, carried_t, carried_r, carried_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(plain.numpy(), np.asarray(want))
        assert got.shape == (dp.n_bins,) and got.dtype == torch.int32
    assert sweep_eligible(passes) == (bits != 16)


def test_sweep_entry_on_cpu_is_the_plain_version(rng):
    keys = torch.from_numpy(rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
                            .astype(np.uint32))
    passes = make_sort_plan(1000, 32).passes
    for got, want in zip(fractal_histogram_digits(keys, passes),
                         ref.digit_histograms_ref(keys, passes)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# --- PlanExecutor(CudaBackend()) on CPU tensors against JnpBackend ------------------


@pytest.mark.parametrize("p", [0, 1, 7, 16, 31, 32])
def test_cuda_backend_run_modes_match_reference(rng, p):
    """run, run_pairs with tuple payloads, run_argsort and encode= through
    the counts hook, bit-exact against the reference's JnpBackend."""
    n = 1000
    keys = rng.integers(0, 1 << p, n, dtype=np.uint64).astype(np.uint32)
    jplan = jax_plan(n, p)
    plan = convert_plan(jplan)
    jex, ex = JaxExecutor(JnpBackend()), PlanExecutor(CudaBackend())
    jk, tk = jnp.asarray(keys, jnp.uint32), torch.from_numpy(keys)

    np.testing.assert_array_equal(_u32(ex.run(tk, plan)),
                                  _u32(jax.jit(lambda k: jex.run(k, jplan))(jk)))

    cols = (rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32),
            rng.random(n).astype(np.float32))
    wk, wcols = jax.jit(lambda k, c: jex.run_pairs(k, c, jplan))(
        jk, tuple(jnp.asarray(c) for c in cols))
    gk, gcols = ex.run_pairs(tk, tuple(torch.from_numpy(c) for c in cols),
                             plan)
    np.testing.assert_array_equal(_u32(gk), _u32(wk))
    assert isinstance(gcols, tuple) and len(gcols) == len(cols)
    for got, want in zip(gcols, wcols):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    want_perm = jax.jit(lambda k: jex.run_argsort(k, jplan))(jk)
    np.testing.assert_array_equal(ex.run_argsort(tk, plan).numpy(),
                                  np.asarray(want_perm))
    np.testing.assert_array_equal(np.asarray(want_perm),
                                  np.argsort(keys, kind="stable"))

    # a raw column through encode=: a flip of the top key bit
    flip = 1 << (p - 1) if p else 0
    want_enc = jax.jit(lambda k: jex.run(
        k, jplan, encode=lambda x: x ^ jnp.uint32(flip)))(jk)
    got_enc = ex.run(tk.view(torch.int32), plan,
                     encode=lambda x: x ^ (flip - (1 << 32) * (p == 32)))
    np.testing.assert_array_equal(_u32(got_enc), _u32(want_enc))


# --- the counts hook is called once per run and feeds every pass ----------------


class _Spy(CudaBackend):
    """CudaBackend recording the hook's calls and the counts rank gets."""

    def __init__(self):
        super().__init__()
        self.hook = []
        self.rank_counts = []

    def plan_counts(self, u, plan):
        out = super().plan_counts(u, plan)
        self.hook.append(out)
        return out

    def rank(self, digit, n_bins, **kw):
        self.rank_counts.append(kw.get("counts"))
        return super().rank(digit, n_bins, **kw)


@pytest.mark.parametrize("mode", ["run", "run_pairs", "run_argsort"])
@pytest.mark.parametrize("plan_kind", ["p32", "16b+16b"])
def test_counts_hook_once_per_run_feeds_each_pass(rng, mode, plan_kind):
    n = 1500
    keys = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                            .astype(np.uint32))
    plan = (make_sort_plan(n, 32) if plan_kind == "p32" else
            SortPlan(n, 32, (DigitPass(0, 16), DigitPass(16, 16, kind="msd"))))
    spy = _Spy()
    ex = PlanExecutor(spy)
    if mode == "run":
        out = ex.run(keys, plan)
        np.testing.assert_array_equal(_u32(out), np.sort(keys.numpy()))
    elif mode == "run_pairs":
        out, vals = ex.run_pairs(keys, torch.arange(n, dtype=torch.int32),
                                 plan)
        np.testing.assert_array_equal(vals.numpy(),
                                      np.argsort(keys.numpy(), kind="stable"))
    else:
        perm = ex.run_argsort(keys, plan)
        np.testing.assert_array_equal(perm.numpy(),
                                      np.argsort(keys.numpy(), kind="stable"))
    assert len(spy.hook) == 1
    assert len(spy.rank_counts) == len(plan.passes)
    if plan_kind == "p32":
        assert sweep_eligible(plan.passes)
        counts = spy.hook[0]
        assert len(counts) == len(plan.passes)
        for got, want, dp in zip(spy.rank_counts, counts, plan.passes):
            assert got is want
            np.testing.assert_array_equal(
                got.numpy(), ref.digit_histograms_ref(keys, (dp,))[0].numpy())
    else:  # wider than the sweep: each pass counts its own digit
        assert spy.hook == [None]
        assert spy.rank_counts == [None] * len(plan.passes)


def test_torch_backend_takes_no_plan_counts(rng):
    keys = torch.from_numpy(rng.integers(0, 1 << 16, 500).astype(np.int32))
    plan = make_sort_plan(500, 16)
    assert TorchBackend().plan_counts(keys, plan) is None
    out = PlanExecutor(TorchBackend()).run(keys, plan)
    np.testing.assert_array_equal(out.numpy(), np.sort(keys.numpy()))


# --- sizing: sweep eligibility and grouping, K3's tiles and table ---------------


def test_sweep_groups_of_the_sort_plans():
    n = 1 << 27
    assert sweep_groups(make_sort_plan(n, 32).passes) == (0, 0, 0, 1, 1, 1,
                                                          2, 2)
    assert sweep_groups(make_sort_plan(n, 16).passes) == (0, 0, 0, 1)
    assert sweep_groups(make_sort_plan(
        n, 32, max_bins_log2=8, engine="scatter").passes) == (0, 1, 2, 3)
    assert sweep_groups(make_sort_plan(n, 32, max_bins_log2=16).passes) is None


@pytest.mark.parametrize("passes,eligible", [
    ((DigitPass(0, 13), DigitPass(13, 13)), True),    # exactly 2**14 bins
    ((DigitPass(0, 13), DigitPass(13, 13), DigitPass(26, 1)), False),
    ((DigitPass(0, 16),), False),
    ((), False),
    (tuple(DigitPass(s, 1) for s in range(32)), True),  # 32 digits
    (tuple(DigitPass(s % 32, 1) for s in range(33)), False),
])
def test_sweep_eligibility_limits(passes, eligible):
    assert sweep_eligible(passes) is eligible
    if eligible:
        assert sum(dp.n_bins for dp in passes) <= SWEEP_MAX_BINS


def test_sweep_grouping_falls_back_and_caps_groups():
    # joint groups would need 2**14 + 2 counters: every digit on its own
    passes = (DigitPass(0, 13), DigitPass(13, 1), DigitPass(24, 1),
              DigitPass(0, 1), DigitPass(11, 1), DigitPass(20, 1))
    assert sweep_groups(passes) == tuple(range(len(passes)))
    # digits 13 bits apart never share a group: 10 groups pass the kernel's 8
    assert sweep_groups((DigitPass(0, 1), DigitPass(13, 1)) * 5) is None
    # one group spans at most 12 bits
    assert sweep_groups((DigitPass(0, 6), DigitPass(6, 6), DigitPass(12, 1))
                        ) == (0, 0, 1)


@pytest.mark.parametrize("n,tiles", [(1, 1), (8192, 1), (8193, 2),
                                     (1 << 27, 1 << 14)])
def test_scatter_tiles(n, tiles):
    assert SCATTER_TILE == 8192
    assert lookback_tiles(n, SCATTER_TILE) == tiles


def test_scatter_table_only_above_256_bins_and_admission():
    n = 1 << 27
    assert LOOKBACK_MAX_BINS == 256
    assert scatter_table_entries(n, 256) == 0  # the main shape: no table
    assert scatter_table_entries(n, 257) == (1 << 14) * 257
    # at 2**16 bins the cap admits n <= 2**25 (1024-key tiles admitted 2**22)
    assert scatter_table_entries(1 << 22, 1 << 16) <= TABLE_CAP
    assert scatter_table_entries(1 << 25, 1 << 16) == TABLE_CAP
    assert scatter_table_entries((1 << 25) + 1, 1 << 16) > TABLE_CAP
