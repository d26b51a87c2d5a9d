"""K2 on the key stream: each pass's digit taken inside the rank kernel.

``fractal_rank_kernel(keys, ..., shift=)`` ranks a key stream on its
digit ``(key >> shift) & (n_bins - 1)``; ``fractal_rank_digit`` (which
``CudaBackend.rank_pass`` calls) hands K2 the key stream where the digit
fits K2's one sweep and the pass runs on K2, and extracts the digit
otherwise.  The CUDA kernel cannot run here: the wrapper's plain version
(what it computes on CPU tensors) is held against the extracted-digit
path, and ``PlanExecutor(CudaBackend())`` against ``TorchBackend`` and
the JAX package's ``JnpBackend`` bit for bit.  The card's half is in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import JnpBackend
from repro.core import PlanExecutor as JaxExecutor
from repro.core import make_sort_plan as jax_plan
from repro_torch import obs
from repro_torch.core import (CudaBackend, DigitPass, PlanExecutor, SortPlan,
                              TorchBackend, convert_plan, exclusive_cumsum,
                              make_sort_plan)
from repro_torch.kernels import ref
from repro_torch.kernels.fractal_rank import (LOOKBACK_MAX_BINS,
                                              fractal_rank_counts,
                                              fractal_rank_digit,
                                              fractal_rank_kernel,
                                              ranks_key_stream)
from repro_torch.obs import metrics

COUNTER = "executor.rank.digit_in_kernel"


def _key_stream(rng, n, dist="uniform"):
    """uint32 keys as int32 storage: uniform, Zipf(1.2) or one key."""
    if dist == "uniform":
        k = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    elif dist == "zipf":
        k = np.minimum(rng.zipf(1.2, n), (1 << 32) - 1).astype(np.uint64)
    else:
        k = np.full(n, rng.integers(0, 1 << 32, dtype=np.uint64))
    return torch.from_numpy(k.astype(np.uint32).view(np.int32))


def _np_rank(digit: np.ndarray, start: np.ndarray, n_bins: int) -> np.ndarray:
    """Stable slots from numpy alone: bin start + earlier equal digits;
    0 for a digit outside ``[0, n_bins)``."""
    out = np.zeros(digit.shape[0], dtype=np.int64)
    for b in range(n_bins):
        at = np.flatnonzero(digit == b)
        out[at] = start[b] + np.arange(at.size)
    return out.astype(np.int32)


# --- the wrapper's plain version on a shift ---------------------------------------


@pytest.mark.parametrize("shift", [0, 4, 13, 28])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_key_stream_rank_equals_the_extracted_digit_rank(rng, shift, bits):
    """Every width of K2's one sweep at four shifts (2 bits at 28 is a
    p = 30 plan's uneven top digit; a field past bit 31 reads zeros
    there), on a ragged stream; the same ranks as the extracted digit's,
    and numpy's."""
    n, n_bins = 3 * 1024 + 7, 1 << bits
    u = _key_stream(rng, n)
    start = torch.from_numpy(rng.integers(0, 1 << 20, n_bins).astype(np.int32))
    digit = (u.numpy().view(np.uint32).astype(np.int64) >> shift) & (n_bins - 1)
    got = fractal_rank_kernel(u, start, n_bins, shift=shift)
    want = fractal_rank_kernel(torch.from_numpy(digit.astype(np.int32)),
                               start, n_bins)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(),
                                  _np_rank(digit, start.numpy(), n_bins))


@pytest.mark.parametrize("dist", ["uniform", "zipf", "one_key"])
@pytest.mark.parametrize("dp,in_kernel", [
    (DigitPass(8, 4), True), (DigitPass(28, 4, kind="msd"), True),
    (DigitPass(8, 8), True), (DigitPass(8, 8, engine="scatter"), False),
    (DigitPass(16, 16), False)])
def test_rank_digit_takes_the_key_stream_or_extracts(rng, dist, dp,
                                                     in_kernel):
    """``fractal_rank_digit`` decides between K2 on the key stream (up to
    256 bins, not on K3) and the extracted digit; either way the ranks and
    counts are the extracted digit's, with the counts given or made."""
    assert ranks_key_stream(dp) == in_kernel
    u = _key_stream(rng, 5000, dist)
    digit = ref.digit_ref(u, dp.shift, dp.n_bins - 1)
    counts = ref.histogram_ref(digit, dp.n_bins)
    want, _, _ = fractal_rank_counts(digit, dp.n_bins, counts=counts)
    rank, c = fractal_rank_digit(u, dp, counts=counts)
    assert torch.equal(rank, want) and c is counts
    rank, c = fractal_rank_digit(u, dp)
    assert torch.equal(rank, want) and torch.equal(c, counts)


@pytest.mark.parametrize("n_bins", [16, 256])
def test_digits_outside_the_bins_rank_zero(rng, n_bins):
    """A digit stream (no shift) ranks its -1 and ``n_bins`` pads 0 and
    gives them no slot, as before the key stream."""
    d = torch.from_numpy(rng.integers(0, n_bins, 4000).astype(np.int32))
    d[::7], d[3::11] = -1, n_bins
    start = torch.from_numpy(rng.integers(0, 1 << 20, n_bins).astype(np.int32))
    got = fractal_rank_kernel(d, start, n_bins)
    assert torch.equal(got, ref.rank_ref(d, start, n_bins))
    assert not got[(d < 0) | (d >= n_bins)].any()


@pytest.mark.parametrize("n_bins", [LOOKBACK_MAX_BINS + 1, 4096, 1 << 16])
def test_shift_is_refused_above_256_bins(rng, n_bins):
    """Above K2's one sweep the two-level path takes extracted digits
    only, on the CPU as on the card."""
    u = _key_stream(rng, 100)
    start = torch.zeros(n_bins, dtype=torch.int32)
    with pytest.raises(ValueError, match="one-sweep"):
        fractal_rank_kernel(u, start, n_bins, shift=4)


@pytest.mark.parametrize("shift", [-1, 32])
def test_shift_outside_the_word_is_refused(rng, shift):
    u = _key_stream(rng, 100)
    with pytest.raises(ValueError, match="shift"):
        fractal_rank_kernel(u, torch.zeros(16, dtype=torch.int32), 16,
                            shift=shift)


# --- CudaBackend's sorts on CPU tensors against TorchBackend and the reference ------


_PLANS = [(32, 4, None), (32, 8, None), (32, 16, None), (30, 4, None),
          (30, 8, None), (16, 4, None), (16, 8, "scatter"), (7, 8, None)]


@pytest.mark.parametrize("p,max_bins_log2,engine", _PLANS)
def test_cuda_backend_sorts_match_torch_backend_and_reference(
        rng, p, max_bins_log2, engine):
    """run and run_argsort through ``CudaBackend.rank_pass`` (K2 on the
    key stream on the 4- and 8-bit plans, extracted digits on the 16-bit
    plan and on K3), bit-exact against ``TorchBackend`` and ``JnpBackend``
    on Zipf-skewed keys."""
    n = 3000
    keys = np.minimum(rng.zipf(1.2, n), (1 << p) - 1).astype(np.uint32)
    keys[: n // 2] = rng.integers(0, 1 << p, n // 2, dtype=np.uint64)
    jplan = jax_plan(n, p, max_bins_log2=max_bins_log2, engine=engine)
    plan = convert_plan(jplan)
    jex = JaxExecutor(JnpBackend())
    tk, jk = torch.from_numpy(keys), jnp.asarray(keys, jnp.uint32)
    want_sorted = np.asarray(jax.jit(lambda k: jex.run(k, jplan))(jk))
    want_perm = np.asarray(jax.jit(lambda k: jex.run_argsort(k, jplan))(jk))
    for backend in (CudaBackend(), TorchBackend()):
        ex = PlanExecutor(backend)
        got = ex.run(tk, plan).view(torch.uint32).numpy()
        np.testing.assert_array_equal(got, want_sorted)
        np.testing.assert_array_equal(ex.run_argsort(tk, plan).numpy(),
                                      want_perm)
    np.testing.assert_array_equal(want_perm, np.argsort(keys, kind="stable"))


# --- the counter and the digit span cover every ranked pass ------------------------


def _wide_plan(n):
    return SortPlan(n, 32, (DigitPass(0, 16), DigitPass(16, 16, kind="msd")))


@pytest.mark.parametrize("mode", ["run", "run_pairs", "run_argsort"])
@pytest.mark.parametrize("plan_kind,in_kernel,extracted", [
    ("4b x 8", 8, 0), ("16b+16b", 0, 2), ("8b on K3", 0, 4)])
def test_digit_in_kernel_counter_and_digit_spans_cover_every_pass(
        rng, mode, plan_kind, in_kernel, extracted):
    """Per sort: K2 takes every 4-bit pass's digit from the key stream
    (counter 8, no ``executor.digit``); the 16b+16b plan, wider than the
    sweep and K2's one sweep, and K3's passes extract theirs (counter 0,
    one ``executor.digit`` a pass)."""
    n = 2000
    if plan_kind == "4b x 8":
        plan = make_sort_plan(n, 32, max_bins_log2=4)
    elif plan_kind == "16b+16b":
        plan = _wide_plan(n)
    else:
        plan = make_sort_plan(n, 32, max_bins_log2=8, engine="scatter")
    assert plan.num_passes == in_kernel + extracted
    u = _key_stream(rng, n)
    ex = PlanExecutor(CudaBackend())
    before = metrics.snapshot()
    with obs.tracing() as session:
        if mode == "run":
            ex.run(u, plan)
        elif mode == "run_pairs":
            ex.run_pairs(u, torch.arange(n, dtype=torch.int32), plan)
        else:
            ex.run_argsort(u, plan)
    tr = session.trace
    counted = metrics.snapshot().get(COUNTER, 0) - before.get(COUNTER, 0)
    assert counted == in_kernel
    assert len(tr.find("executor.digit")) == extracted
    assert len(tr.find("executor.rank")) == plan.num_passes


def test_pass_without_sweep_counts_still_reads_the_key_stream(rng):
    """``rank_pass`` with no counts (a plan wider than the sweep) counts
    the digit from the key stream and ranks it there too: one count, no
    ``executor.digit``, the extracted digit's ranks and counts."""
    u = _key_stream(rng, 1500)
    dp = DigitPass(4, 4)
    backend = CudaBackend()
    before = metrics.snapshot().get(COUNTER, 0)
    with obs.tracing() as session:
        rank, counts, carry = backend.rank_pass(u, dp)
    assert metrics.snapshot().get(COUNTER, 0) == before + 1
    assert not session.trace.find("executor.digit")
    assert carry is counts
    digit = ref.digit_ref(u, dp.shift, dp.n_bins - 1)
    assert torch.equal(counts, ref.histogram_ref(digit, dp.n_bins))
    assert torch.equal(rank, ref.rank_ref(digit, exclusive_cumsum(counts),
                                          dp.n_bins))
    want, _, _ = TorchBackend().rank_pass(u, dp)
    assert torch.equal(rank, want)
