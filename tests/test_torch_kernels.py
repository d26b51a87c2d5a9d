"""repro_torch kernel wrappers vs the JAX Pallas kernels (interpret mode)
and ``repro.kernels.ref``.

On the CPU every wrapper computes its plain PyTorch version, so these
tests hold K1-K4's plain versions bit-exact against the reference
kernels at the shapes of ``tests/test_kernels.py``.  The kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import JnpBackend, PallasBackend
from repro.core import PlanExecutor as JaxExecutor
from repro.core import make_sort_plan as jax_plan
from repro.core.sort_plan import DigitPass as JaxDigitPass
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fractal_histogram import fractal_histogram as jax_histogram
from repro.kernels.fractal_rank import fractal_rank_counts as jax_rank_counts
from repro.kernels.fractal_rank import fractal_rank_digit as jax_rank_digit
from repro.kernels.fractal_rank import fractal_rank_kernel as jax_rank_onehot
from repro.kernels.fractal_rank import (
    fractal_rank_scatter_kernel as jax_rank_scatter)
from repro_torch.core import (CudaBackend, DigitPass, PlanExecutor,
                              TorchBackend, convert_plan)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fractal_histogram import fractal_histogram
from repro_torch.kernels.fractal_rank import (fractal_rank_counts,
                                              fractal_rank_digit,
                                              fractal_rank_kernel,
                                              fractal_rank_scatter_kernel)
from repro_torch.kernels.fractal_reconstruct import (fractal_reconstruct,
                                                     fractal_reconstruct_plan)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want) -> None:
    np.testing.assert_array_equal(_np(got), _np(want))


def _start(counts: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)


# --- K1 histogram --------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 777, 4096, 5000])
@pytest.mark.parametrize("n_bins", [8, 128, 1024])
def test_histogram_sweep(rng, n, n_bins):
    keys = rng.integers(0, n_bins, n).astype(np.int32)
    got = ops.histogram(torch.from_numpy(keys), n_bins)
    _eq(got, jops.histogram(jnp.asarray(keys), n_bins))
    _eq(got, jref.histogram_ref(jnp.asarray(keys), n_bins))


@pytest.mark.parametrize("block", [64, 256, 1024])
def test_histogram_block_invariance_and_padding(rng, block):
    """Out-of-range values (the −1 and n_bins pads of the callers) are
    dropped, and the counts equal the reference's at every block."""
    keys = rng.integers(-1, 65, 3000).astype(np.int32)
    got = fractal_histogram(torch.from_numpy(keys), 64)
    _eq(got, jax_histogram(jnp.asarray(keys), 64, block=block))
    _eq(got, np.bincount(keys[(keys >= 0) & (keys < 64)], minlength=64))


def test_histogram_init_accumulates_across_ragged_chunks(rng):
    n_bins = 64
    keys = rng.integers(0, n_bins, 5000).astype(np.int32)
    carried_t, carried_j = None, None
    for lo in range(0, keys.shape[0], 1237):
        chunk = keys[lo:lo + 1237]
        carried_t = fractal_histogram(torch.from_numpy(chunk), n_bins,
                                      init=carried_t)
        carried_j = jax_histogram(jnp.asarray(chunk), n_bins, block=256,
                                  init=carried_j)
    _eq(carried_t, carried_j)
    _eq(carried_t, np.bincount(keys, minlength=n_bins))


def test_digit_histograms_over_p24_plan(rng):
    n, p = 3000, 24
    keys = rng.integers(0, 1 << p, n, dtype=np.uint64).astype(np.uint32)
    jplan = jax_plan(n, p)
    want = jops.digit_histograms(jnp.asarray(keys, jnp.uint32), jplan.passes)
    got = ops.digit_histograms(torch.from_numpy(keys),
                               convert_plan(jplan).passes)
    assert len(got) == len(want) == jplan.num_passes
    for g, w in zip(got, want):
        _eq(g, w)


# --- K2 / K3 rank ---------------------------------------------------------------


@pytest.mark.parametrize("n,n_bins", [(512, 8), (1000, 64), (4096, 256)])
def test_rank_sweep(rng, n, n_bins):
    keys = rng.integers(0, n_bins, n).astype(np.int32)
    start = _start(np.bincount(keys, minlength=n_bins))
    want = jops.rank(jnp.asarray(keys), jnp.asarray(start), n_bins)
    _eq(want, jref.rank_ref(jnp.asarray(keys), jnp.asarray(start), n_bins))
    tk, ts = torch.from_numpy(keys), torch.from_numpy(start)
    _eq(ops.rank(tk, ts, n_bins), want)
    _eq(fractal_rank_scatter_kernel(tk, ts, n_bins), want)
    _eq(ref.rank_ref(tk, ts, n_bins), want)


@pytest.mark.parametrize("n,n_bins,block", [(512, 8, 64), (1000, 64, 256),
                                            (4096, 256, 1024),
                                            (777, 2048, 128)])
def test_rank_scatter_matches_reference_scatter_kernel(rng, n, n_bins, block):
    keys = rng.integers(0, n_bins, n).astype(np.int32)
    # injected bin starts (the distributed merge's global starts)
    start = rng.integers(0, 1 << 20, n_bins).astype(np.int32)
    want = jax_rank_scatter(jnp.asarray(keys), jnp.asarray(start), n_bins,
                            block=block)
    tk, ts = torch.from_numpy(keys), torch.from_numpy(start)
    _eq(fractal_rank_scatter_kernel(tk, ts, n_bins, block=block), want)
    _eq(fractal_rank_kernel(tk, ts, n_bins, block=block), want)


def test_rank_out_of_range_keys_match_onehot_kernel(rng):
    """Keys outside [0, n_bins) (the −1 pad) get rank 0 and shift no other
    rank — what the reference's one-hot kernel does with them."""
    n_bins = 16
    keys = rng.integers(0, n_bins, 1500).astype(np.int32)
    keys[rng.random(1500) < 0.1] = -1
    start = _start(np.bincount(keys[keys >= 0], minlength=n_bins))
    want = jax_rank_onehot(jnp.asarray(keys), jnp.asarray(start), n_bins,
                           block=256)
    tk, ts = torch.from_numpy(keys), torch.from_numpy(start)
    _eq(fractal_rank_kernel(tk, ts, n_bins), want)
    _eq(fractal_rank_scatter_kernel(tk, ts, n_bins), want)


@pytest.mark.parametrize("engine", [None, "onehot", "scatter"])
@pytest.mark.parametrize("n,n_bins", [(1, 16), (3000, 16), (2048, 256)])
def test_rank_counts_both_engines(rng, engine, n, n_bins):
    digit = rng.integers(0, n_bins, n).astype(np.int32)
    want = jax_rank_counts(jnp.asarray(digit), n_bins, engine=engine)
    got = fractal_rank_counts(torch.from_numpy(digit), n_bins, engine=engine)
    for g, w in zip(got, want):
        _eq(g, w)
    bs = rng.integers(0, 1000, n_bins).astype(np.int32)
    want = jax_rank_counts(jnp.asarray(digit), n_bins, engine=engine,
                           bin_start=jnp.asarray(bs))
    got = fractal_rank_counts(torch.from_numpy(digit), n_bins, engine=engine,
                              bin_start=torch.from_numpy(bs))
    for g, w in zip(got, want):
        _eq(g, w)


def test_rank_digit_driver(rng):
    keys = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    for shift, bits, engine in [(0, 4, None), (20, 8, "scatter"),
                                (28, 4, "onehot")]:
        want = jax_rank_digit(jnp.asarray(keys, jnp.uint32),
                              JaxDigitPass(shift, bits, engine=engine))
        got = fractal_rank_digit(torch.from_numpy(keys),
                                 DigitPass(shift, bits, engine=engine))
        for g, w in zip(got, want):
            _eq(g, w)


def test_kernel_argument_checks():
    keys = torch.zeros(10, dtype=torch.int32)
    start = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        fractal_rank_scatter_kernel(keys, start, 16, block=100)
    with pytest.raises(ValueError):  # composite packing overflow
        fractal_rank_scatter_kernel(keys, torch.zeros(1 << 22, dtype=torch.int32),
                                    1 << 22, block=1024)
    with pytest.raises(ValueError):
        fractal_rank_counts(keys, 16, engine="bogus")
    with pytest.raises(ValueError):
        fractal_reconstruct(start, keys, 16, 32)
    with pytest.raises(ValueError):
        fractal_reconstruct(start, keys, 8, 0)


# --- K4 reconstruct --------------------------------------------------------------


@pytest.mark.parametrize("n,n_bins,t", [(1000, 128, 0), (2048, 64, 4),
                                        (513, 16, 2), (4096, 1 << 16, 16)])
def test_reconstruct_sweep(rng, n, n_bins, t):
    p = n_bins.bit_length() - 1 + t
    keys = np.sort(rng.integers(0, 1 << p, n, dtype=np.uint64)).astype(np.uint32)
    if p == 32:  # top bit set: the int32 arithmetic wraps
        assert (keys >> 31).any()
    counts = np.bincount(keys >> t, minlength=n_bins).astype(np.int32)
    trailing = (keys & ((1 << t) - 1)).astype(np.int32)
    want = jops.reconstruct(jnp.asarray(counts), jnp.asarray(trailing),
                            n_bins, t)
    _eq(want, jref.reconstruct_ref(jnp.asarray(counts),
                                   jnp.asarray(trailing), t))
    got = ops.reconstruct(torch.from_numpy(counts),
                          torch.from_numpy(trailing), n_bins, t)
    _eq(got, want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), keys)


def test_reconstruct_plan_driver(rng):
    n = 3000
    jplan = jax_plan(n, 32)
    last = jplan.passes[-1]
    keys = np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint64)).astype(np.uint32)
    counts = np.bincount(keys >> last.shift, minlength=last.n_bins).astype(np.int32)
    trailing = (keys & ((1 << last.shift) - 1)).astype(np.int32)
    from repro.kernels.fractal_reconstruct import (
        fractal_reconstruct_plan as jax_reconstruct_plan)
    want = jax_reconstruct_plan(jnp.asarray(counts), jnp.asarray(trailing),
                                jplan)
    got = fractal_reconstruct_plan(torch.from_numpy(counts),
                                   torch.from_numpy(trailing),
                                   convert_plan(jplan))
    _eq(got, want)


# --- the executor's histogram hook -------------------------------------------------


def test_backend_histogram_hook_parity(rng):
    """PlanExecutor.digit_counts with pad_to and init on both port backends
    equals the reference's JnpBackend and PallasBackend."""
    keys = rng.integers(0, 1 << 12, 4000, dtype=np.uint64).astype(np.uint32)
    jdp, tdp = JaxDigitPass(shift=4, bits=6), DigitPass(shift=4, bits=6)
    init = rng.integers(0, 100, 64).astype(np.int32)
    wants = [np.asarray(JaxExecutor(b).digit_counts(
        jnp.asarray(keys, jnp.uint32), jdp, init=jnp.asarray(init),
        pad_to=4096)) for b in (JnpBackend(), PallasBackend(block=256))]
    np.testing.assert_array_equal(wants[0], wants[1])
    for backend in (TorchBackend(), CudaBackend(block=256)):
        got = PlanExecutor(backend).digit_counts(
            torch.from_numpy(keys), tdp, init=torch.from_numpy(init),
            pad_to=4096)
        _eq(got, wants[0])
