"""repro_torch.core.baselines against the reference's baselines, on the CPU.

The reference's cases (``lsd_radix_sort`` and ``bitonic_sort`` against a
sort oracle across adversarial distributions, their properties, the
traffic models), then parity: the same numpy inputs through the
reference's jitted baselines and the port's, bit-exact, and the three
``*_stats`` models equal field by field."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis: deterministic shim
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import baselines as rb
from repro_torch.core import (
    bitonic_sort,
    bitonic_sort_stats,
    comparison_sort_stats,
    lsd_radix_sort,
    radix_sort_stats,
    torch_sort,
)

DISTS = ["uniform", "all_equal", "two_values", "zipf", "sorted", "reversed"]
RADIX_CASES = [(8, 4), (16, 8), (32, 8), (32, 16)]


def _dist(rng, name, n, p):
    hi = (1 << p) - 1
    if name == "uniform":
        k = rng.integers(0, hi + 1, n, dtype=np.uint64)
    elif name == "all_equal":
        k = np.full(n, min(1234, hi), np.uint64)
    elif name == "two_values":
        k = rng.choice([3, hi], n).astype(np.uint64)
    elif name == "zipf":
        k = np.minimum(rng.zipf(1.2, n).astype(np.uint64), hi)
    elif name == "sorted":
        k = np.sort(rng.integers(0, hi + 1, n, dtype=np.uint64))
    else:  # reversed
        k = np.sort(rng.integers(0, hi + 1, n, dtype=np.uint64))[::-1].copy()
    return k.astype(np.uint32)


def _torch_keys(keys, p):
    """p = 32 keys as torch.uint32, narrower ones as int32 (the port's key
    dtypes)."""
    return torch.from_numpy(keys if p == 32 else keys.astype(np.int32))


def _jax_keys(keys, p):
    return jnp.asarray(keys, jnp.uint32 if p == 32 else jnp.int32)


def _u32(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64).astype(np.uint32) if a.dtype != np.uint32 else a


# --- the reference's cases ---------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("p,radix_bits", RADIX_CASES)
def test_lsd_radix_matches_torch_sort(rng, dist, p, radix_bits, backend):
    """Both pass backends ("cuda" on CPU tensors runs the kernels' plain
    versions); the result keeps the input's dtype."""
    keys = _torch_keys(_dist(rng, dist, 2048, p), p)
    got = lsd_radix_sort(keys, p, radix_bits=radix_bits, device="cpu",
                         backend=backend)
    assert got.dtype == keys.dtype
    np.testing.assert_array_equal(_u32(got), np.sort(_u32(keys)),
                                  err_msg=f"{dist}/p{p}")


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 1500), st.sampled_from([8, 12, 16, 24]),
       st.sampled_from([4, 8]))
def test_lsd_radix_property(n, p, radix_bits):
    rng = np.random.default_rng(n * 31 + p + radix_bits)
    keys = rng.integers(0, 1 << p, n).astype(np.int32)
    got = lsd_radix_sort(torch.from_numpy(keys), p, radix_bits=radix_bits,
                         device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("ascending", [True, False])
def test_bitonic_matches_sort(rng, dist, ascending):
    n, p = 1 << 10, 16
    keys = _dist(rng, dist, n, p).astype(np.int32)
    got = bitonic_sort(torch.from_numpy(keys), ascending=ascending,
                       device="cpu")
    want = np.sort(keys)
    np.testing.assert_array_equal(got.numpy(),
                                  want if ascending else want[::-1],
                                  err_msg=f"{dist}/asc={ascending}")


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 11), st.booleans())
def test_bitonic_property_power_of_two(log_n, ascending):
    """Signed int32 keys order as signed values."""
    rng = np.random.default_rng(log_n * 7 + ascending)
    keys = rng.integers(-(1 << 15), 1 << 15, 1 << log_n).astype(np.int32)
    got = bitonic_sort(torch.from_numpy(keys), ascending=ascending,
                       device="cpu").numpy()
    want = np.sort(keys)
    np.testing.assert_array_equal(got, want if ascending else want[::-1])


def test_bitonic_rejects_non_power_of_two(rng):
    with pytest.raises(ValueError, match="power-of-two"):
        bitonic_sort(torch.from_numpy(
            rng.integers(0, 10, 100).astype(np.int32)), device="cpu")


def test_torch_sort_is_the_oracle(rng):
    keys = rng.integers(0, 1 << 16, 500).astype(np.int32)
    np.testing.assert_array_equal(
        torch_sort(torch.from_numpy(keys), device="cpu").numpy(),
        np.sort(keys))
    # p = 32 keys order as unsigned, in their own dtype
    k32 = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
    got = torch_sort(torch.from_numpy(k32), device="cpu")
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(_u32(got), np.sort(k32))


@pytest.mark.parametrize("sort", [
    lambda k: torch_sort(k),
    lambda k: bitonic_sort(k),
    lambda k: lsd_radix_sort(k, 16),
], ids=["torch_sort", "bitonic_sort", "lsd_radix_sort"])
def test_baselines_run_on_the_card_by_default(monkeypatch, sort):
    """Like every entry point, a baseline given host keys and no device
    runs on the card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(1024, dtype=np.int32)[::-1].copy()
    for k in (keys, torch.from_numpy(keys)):
        with pytest.raises(RuntimeError, match="CUDA"):
            sort(k)


def test_baseline_stats_models():
    st8 = radix_sort_stats(1 << 20, 32, radix_bits=8)
    st16 = radix_sort_stats(1 << 20, 32, radix_bits=16)
    assert st8.passes == 4 and st16.passes == 2
    assert st8.bytes_total == 2 * st16.bytes_total
    assert comparison_sort_stats(1 << 20, 32).passes == 20
    b = bitonic_sort_stats(1 << 20, 32)
    assert b.passes == 20 * 21 // 2
    assert b.bytes_total > comparison_sort_stats(1 << 20, 32).bytes_total


# --- parity with the reference -----------------------------------------------


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("p,radix_bits", RADIX_CASES)
def test_lsd_radix_bit_exact_against_reference(rng, dist, p, radix_bits):
    keys = _dist(rng, dist, 2048, p)
    want = rb.lsd_radix_sort(_jax_keys(keys, p), p, radix_bits=radix_bits)
    got = lsd_radix_sort(_torch_keys(keys, p), p, radix_bits=radix_bits,
                         device="cpu")
    np.testing.assert_array_equal(_u32(got), _u32(want))


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("p", [16, 32])
def test_bitonic_bit_exact_against_reference(rng, dist, p):
    """p = 32 keys travel as uint32 on both sides (unsigned order),
    descending and ascending."""
    keys = _dist(rng, dist, 1 << 10, p)
    for ascending in (True, False):
        want = rb.bitonic_sort(_jax_keys(keys, p), ascending=ascending)
        got = bitonic_sort(_torch_keys(keys, p), ascending=ascending,
                           device="cpu")
        np.testing.assert_array_equal(_u32(got), _u32(want))


def test_torch_sort_bit_exact_against_xla_sort(rng):
    for p in (16, 32):
        keys = _dist(rng, "uniform", 3000, p)
        np.testing.assert_array_equal(
            _u32(torch_sort(_torch_keys(keys, p), device="cpu")),
            _u32(rb.xla_sort(_jax_keys(keys, p))))


def test_stats_equal_the_references_field_by_field():
    for n in (1, 2, 1000, 1 << 20, 1 << 27):
        for p in (8, 16, 17, 32):
            for radix_bits in (4, 8, 11, 16):
                for with_index in (False, True):
                    assert dataclasses.asdict(radix_sort_stats(
                        n, p, radix_bits, with_index)) == dataclasses.asdict(
                        rb.radix_sort_stats(n, p, radix_bits, with_index))
            assert dataclasses.asdict(comparison_sort_stats(n, p)) == \
                dataclasses.asdict(rb.comparison_sort_stats(n, p))
            assert dataclasses.asdict(bitonic_sort_stats(n, p)) == \
                dataclasses.asdict(rb.bitonic_sort_stats(n, p))
