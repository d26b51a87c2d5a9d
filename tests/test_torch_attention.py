"""Flash attention of the PyTorch port against the JAX reference.

The port's ``ops.flash_attention`` on CPU tensors (the plain version of
kernel K5) is held against the reference's Pallas kernel in interpret
mode and its naive oracle, at the shapes and dtypes of
``tests/test_kernels.py``; the port's blockwise ``models.layers``
attention against the reference's, including chunk invariance.  Inputs
come from a numpy seed and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

# f32: sums in another order; bf16: one rounding of the inputs' precision
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, shape, dtype="float32"):
    B, S, H, hd, Skv = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, Skv, H, hd), (B, Skv, H, hd))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize("shape", [
    (2, 64, 4, 16, 64), (1, 48, 2, 8, 80), (2, 100, 2, 32, 100),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_kernel_matches_pallas_and_oracle(shape, causal):
    (jq, jk, jv), (q, k, v) = _qkv(sum(shape), shape)
    got = ops.flash_attention(q, k, v, causal=causal, block_q=16, block_kv=32)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, block_q=16,
                                  block_kv=32)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["float32"],
                                   atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernel_dtypes(dtype):
    (jq, jk, jv), (q, k, v) = _qkv(9, (1, 32, 2, 16, 32), dtype)
    got = ops.flash_attention(q, k, v, causal=True, block_q=16, block_kv=16)
    assert got.dtype == getattr(torch, dtype)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, block_q=16,
                                  block_kv=16)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=True)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunks", [(16, 16), (48, 16), (16, 48), (13, 7)])
def test_blockwise_attention_matches_reference(causal, chunks):
    """The reference's chunk-invariance cases (tests/test_models.py): every
    chunking agrees with the reference's and with the naive oracle."""
    (jq, jk, jv), (q, k, v) = _qkv(5, (1, 48, 2, 8, 48))
    cq, ck = chunks
    got = L.flash_attention(q, k, v, causal=causal, chunk_q=cq, chunk_kv=ck)
    want = JL.flash_attention(jq, jk, jv, causal=causal, chunk_q=cq,
                              chunk_kv=ck)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _np(got), _np(ref.flash_attention_ref(q, k, v, causal=causal)),
        rtol=2e-5, atol=2e-5)


def test_blockwise_attention_q_offset_and_ragged_kv():
    """Prefill resume (q_offset) over more keys than queries."""
    (jq, jk, jv), (q, k, v) = _qkv(6, (2, 20, 2, 16, 37))
    got = L.flash_attention(q, k, v, causal=True, q_offset=17, chunk_q=8,
                            chunk_kv=16)
    want = JL.flash_attention(jq, jk, jv, causal=True, q_offset=17,
                              chunk_q=8, chunk_kv=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_wrapper_refuses_mixed_devices_on_cpu():
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.to("meta"), q)
