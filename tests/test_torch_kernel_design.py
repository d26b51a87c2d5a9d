"""The numerics and host-side sizing of the redesigned K5 and K2, on the CPU.

K5's fp32 instance runs attention as 3xTF32 tensor-core products: each
operand splits into big = tf32_rna(x) and small = tf32_rna(x - big), and
small*big + big*small + big*big accumulate in fp32.  The CUDA kernel
cannot run here, so a plain-torch emulation of that arithmetic (rounding
on the fp32 bit pattern, the kernel's 64-key tiles and online softmax) is
held against the port's plain version and the JAX package's Pallas kernel
in interpret mode, at the reference's test shapes and the kernel's stated
fp32 tolerance; plain TF32 is shown to miss it.  K2's look-back path is
sized by pure functions: its tile count, status buffer and the switch to
the table path above 256 bins.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_kernel as jax_flash
from repro_torch.kernels import ref
from repro_torch.kernels.fractal_rank import (LOOKBACK_MAX_BINS, LOOKBACK_TILE,
                                              lookback_status_bytes,
                                              lookback_tiles, uses_lookback)

TOL_F32 = 2e-5  # K5's fp32 tolerance (sums in another order)
SHAPES = [(2, 64, 4, 16, 64), (1, 48, 2, 8, 80), (2, 100, 2, 32, 100)]
KV_TILE = 64  # keys a kv tile of the CUDA kernel


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, on the bit pattern: what ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (mag | (bits & -0x80000000)).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """a @ b from TF32 pieces: small*big + big*small + big*big (3xTF32),
    or big*big alone (terms=1, plain TF32)."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    out = a_big @ b_big
    if terms == 3:
        a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
        out = a_small @ b_big + a_big @ b_small + out
    return out


def emulated_attention(q, k, v, causal: bool, terms: int = 3):
    """The kernel's fp32 arithmetic: 64-key tiles, online softmax with the
    finite -1e30 mask, QK^T and PV as split products."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, S, hd)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, KV_TILE):
        kt, vt = kh[:, :, k0:k0 + KV_TILE], vh[:, :, k0:k0 + KV_TILE]
        s = split_matmul(qh, kt.transpose(-1, -2), terms) * scale
        cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
        if causal:
            s = s.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + split_matmul(p, vt, terms)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3)


def _qkv(seed, shape):
    B, S, H, hd, Skv = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, Skv, H, hd), (B, Skv, H, hd))]


def test_tf32_rounding_emulation():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      1 + 3 * 2 ** -11, 3.0e-7, -1234.5678], dtype=torch.float32)
    got = tf32_rna(x)
    # ties go away from zero; below half an ulp rounds down
    np.testing.assert_array_equal(
        got[:4].numpy(), np.float32([1 + 2 ** -10, 1, -(1 + 2 ** -10),
                                     1 + 2 ** -9]))
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    big = tf32_rna(x)
    rest = x - big
    # big + small keeps about 21 bits of x, against TF32's 11
    err = (big + tf32_rna(rest) - x).abs() / x.abs()
    assert float(err.max()) < 2 ** -20
    assert float(((big - x).abs() / x.abs()).max()) > 2 ** -15


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_attention_within_fp32_tolerance(shape, causal):
    arrs = _qkv(sum(shape) + causal, shape)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    got = emulated_attention(q, k, v, causal).numpy()
    plain = ref.flash_attention_ref(q, k, v, causal=causal).numpy()
    pallas = np.asarray(jax_flash(*(jnp.asarray(a) for a in arrs),
                                  causal=causal, block_q=16, block_kv=32))
    for want in (plain, pallas):
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_tf32_misses_the_fp32_tolerance(shape):
    """Why the kernel pays for three products: one TF32 product a product
    keeps about three digits, far outside 2e-5."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(sum(shape), shape))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    err = (emulated_attention(q, k, v, True, terms=1) - want).abs().max()
    assert float(err) > 10 * TOL_F32


@pytest.mark.parametrize("n,tiles", [(1, 1), (LOOKBACK_TILE - 1, 1),
                                     (LOOKBACK_TILE, 1), (LOOKBACK_TILE + 1, 2),
                                     ((1 << 20) + 37, 129), (1 << 27, 16384)])
def test_lookback_tile_count(n, tiles):
    assert lookback_tiles(n) == tiles


@pytest.mark.parametrize("n,n_bins,nbytes", [
    (1, 1, 16),                          # one word and the counter
    (1 << 27, 16, 8 * (16384 * 16 + 1)),  # 2 MiB at the main path's shape
    (1 << 27, 256, 8 * (16384 * 256 + 1)),
    (LOOKBACK_TILE + 1, 7, 8 * (2 * 7 + 1)),
])
def test_lookback_status_buffer_bytes(n, n_bins, nbytes):
    assert lookback_status_bytes(n, n_bins) == nbytes


@pytest.mark.parametrize("n_bins,lookback", [(1, True), (2, True), (16, True),
                                             (255, True), (256, True),
                                             (257, False), (1 << 16, False)])
def test_lookback_path_switch_at_256_bins(n_bins, lookback):
    assert LOOKBACK_MAX_BINS == 256
    assert uses_lookback(n_bins) is lookback
