"""The PyTorch port's mamba mixer (``repro_torch.models.ssm``) against the
JAX reference (``repro.models.ssm``).

Weights come from the reference's ``mamba_init`` on the smoke config of
jamba-v0.1-52b (d_model 64, d_inner 128, N 16, chunk 16); inputs from a
numpy seed.  S = 37 leaves a ragged last chunk.  fp32 within 2e-4, the
reference's own model tolerance; bf16 within 5e-2 (bf16 rounds at 2^-8
relative, and the two packages round the conv and projections in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import ssm as S
from repro_torch.models.convert import _copy_module, params_from_jax

TOL = 2e-4
BF16_TOL = 5e-2
DTYPES = {"float32": (jnp.float32, torch.float32, TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _cfgs():
    return (smoke_config(get_config("jamba-v0.1-52b")),
            jsmoke_config(jget_config("jamba-v0.1-52b")))


def _mixer(dtype="float32", seed=0):
    cfg, jcfg = _cfgs()
    jdt, tdt, _ = DTYPES[dtype]
    jp = JS.mamba_init(jax.random.PRNGKey(seed), jcfg, jdt)
    mixer = S.Mamba(cfg, tdt, "cpu")
    _copy_module(mixer, jax.tree.map(np.asarray, jp), None, "mamba")
    return cfg, jcfg, mixer, jp


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(x).to(DTYPES[dtype][1]),
            jnp.asarray(x, DTYPES[dtype][0]))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba_apply_matches_reference(dtype):
    cfg, jcfg, mixer, jp = _mixer(dtype)
    assert cfg.mamba.chunk == 16
    x, jx = _x((2, 37, cfg.d_model), 1, dtype)
    got = S.mamba_apply(mixer, cfg, x)
    want = JS.mamba_apply(jp, jcfg, jx)
    assert got.dtype == DTYPES[dtype][1]
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba_decode_matches_reference(dtype):
    cfg, jcfg, mixer, jp = _mixer(dtype, seed=2)
    B, steps = 2, 8
    x, jx = _x((B, steps, cfg.d_model), 3, dtype)
    cache = S.mamba_init_cache(cfg, B, DTYPES[dtype][1], "cpu")
    jcache = JS.mamba_init_cache(jcfg, B, DTYPES[dtype][0])
    assert cache["h"].dtype == torch.float32
    assert cache["conv"].dtype == DTYPES[dtype][1]
    tol = DTYPES[dtype][2]
    for t in range(steps):
        got, cache = S.mamba_decode(mixer, cfg, x[:, t:t + 1], cache)
        want, jcache = JS.mamba_decode(jp, jcfg, jx[:, t:t + 1], jcache)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(cache["h"].numpy(),
                                   np.asarray(jcache["h"]), rtol=tol,
                                   atol=tol)


def test_mamba_decode_matches_its_own_prefill():
    """Token by token through the cache reproduces the chunked scan."""
    cfg, _, mixer, _ = _mixer(seed=4)
    x, _ = _x((2, 37, cfg.d_model), 5)
    full = S.mamba_apply(mixer, cfg, x)
    cache = S.mamba_init_cache(cfg, 2, torch.float32, "cpu")
    outs = []
    for t in range(x.shape[1]):
        out, cache = S.mamba_decode(mixer, cfg, x[:, t:t + 1], cache)
        outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("length", [1, 2, 3, 16, 37, 128])
def test_linear_scan_matches_a_token_loop(length):
    rng = np.random.default_rng(length)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, length, 3, 4))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, length, 3, 4))
                         .astype(np.float32))
    a_acc, b_acc = S._linear_scan(a, b)
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    h, pa = h0, torch.ones_like(h0)
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        pa = pa * a[:, t]
        np.testing.assert_allclose((a_acc[:, t] * h0 + b_acc[:, t]).numpy(),
                                   h.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a_acc[:, t].numpy(), pa.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_params_from_jax_keeps_fp32_leaves_in_a_bf16_tree():
    """a_log, d_skip and the MoE router stay fp32 in a bf16 jamba; every
    other leaf is bf16, and every leaf is carried bit for bit."""
    cfg, jcfg = _cfgs()
    jparams = jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(6), jcfg, jnp.bfloat16))
    model = params_from_jax(jparams, cfg, device="cpu")
    fp32 = sorted(name for name, p in model.named_parameters()
                  if p.dtype == torch.float32)
    mamba_layers = [i for i, (m, _) in enumerate(cfg.pattern) if m == "mamba"]
    moe_layers = [i for i, (_, f) in enumerate(cfg.pattern) if f == "moe"]
    assert fp32 == sorted(
        [f"blocks.{i}.mixer.{w}" for i in mamba_layers
         for w in ("a_log", "d_skip")]
        + [f"blocks.{i}.ffn.router" for i in moe_layers])
    assert all(p.dtype == torch.bfloat16 for name, p in
               model.named_parameters() if name not in fp32)
    for i in mamba_layers:
        jm = jparams["blocks"][f"b{i}"]["mixer"]
        for w in ("a_log", "in_proj", "d_skip", "conv_w"):
            np.testing.assert_array_equal(
                getattr(model.blocks[i].mixer, w).float().numpy(),
                np.asarray(jm[w][0], np.float32))


def test_init_params_matches_the_reference_init():
    """The port's own init: the S4D-real A, d_skip one, zero biases, and
    the reference's scales."""
    cfg, _ = _cfgs()
    m = S.Mamba(cfg, torch.float32, "cpu")
    m.init_params(torch.Generator().manual_seed(0))
    n = cfg.mamba.d_state
    assert torch.equal(m.a_log, torch.log(
        torch.arange(1, n + 1, dtype=torch.float32)).expand(
            m.a_log.shape[0], n))
    assert torch.equal(m.d_skip, torch.ones_like(m.d_skip))
    assert not m.conv_b.any() and not m.dt_bias.any()
    assert abs(m.in_proj.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05


def test_mamba_apply_without_a_mamba_config_raises():
    cfg, _ = _cfgs()
    mixer = S.Mamba(cfg, torch.float32, "cpu")
    with pytest.raises(ValueError, match="cfg.mamba"):
        S.mamba_apply(mixer, dataclasses.replace(cfg, mamba=None),
                      torch.zeros(1, 4, cfg.d_model))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 6])
def test_in_proj_all_to_all_gives_each_rank_its_channels(m):
    """The all-to-all plan of the split ``in_proj``, played out on column
    indices for every rank of a `model` axis of m: each rank receives
    the x and z columns of its own d_in / m channels, in order (odd m:
    blocks that cross the x | z border are reordered before they are
    sent)."""
    d_in = 24
    c, d = 2 * d_in // m, d_in // m
    cols = np.arange(2 * d_in)
    plans = [S._in_proj_plan(d_in, m, r) for r in range(m)]
    sent = []
    for r, (send, _, order) in enumerate(plans):
        block = cols[r * c:(r + 1) * c][order]
        sent.append(np.split(block, np.cumsum(send)[:-1]))
    for r, (_, recv, _) in enumerate(plans):
        assert recv == [len(sent[s][r]) for s in range(m)]
        got = np.concatenate([sent[s][r] for s in range(m)])
        want = np.concatenate([cols[r * d:(r + 1) * d],
                               cols[d_in + r * d:d_in + (r + 1) * d]])
        np.testing.assert_array_equal(got, want)
