"""The PyTorch port's xLSTM mixers (``repro_torch.models.xlstm``) against
the JAX reference (``repro.models.xlstm``).

Weights come from the reference's ``mlstm_init`` / ``slstm_init`` on the
smoke config of xlstm-125m (d_model 64, 4 heads of 16); inputs from a
numpy seed, scaled by 0.5 as in the reference's
``test_mlstm_chunked_matches_recurrent``.  fp32 within 2e-4, the
reference's own tolerance; one bf16 cell case within 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import xlstm as JX
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import xlstm as X
from repro_torch.models.convert import _copy_module

TOL = 2e-4
BF16_TOL = 5e-2


def _cfgs():
    return (smoke_config(get_config("xlstm-125m")),
            jsmoke_config(jget_config("xlstm-125m")))


def _mixer(kind, seed=0, dtype="float32"):
    cfg, jcfg = _cfgs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    init = JX.mlstm_init if kind == "mlstm" else JX.slstm_init
    jp = init(jax.random.PRNGKey(seed), jcfg, jdt)
    mixer = (X.MLSTM if kind == "mlstm" else X.SLSTM)(cfg, tdt, "cpu")
    _copy_module(mixer, jax.tree.map(np.asarray, jp), None, kind)
    return cfg, jcfg, mixer, jp


def _x(shape, seed, dtype="float32"):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(
        np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x, getattr(jnp, dtype)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_cell_matches_reference(dtype):
    cfg, jcfg, mixer, jp = _mixer("mlstm", seed=1, dtype=dtype)
    B, steps = 2, 6
    x, jx = _x((B, steps, cfg.d_model), 2, dtype)
    state = X.mlstm_init_state(cfg, B, getattr(torch, dtype), "cpu")
    jstate = JX.mlstm_init_state(jcfg, B, getattr(jnp, dtype))
    assert state["m"].dtype == torch.float32
    assert state["C"].dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    for t in range(steps):
        out, state = X.mlstm_cell(mixer, cfg, x[:, t], state)
        jout, jstate = JX.mlstm_cell(jp, jcfg, jx[:, t], jstate)
        _close(out, jout, tol)
        for name in ("C", "n", "m"):
            assert state[name].dtype == getattr(torch, str(
                jstate[name].dtype))
            _close(state[name], jstate[name], tol)


def test_mlstm_apply_recurrent_matches_reference():
    cfg, jcfg, mixer, jp = _mixer("mlstm", seed=3)
    x, jx = _x((2, 37, cfg.d_model), 4)
    _close(X.mlstm_apply_recurrent(mixer, cfg, x),
           JX.mlstm_apply_recurrent(jp, jcfg, jx))


@pytest.mark.parametrize("chunk", [8, 37, 64])
def test_mlstm_apply_chunked_matches_reference(chunk):
    """The port's chunkwise form against the reference's, and against
    the reference's token scan (its own equivalence test's shapes)."""
    cfg, jcfg, mixer, jp = _mixer("mlstm", seed=7)
    x, jx = _x((2, 37, cfg.d_model), 1)
    got = X.mlstm_apply_chunked(mixer, cfg, x, chunk)
    _close(got, JX.mlstm_apply_chunked(jp, jcfg, jx, chunk))
    _close(got, JX.mlstm_apply_recurrent(jp, jcfg, jx))


def test_mlstm_apply_follows_the_chunk_switch():
    import dataclasses

    cfg, jcfg, mixer, jp = _mixer("mlstm", seed=8)
    x, jx = _x((1, 20, cfg.d_model), 9)
    for chunk in (0, 8):
        c, jc = (dataclasses.replace(k, mlstm_chunk=chunk)
                 for k in (cfg, jcfg))
        _close(X.mlstm_apply(mixer, c, x), JX.mlstm_apply(jp, jc, jx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_cell_matches_reference(dtype):
    cfg, jcfg, mixer, jp = _mixer("slstm", seed=10, dtype=dtype)
    B, steps = 2, 6
    x, jx = _x((B, steps, cfg.d_model), 11, dtype)
    state = X.slstm_init_state(cfg, B, getattr(torch, dtype), "cpu")
    jstate = JX.slstm_init_state(jcfg, B, getattr(jnp, dtype))
    tol = TOL if dtype == "float32" else BF16_TOL
    for t in range(steps):
        h, state = X.slstm_cell(mixer, cfg, x[:, t], state)
        jh, jstate = JX.slstm_cell(jp, jcfg, jx[:, t], jstate)
        _close(h, jh, tol)
        for name in ("c", "n", "h", "m"):
            _close(state[name], jstate[name], tol)
        assert state["m"].dtype == torch.float32


@pytest.mark.parametrize("seq", [1, 37])
def test_slstm_apply_matches_reference(seq):
    cfg, jcfg, mixer, jp = _mixer("slstm", seed=12)
    x, jx = _x((2, seq, cfg.d_model), 13)
    _close(X.slstm_apply(mixer, cfg, x), JX.slstm_apply(jp, jcfg, jx))


def test_init_params_is_seeded_and_scaled():
    cfg, _ = _cfgs()
    D = cfg.d_model
    a, b = (X.SLSTM(cfg, torch.float32, "cpu") for _ in range(2))
    for m in (a, b):
        m.init_params(torch.Generator().manual_seed(0))
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    assert abs(a.sz.std().item() * D ** 0.5 - 1.0) < 0.05
    assert abs(a.rz.std().item() * 4 * D ** 0.5 - 1.0) < 0.05
    assert torch.equal(a.f_bias, torch.full((D,), 3.0))
    m = X.MLSTM(cfg, torch.float32, "cpu")
    m.init_params(torch.Generator().manual_seed(1))
    assert m.wi.shape == (D, cfg.n_heads)
    assert torch.equal(m.f_bias, torch.full((cfg.n_heads,), 3.0))
