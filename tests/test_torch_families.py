"""Every model family of the PyTorch port against the JAX reference:
dense, MoE, hybrid (jamba: mamba + attention + MoE), recurrent (xlstm:
mLSTM + sLSTM), enc-dec (whisper) and vlm (internvl2, patch prefix).

Configs are copies of the reference's; weights come from the reference's
``init_params`` on each ``smoke_config`` through ``params_from_jax``;
tokens and the stub frontend embeddings (the reference's
``tests/test_models.py::_frontend`` shapes: 16 audio frames, ``num_patches``
patches) from a numpy seed.  Tolerance 2e-4, the reference's own.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train_lib as JTL
from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.configs import smoke_config as jsmoke_config
from repro.models import transformer as JT
from repro_torch import train_lib as TL
from repro_torch.configs import get_config, list_configs, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

TOL = 2e-4
BF16_TOL = 5e-2  # bf16 decode against the reference's, as in test_torch_ssm
ARCHS = jlist_configs()
DECODE_ARCHS = ["llama3.2-1b", "jamba-v0.1-52b", "xlstm-125m",
                "qwen3-moe-30b-a3b", "whisper-small"]


def _cfgs(arch, no_drops=False):
    cfg, jcfg = smoke_config(get_config(arch)), jsmoke_config(
        jget_config(arch))
    if no_drops and cfg.moe:  # decode and prefill see another T
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.num_experts)))
            for c in (cfg, jcfg))
    return cfg, jcfg


def _models(arch, seed=0, no_drops=False):
    cfg, jcfg = _cfgs(arch, no_drops)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return cfg, jcfg, model, jparams


def _frontend(cfg, rng, B):
    """Stub frame or patch embeddings, or None."""
    n = {"audio": 16, "patch": cfg.num_patches}.get(cfg.frontend)
    if n is None:
        return None, None
    fe = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(fe), jnp.asarray(fe)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_list_configs_matches_reference():
    assert list_configs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_copy_of_the_reference(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jget_config(arch)))
    assert (dataclasses.asdict(smoke_config(get_config(arch)))
            == dataclasses.asdict(jsmoke_config(jget_config(arch))))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_model_has_the_reference_parameters(arch):
    """At full width and depth, on the meta device (nothing allocated):
    the port's parameters are the reference's leaves, unstacked, shape
    and dtype for shape and dtype."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = T.Transformer(cfg, device="meta", dtype=torch.bfloat16)
    got = collections.Counter((tuple(p.shape), str(p.dtype)[6:])
                              for p in model.parameters())
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    want = collections.Counter()
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [getattr(k, "key", None) for k in path]
        stacked = "blocks" in keys  # a leading repeats axis
        n, shape = ((leaf.shape[0], leaf.shape[1:]) if stacked
                    else (1, leaf.shape))
        want[(tuple(shape), str(leaf.dtype))] += n
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg, model, jparams = _models(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 32))
    fe, jfe = _frontend(cfg, rng, 2)
    with torch.inference_mode():
        got, aux = T.forward(model, cfg, torch.from_numpy(tokens), fe)
    want, jaux = JT.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                            jfe)
    assert got.shape == (2, 32, cfg.vocab)
    _close(got, want)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-small"])
def test_prefill_step_passes_the_frontend(arch):
    """``make_prefill_step`` reads ``batch["frontend"]``: the patch prefix
    is cut off the logits, the frames go through the encoder."""
    cfg, jcfg, model, jparams = _models(arch, seed=3)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (2, 12))
    fe, jfe = _frontend(cfg, rng, 2)
    got = TL.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(tokens),
                                            "frontend": fe})
    want = JTL.make_prefill_step(jcfg)(jparams, {
        "tokens": jnp.asarray(tokens, jnp.int32), "frontend": jfe})
    assert got.shape == (2, 12, cfg.vocab)
    _close(got, want)
    plain = TL.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(
        tokens)})
    assert not torch.allclose(got, plain)  # the frontend was read


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m",
                                  "whisper-small"])
def test_decode_steps_match_reference(arch):
    """Eight decode steps against the reference's, logits and greedy
    tokens; whisper's through ``encode_cross_kv``."""
    cfg, jcfg, model, jparams = _models(arch, seed=5, no_drops=True)
    B, S, steps = 2, 16, 8
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, (B, steps))
    fe, jfe = _frontend(cfg, rng, B)
    cross = jcross = None
    if cfg.encoder_layers:
        cross, enc = T.encode_cross_kv(model, cfg, fe)
        jcross, jenc = JT.encode_cross_kv(jparams, jcfg, jfe)
        _close(enc, jenc)
        for layer, c in enumerate(cross):
            r, i = divmod(layer, len(cfg.pattern))
            for name in ("ck", "cv"):
                _close(c[name], jcross[f"b{i}"][name][r])
    cache = T.init_cache(cfg, B, S, torch.float32, device="cpu")
    jcache = JT.init_cache(jcfg, B, S, jnp.float32)
    decode = TL.make_decode_step(cfg)
    jdecode = jax.jit(JT.decode_step, static_argnums=(1,))
    for t in range(steps):
        tok = tokens[:, t:t + 1]
        logits, _ = T.decode_step(model, cfg, [dict(c) for c in cache],
                                  torch.from_numpy(tok), t, cross_kv=cross)
        jlogits, jcache = jdecode(jparams, jcfg, jcache,
                                  jnp.asarray(tok, jnp.int32),
                                  jnp.asarray(t), cross_kv=jcross)
        _close(logits, jlogits)
        nxt, cache = decode(model, cache, torch.from_numpy(tok), t,
                            cross_kv=cross)
        np.testing.assert_array_equal(
            nxt.numpy(), np.asarray(jnp.argmax(jlogits[:, -1:], -1)))


def test_bf16_whisper_cross_kv_runs_in_the_frames_dtype():
    """A bf16 whisper given fp32 frames: as in the reference, the encoder
    and the cross K/V run in fp32 (JAX promotes the bf16 weights), so they
    agree within the fp32 tolerance, and four bf16 decode steps through
    them within BF16_TOL."""
    cfg, jcfg = _cfgs("whisper-small")
    jparams = JT.init_params(jax.random.PRNGKey(8), jcfg, jnp.bfloat16)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    B, S, steps = 2, 8, 4
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab, (B, steps))
    fe, jfe = _frontend(cfg, rng, B)
    with torch.inference_mode():
        cross, enc = T.encode_cross_kv(model, cfg, fe)
    jcross, jenc = JT.encode_cross_kv(jparams, jcfg, jfe)
    assert enc.dtype == torch.float32 and jenc.dtype == jnp.float32
    _close(enc, jenc)
    for layer, c in enumerate(cross):
        r, i = divmod(layer, len(cfg.pattern))
        for name in ("ck", "cv"):
            assert c[name].dtype == torch.float32
            _close(c[name], jcross[f"b{i}"][name][r])
    cache = T.init_cache(cfg, B, S, torch.bfloat16, device="cpu")
    jcache = JT.init_cache(jcfg, B, S, jnp.bfloat16)
    jdecode = jax.jit(JT.decode_step, static_argnums=(1,))
    for t in range(steps):
        tok = tokens[:, t:t + 1]
        with torch.inference_mode():
            logits, cache = T.decode_step(model, cfg, cache,
                                          torch.from_numpy(tok), t,
                                          cross_kv=cross)
        jlogits, jcache = jdecode(jparams, jcfg, jcache,
                                  jnp.asarray(tok, jnp.int32),
                                  jnp.asarray(t), cross_kv=jcross)
        assert logits.dtype == torch.bfloat16
        np.testing.assert_allclose(
            logits.float().numpy(), np.asarray(jlogits, np.float32),
            rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_prefill(arch):
    """Token-by-token decode reproduces the teacher-forced logits: every
    cache type (KV, conv + ssm state, mLSTM and sLSTM state,
    cross-attention); the port's twin of the reference's
    ``test_decode_matches_prefill``."""
    cfg, _, model, _ = _models(arch, seed=2, no_drops=True)
    B, S = 2, 8
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    fe, _ = _frontend(cfg, rng, B)
    with torch.inference_mode():
        full, _ = T.forward(model, cfg, tokens, fe)
        cross = (T.encode_cross_kv(model, cfg, fe)[0] if cfg.encoder_layers
                 else None)
        cache = T.init_cache(cfg, B, S, torch.float32, device="cpu")
        outs = []
        for t in range(S):
            logits, cache = T.decode_step(model, cfg, cache,
                                          tokens[:, t:t + 1], t,
                                          cross_kv=cross)
            outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_init_cache_holds_each_mixers_state(arch):
    cfg, _ = _cfgs(arch)
    cache = T.init_cache(cfg, 3, 10, torch.bfloat16, device="cpu")
    assert len(cache) == cfg.n_layers
    for (mixer, _), c in zip(cfg.pattern * cfg.repeats, cache):
        if mixer == "attn":
            assert sorted(c) == ["k", "v"] and c["k"].shape[:2] == (3, 10)
            continue
        assert sorted(c) == [mixer]
        fp32 = {"mamba": ["h"], "mlstm": ["m"], "slstm": ["m"]}[mixer]
        for name, t in c[mixer].items():
            assert t.shape[0] == 3 and not t.any()
            assert t.dtype == (torch.float32 if name in fp32
                               else torch.bfloat16), (mixer, name)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m",
                                  "whisper-small"])
def test_init_params_fills_every_family(arch):
    """The port's own seeded init reaches every weight (encoder, cross,
    recurrent mixers): none keeps the NaN it held before, and one seed
    gives one model.  Norm scales are ones from construction."""
    cfg, _ = _cfgs(arch)
    models = []
    for _ in range(2):
        model = T.Transformer(cfg, device="cpu")
        for name, p in model.named_parameters():
            if "norm" not in name:
                p.fill_(float("nan"))
        models.append(model.init_params(torch.Generator().manual_seed(0)))
    for (name, x), (_, y) in zip(models[0].named_parameters(),
                                 models[1].named_parameters()):
        assert bool(torch.isfinite(x).all()), name
        assert torch.equal(x, y), name
