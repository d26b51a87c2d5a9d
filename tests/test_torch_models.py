"""The PyTorch port's llama stack against the JAX reference.

Weights are made by the reference's ``init_params`` and carried over by
``params_from_jax``; tokens come from a numpy seed.  On the smoke config
of llama3.2-1b (multi-head: 4 q and 4 kv heads) and a GQA variant (4 q
heads, 2 kv heads): ``forward`` logits with and without the flash-attention
kernel switch, eight ``decode_step``s, and the port's decode against its
own prefill.  Tolerance 2e-4, as the reference's own model tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train_lib as JTL
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import train_lib as TL
from repro_torch.configs import MoEConfig, get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.moe import MoE

TOL = 2e-4  # fp32 sums in another order through one layer of the stack
VARIANTS = {"mha": {}, "gqa": {"n_heads": 4, "n_kv_heads": 2}}


def _cfgs(variant, **extra):
    over = {**VARIANTS[variant], **extra}
    return (dataclasses.replace(smoke_config(get_config("llama3.2-1b")),
                                **over),
            dataclasses.replace(jsmoke_config(jget_config("llama3.2-1b")),
                                **over))


def _models(variant, seed=11):
    cfg, jcfg = _cfgs(variant)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return cfg, jcfg, model, jparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_carries_every_weight(dtype):
    cfg, jcfg = _cfgs("gqa")
    jparams = jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(1), jcfg, getattr(jnp, dtype)))
    model = params_from_jax(jparams, cfg, device="cpu")
    assert model.dtype == getattr(torch, dtype)
    flat = {"embed": jparams["embed"]["table"],
            "final_norm.scale": jparams["final_norm"]}
    for name, w in jparams["blocks"]["b0"]["mixer"].items():
        flat[f"blocks.0.mixer.{name}"] = w[0]
    for name, w in jparams["blocks"]["b0"]["ffn"].items():
        flat[f"blocks.0.ffn.{name}"] = w[0]
    flat["blocks.0.norm1.scale"] = jparams["blocks"]["b0"]["norm1"][0]
    flat["blocks.0.norm2.scale"] = jparams["blocks"]["b0"]["norm2"][0]
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, w in flat.items():  # bit for bit
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(w, np.float32), err_msg=name)


def test_config_is_a_copy_of_the_reference():
    for name in ("llama3.2-1b",):
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jget_config(name)))
        assert (dataclasses.asdict(smoke_config(get_config(name)))
                == dataclasses.asdict(jsmoke_config(jget_config(name))))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kernel", [False, True])
def test_forward_matches_reference(variant, kernel):
    cfg, jcfg, model, jparams = _models(variant)
    over = dict(use_pallas_attention=kernel, attn_chunk_q=16,
                attn_chunk_kv=16)
    cfg, jcfg = dataclasses.replace(cfg, **over), dataclasses.replace(
        jcfg, **over)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 32))
    ops.reset_launch_counts()
    got = TL.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(tokens)})
    assert ops.launch_counts()["flash_attention_kernel"] == 0  # CPU: plain
    want, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    assert got.shape == (2, 32, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_steps_match_reference(variant):
    cfg, jcfg, model, jparams = _models(variant, seed=12)
    B, S, steps = 2, 16, 8
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, steps))
    cache, step_cache = (T.init_cache(cfg, B, S, torch.float32, device="cpu")
                         for _ in range(2))
    jcache = JT.init_cache(jcfg, B, S, jnp.float32)
    decode, jdecode = TL.make_decode_step(cfg), jax.jit(
        JTL.make_decode_step(jcfg))
    for t in range(steps):
        tok = tokens[:, t:t + 1]
        logits, cache = T.decode_step(model, cfg, cache,
                                      torch.from_numpy(tok), t)
        jlogits, _ = JT.decode_step(jparams, jcfg, jcache,
                                    jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)
        # next tokens through the greedy step factories
        nxt, step_cache = decode(model, step_cache, torch.from_numpy(tok), t)
        jnxt, jcache = jdecode(jparams, jcache, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(t))
        assert nxt.dtype == torch.int32
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_matches_prefill(variant):
    """Token-by-token decode reproduces the teacher-forced logits (the
    port's twin of the reference's decode-vs-prefill test)."""
    cfg, _, model, _ = _models(variant, seed=2)
    B, S = 2, 8
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, (B, S)))
    full, _ = T.forward(model, cfg, tokens)
    cache = T.init_cache(cfg, B, S, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = T.decode_step(model, cfg, cache, tokens[:, t:t + 1], t)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2", "gelu_plain"])
def test_mlp_activations_match_reference(act):
    cfg, jcfg = _cfgs("mha", act=act)
    jp = JL.mlp_init(jax.random.PRNGKey(7), jcfg, jnp.float32)
    mlp = L.MLP(cfg, torch.float32, "cpu")
    for name, w in jp.items():
        getattr(mlp, name).copy_(torch.from_numpy(np.array(w)))
    x = np.random.default_rng(8).standard_normal((2, 5, cfg.d_model)).astype(
        np.float32)
    np.testing.assert_allclose(
        L.mlp_apply(mlp, cfg, torch.from_numpy(x)).numpy(),
        np.asarray(JL.mlp_apply(jp, jcfg, jnp.asarray(x))), rtol=TOL,
        atol=TOL)


def test_moe_blocks_build():
    """An (attn, moe) pattern builds, beside dense blocks: the MoE ffn is
    ported (its parity tests are tests/test_torch_moe.py)."""
    cfg, _ = _cfgs("mha", pattern=(("attn", "moe"), ("attn", "mlp")),
                   n_layers=2, moe=MoEConfig(num_experts=4, top_k=2, d_ff=32))
    model = T.Transformer(cfg, device="cpu")
    assert isinstance(model.blocks[0].ffn, MoE)
    assert isinstance(model.blocks[1].ffn, L.MLP)


def test_init_params_is_seeded_and_scaled():
    cfg, _ = _cfgs("gqa")
    a = T.Transformer(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    b = T.Transformer(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    assert abs(a.embed.std().item() - 0.02) < 0.002
    wq = a.blocks[0].mixer.wq
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.equal(a.final_norm.scale, torch.ones(cfg.d_model))
    assert not any(p.requires_grad for p in a.parameters())
