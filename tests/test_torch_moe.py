"""The PyTorch port's MoE path against the JAX reference.

The dispatch (``perm``, ``rank``, ``counts``) and the capacity scatter
(``slot``, ``keep``, the expert buffer) must match bit for bit: the
reference runs its Pallas kernels in interpret mode here, and the port's
kernel wrappers their plain versions.  ``moe_apply``, the smoke
qwen3-moe model's logits and aux loss, its decode steps and its decode
against its own prefill match within 2e-4 in fp32, the reference's own
model tolerance; routing ids, and so every drop, match exactly.  Serving
gives the reference loop's tokens, token for token.  Weights come from
the reference's initialisers through ``params_from_jax``; inputs from
numpy seeds.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis: deterministic shim
    from _hypothesis_compat import given, settings, strategies as st

from test_torch_serve import _reference_serve

from repro import train_lib as JTL
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import train_lib as TL
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as S
from repro_torch.models import act_sharding as AS
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

TOL = 2e-4  # fp32 sums in another order through the layer or the stack
ARCH = "qwen3-moe-30b-a3b"


@pytest.fixture(autouse=True)
def _empty_autotune_cache(tmp_path, monkeypatch):
    """All-defaults sorts (the serve scheduler's) resolve their plan
    through the autotune cache: an empty one gives the static plans,
    whatever cache the machine holds."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))


def _cfgs(capacity_factor=None):
    cfg, jcfg = smoke_config(get_config(ARCH)), jsmoke_config(jget_config(ARCH))
    if capacity_factor is not None:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (cfg, jcfg))
    return cfg, jcfg


def _models(capacity_factor=None, seed=11):
    cfg, jcfg = _cfgs(capacity_factor)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return cfg, jcfg, model, jparams


def _layer(cfg, jcfg, seed=7):
    """One MoE layer: the reference's ``moe_init`` weights and the port's
    module holding them."""
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    layer = M.MoE(cfg, torch.float32, "cpu")
    for name, w in jp.items():
        getattr(layer, name).copy_(torch.from_numpy(np.array(w)))
    return layer, jp


def _ids(rng, T, E, dist):
    if dist == "one_expert":
        return np.full(T, rng.integers(E), np.int32)
    return rng.integers(0, E, T).astype(np.int32)


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def test_config_is_a_copy_of_the_reference():
    assert (dataclasses.asdict(get_config(ARCH))
            == dataclasses.asdict(jget_config(ARCH)))
    assert (dataclasses.asdict(smoke_config(get_config(ARCH)))
            == dataclasses.asdict(jsmoke_config(jget_config(ARCH))))


@pytest.mark.parametrize("dist", ["uniform", "one_expert"])
@pytest.mark.parametrize("T,E", [(512, 8), (4096, 128), (1000, 16), (64, 2),
                                 (1, 128)])
def test_dispatch_matches_reference(rng, T, E, dist):
    """perm, rank and counts of the port's dispatch (kernel wrappers) and
    its plain version, against the reference's Pallas dispatch and its
    argsort oracle, bit for bit."""
    ids = _ids(rng, T, E, dist)
    want = jops.moe_dispatch(jnp.asarray(ids), E)
    want_ref = jref.moe_dispatch_ref(jnp.asarray(ids), E)
    for name, got in (("ops.moe_dispatch", ops.moe_dispatch(
            torch.from_numpy(ids), E)), ("ref.moe_dispatch_ref",
                                         ref.moe_dispatch_ref(
                                             torch.from_numpy(ids), E))):
        for part, g, w, wr in zip(("perm", "rank", "counts"), got, want,
                                  want_ref):
            assert g.dtype == torch.int32, (name, part)
            _assert_same(g, w, f"{name} {part} vs Pallas")
            _assert_same(g, wr, f"{name} {part} vs jnp oracle")


@pytest.mark.parametrize("dist", ["uniform", "one_expert"])
@pytest.mark.parametrize("T,E", [(4096, 128), (1000, 16), (1, 128)])
def test_ranks_are_the_dispatchs_rank_half(rng, T, E, dist):
    """``moe_ranks`` (what the layer reads) and its plain twin give the
    dispatch's rank and counts, and the experts' first slots: the
    reference's start (``_dispatch_and_scatter``), bit for bit."""
    from repro_torch.kernels.moe_dispatch import moe_ranks

    ids = _ids(rng, T, E, dist)
    _, want_rank, want_counts = jops.moe_dispatch(jnp.asarray(ids), E)
    want_start = np.concatenate([[0], np.cumsum(np.asarray(want_counts))[:-1]])
    for name, got in (("moe_ranks", moe_ranks(torch.from_numpy(ids), E)),
                      ("ref.moe_ranks_ref", ref.moe_ranks_ref(
                          torch.from_numpy(ids), E))):
        for part, g, w in zip(("rank", "counts", "start"), got,
                              (want_rank, want_counts, want_start)):
            assert g.dtype == torch.int32, (name, part)
            _assert_same(g, w, f"{name} {part}")


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 1500), st.sampled_from([2, 8, 64]))
def test_dispatch_property(T, E):
    """perm groups the assignments by expert, rank inverts perm, counts
    are the bincount; all equal to the reference's oracle."""
    ids = np.random.default_rng(T * 31 + E).integers(0, E, T).astype(np.int32)
    perm, rank, counts = ops.moe_dispatch(torch.from_numpy(ids), E)
    assert np.all(np.diff(ids[perm.numpy()]) >= 0)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ids, minlength=E))
    np.testing.assert_array_equal(perm.numpy()[rank.numpy()], np.arange(T))
    for g, w in zip((perm, rank, counts),
                    jref.moe_dispatch_ref(jnp.asarray(ids), E)):
        _assert_same(g, w, "vs jnp oracle")


@pytest.mark.parametrize("T,E,C,dist", [(256, 8, 40, "uniform"),
                                        (256, 8, 16, "uniform"),
                                        (300, 16, 1, "uniform"),
                                        (128, 8, 20, "one_expert")])
def test_dispatch_and_scatter_matches_reference(rng, T, E, C, dist):
    """slot and keep bit for bit, the (E, C, D) buffer exact, at capacities
    that keep all, some and almost none of the assignments."""
    ids = _ids(rng, T, E, dist)
    xf = rng.standard_normal((T, 24)).astype(np.float32)
    buf, slot, keep, counts = M._dispatch_and_scatter(
        torch.from_numpy(xf), torch.from_numpy(ids), E, C)
    jbuf, jslot, jkeep, jcounts = JM._dispatch_and_scatter(
        jnp.asarray(xf), jnp.asarray(ids), E, C, None)
    assert buf.shape == (E, C, 24)
    assert 0 < int(keep.sum()) and (C >= T or not bool(keep.all()))
    _assert_same(slot, jslot, "slot")
    _assert_same(keep, jkeep, "keep")
    _assert_same(counts, jcounts, "counts")
    _assert_same(buf, jbuf, "buf")


def _jax_ids(jp, jcfg, x):
    """The reference's routing ids, as its moe_apply computes them."""
    xf = jnp.asarray(x).reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, jcfg.moe.top_k)
    return np.asarray(top_e.reshape(-1)), np.asarray(probs)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.1, 8.0])
def test_moe_apply_matches_reference(capacity_factor):
    """out and aux at the smoke widths (E 8, k 2, F 64), at the default
    capacity, at 0.1 (most assignments drop) and at E (none drops); the
    routing ids equal."""
    cfg, jcfg = _cfgs(capacity_factor)
    layer, jp = _layer(cfg, jcfg)
    x = np.random.default_rng(8).standard_normal((2, 16, cfg.d_model)).astype(
        np.float32)
    out, aux = M.moe_apply(layer, cfg, torch.from_numpy(x))
    jout, jaux = JM.moe_apply(jp, jcfg, jnp.asarray(x))
    probs, ids, _ = M.route(layer.router,
                            torch.from_numpy(x).reshape(-1, cfg.d_model),
                            cfg.moe.top_k)
    jids, jprobs = _jax_ids(jp, jcfg, x)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=1e-6, atol=1e-7)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL, atol=TOL)


def test_zero_router_picks_the_lowest_experts():
    """A zero router makes every probability equal: both packages route
    every token to experts 0..k-1, in that order, with equal weights."""
    cfg, jcfg = _cfgs()
    layer, jp = _layer(cfg, jcfg, seed=9)
    layer.router.zero_()
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    k = cfg.moe.top_k
    x = np.random.default_rng(10).standard_normal((2, 8, cfg.d_model)).astype(
        np.float32)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, ids, w = M.route(layer.router, xf, k)
    want = np.tile(np.arange(k, dtype=np.int32), xf.shape[0])
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(_jax_ids(jp, jcfg, x)[0], want)
    np.testing.assert_array_equal(w.numpy(), np.full(want.shape, 1.0 / k,
                                                     np.float32))
    out, aux = M.moe_apply(layer, cfg, torch.from_numpy(x))
    jout, jaux = JM.moe_apply(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL, atol=TOL)


def test_dropped_rows_gather_the_first_row_as_the_reference():
    """A dropped assignment gathers y[0, 0] and weighs it by 0: a NaN
    there poisons the dropped tokens' outputs in both packages alike."""
    cfg, jcfg = _cfgs(0.1)
    layer, jp = _layer(cfg, jcfg, seed=4)
    layer.wd[0, :, 0] = float("nan")  # y[0, :, 0] is NaN, y[0, 0] with it
    jp = dict(jp, wd=jp["wd"].at[0, :, 0].set(jnp.nan))
    x = np.random.default_rng(5).standard_normal((1, 32, cfg.d_model)).astype(
        np.float32)
    out, _ = M.moe_apply(layer, cfg, torch.from_numpy(x))
    jout, _ = JM.moe_apply(jp, jcfg, jnp.asarray(x))
    nan = np.isnan(out.numpy())
    np.testing.assert_array_equal(nan, np.isnan(np.asarray(jout)))
    assert nan.any() and not nan.all()
    np.testing.assert_allclose(out.numpy()[~nan], np.asarray(jout)[~nan],
                               rtol=TOL, atol=TOL)


def test_moe_apply_refuses_a_mesh():
    """Under a mesh the expert-parallel branch needs the sharded layer
    (its weights' specs); an unsharded one is refused (the branch itself:
    tests/test_torch_sharded.py)."""
    cfg, jcfg = _cfgs()
    layer, _ = _layer(cfg, jcfg)
    x = torch.zeros((1, 2, cfg.d_model))
    with AS.meshed(("data",), {"data": 1, "model": 1}):
        with pytest.raises(ValueError, match="sharded model"):
            M.moe_apply(layer, cfg, x)


def test_moe_apply_on_the_plain_dispatch_is_the_same_layer():
    """The argsort dispatch gives the same integers, so the same layer:
    out and aux bit-equal."""
    cfg, jcfg = _cfgs()
    layer, _ = _layer(cfg, jcfg, seed=3)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    out, aux = M.moe_apply(layer, cfg, x)
    out_ref, aux_ref = M.moe_apply(layer, cfg, x,
                                   dispatch=ref.moe_ranks_ref)
    assert torch.equal(out, out_ref) and torch.equal(aux, aux_ref)


@pytest.mark.parametrize("capacity_factor", [None, 0.1])
def test_forward_matches_reference(capacity_factor):
    """Smoke model logits and the aux loss summed over the layers."""
    cfg, jcfg, model, jparams = _models(capacity_factor)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 32))
    logits, aux = T.forward(model, cfg, torch.from_numpy(tokens))
    jlogits, jaux = JT.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    assert logits.shape == (2, 32, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    assert aux.dtype == torch.float32 and aux.item() > 0
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL, atol=TOL)
    prefill = TL.make_prefill_step(cfg)(model,
                                        {"tokens": torch.from_numpy(tokens)})
    assert torch.equal(prefill, logits)


def test_aux_sums_the_layers_in_order():
    """forward_hidden's aux is the layers' aux losses added in fp32, in
    layer order (the reference's scan carry)."""
    cfg, _ = _cfgs()
    cfg = dataclasses.replace(cfg, n_layers=3)
    model = T.Transformer(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 8)))
    _, aux = T.forward_hidden(model, cfg, tokens)
    x = model.embed[tokens]
    want = torch.zeros((), dtype=torch.float32)
    for block in model.blocks:
        x, a = T._block_apply(block, cfg, x, causal=True)
        want = want + a
    assert torch.equal(aux, want) and aux.item() > 0


def test_decode_steps_match_reference():
    cfg, jcfg, model, jparams = _models(seed=12)
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
        nxt, step_cache = decode(model, step_cache, torch.from_numpy(tok), t)
        jnxt, jcache = jdecode(jparams, jcache, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(t))
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_decode_matches_prefill():
    """At no-drop capacity (capacity_factor = E), token-by-token decode
    reproduces the teacher-forced logits (the reference's
    decode-vs-prefill test for qwen3-moe)."""
    cfg, _, model, _ = _models(capacity_factor=8.0, seed=2)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_carries_every_moe_weight(dtype):
    cfg, jcfg = _cfgs()
    jparams = jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(1), jcfg, getattr(jnp, dtype)))
    model = params_from_jax(jparams, cfg, device="cpu")
    assert model.dtype == getattr(torch, dtype)
    ffn = jparams["blocks"]["b0"]["ffn"]
    assert sorted(ffn) == ["router", "wd", "wg", "wi"]
    got = dict(model.named_parameters())
    assert got["blocks.0.ffn.router"].dtype == torch.float32
    assert got["blocks.0.ffn.wi"].dtype == getattr(torch, dtype)
    for name, w in ffn.items():  # bit for bit
        np.testing.assert_array_equal(
            got[f"blocks.0.ffn.{name}"].float().numpy(),
            np.asarray(w[0], np.float32), err_msg=name)
    assert len(got) == len(jax.tree.leaves(jparams))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_config_builds(dtype):
    """qwen3-moe-30b-a3b at full width and depth (on the meta device: no
    memory): every layer an MoE block with the fp32 router, and the
    config's analytic parameter count."""
    cfg = get_config(ARCH)
    model = T.Transformer(cfg, device="meta", dtype=dtype)
    assert len(model.blocks) == 48
    assert all(isinstance(b.ffn, M.MoE) for b in model.blocks)
    ffn = model.blocks[0].ffn
    assert ffn.router.shape == (2048, 128) and ffn.router.dtype == torch.float32
    assert ffn.wi.shape == (128, 2048, 768) and ffn.wd.shape == (128, 768, 2048)
    assert ffn.wi.dtype == dtype
    norms = sum(p.numel() for n, p in model.named_parameters()
                if "norm" in n or "scale" in n)
    assert (sum(p.numel() for p in model.parameters()) - norms
            == cfg.params_count())


def test_serve_matches_reference_loop(capsys):
    cfg, jcfg, model, jparams = _models(seed=0)
    requests = S.make_requests(6, cfg.vocab, np.random.default_rng(0))
    jrequests = [jserve.Request(r.rid, r.prompt, r.max_new)
                 for r in copy.deepcopy(requests)]
    got = S.serve(model, requests, batch_slots=3, max_len=96)
    want = _reference_serve(jparams, jcfg, jrequests, 3, 96)
    assert [r.rid for r in got] == [r.rid for r in want]
    for r, w in zip(got, want):
        assert len(r.out) == r.max_new, r
        assert r.out == w.out, r.rid
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "[serve] 6/6 requests")


def test_serve_main_runs_the_smoke_moe(capsys):
    S.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--dtype",
            "bfloat16", "--num-requests", "4", "--batch-slots", "2"])
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "[serve] 4/4 requests")
