"""The port's train path (``repro_torch.optim``, ``repro_torch.train_lib``
and remat in ``repro_torch.models.transformer``) against the JAX
reference on the CPU.

Inputs are made from a numpy seed (model weights from the reference's
``init_params`` through ``params_from_jax``) and go through both
packages:

* AdamW, the cosine schedule and global-norm clipping on the same random
  tree: rtol 1e-6 (the reference's fp32 ops in the same order), bf16
  moments 1e-2;
* ``compressed_psum`` bit-exact (the mean and the residual) against the
  reference under ``shard_map``, run eagerly (under ``jit`` XLA computes
  the residual ``(g + err) - deq`` as ``(g - deq) + err``, another
  rounding): at D = 1 in this process, at D = 2 in one subprocess with two
  forced host devices beside a spawned gloo group;
  ``make_compressed_ddp_step`` at D = 2: losses within rtol 1e-5, reduced
  gradients within one quantization step (``scale``) an element;
* one train step's loss and every gradient for each of the ten configs
  (rtol 1e-4, atol 1e-5; jamba 2e-4 / 2e-4, the tolerance its forward
  already needs: its mamba layers carry fp32 summation-order noise of
  about 1e-5 of the largest gradient), and the parameters and moments
  after 1 and 3 AdamW steps;
* remat on and off, K5's refusal under grad, the chunked loss.
"""

import copy
import dataclasses
import functools
import math
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import optim as JO
from repro import train_lib as JTL
from repro.compat import make_mesh, shard_map
from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.configs import smoke_config as jsmoke_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import transformer as JT
from repro_torch import optim as O
from repro_torch import train_lib as TL
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = jlist_configs()
RTOL, ATOL = 1e-4, 1e-5
# jamba's forward agrees with the reference within about 4e-5 (the
# families tests hold it to 2e-4); its gradients likewise
WIDE = {"jamba-v0.1-52b": (2e-4, 2e-4)}
STEP_ARCHS = ["llama3.2-1b", "qwen3-moe-30b-a3b", "xlstm-125m"]
B, S = 2, 16


def _cfgs(arch):
    return smoke_config(get_config(arch)), jsmoke_config(jget_config(arch))


def _model(jcfg, cfg, seed=0):
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                           device="cpu"), jparams


def _batch(cfg, seed=1, b=B, s=S):
    """A token batch and, for an enc-dec or vlm config, stub frontend
    embeddings (16 audio frames, ``num_patches`` patches): numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    n = {"audio": 16, "patch": cfg.num_patches}.get(cfg.frontend)
    if n is not None:
        batch["frontend"] = rng.standard_normal(
            (b, n, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.array(v))
            for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _by_name(tree, cfg):
    """The reference's gradient (or moment) tree by the port's names."""
    return dict(params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                device="cpu").named_parameters())


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _tiny_step(nu, t, oc):
    """Elements whose gradients' root mean square ``sqrt(nu / (1 -
    b2**t))`` after ``t`` AdamW steps lies in (0, 10 eps).  There the step
    divides a gradient by about eps, so fp32 noise of 1e-10 in that
    gradient moves the parameter by a good part of lr, and the difference
    stays in the parameter from then on."""
    rms = np.sqrt(np.asarray(nu, np.float32) / (1 - oc.b2 ** t))
    return (rms > 0) & (rms < 10 * oc.eps)


def _updated_close(got, want, loose, lr_sum, what=""):
    """Updated parameters against the reference's: the ``loose`` elements
    (``_tiny_step`` at any step so far) within the 2 lr a step can differ
    by, every other one at (RTOL, ATOL)."""
    got, want = got.detach().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got[~loose], want[~loose], rtol=RTOL,
                               atol=ATOL, err_msg=what)
    assert np.abs(got - want)[loose].max(initial=0) <= 2 * lr_sum + ATOL, what


# --- the optimizer --------------------------------------------------------------


def _tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((3, 5)).astype(dtype),
            "b": rng.standard_normal((7,)).astype(dtype),
            "c": (rng.standard_normal((2, 2, 4)) * 30).astype(dtype)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype):
    """Three steps on the same random tree and gradients (the last one
    past the clip), parameters, moments, lr and norm."""
    rng = np.random.default_rng(0)
    oc = O.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                           moment_dtype=moment_dtype)
    joc = JO.OptimizerConfig(**dataclasses.asdict(oc))
    p0 = _tree(rng)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, jstate = O.init_opt_state(params, oc), JO.init_opt_state(jparams,
                                                                    joc)
    assert state["mu"]["a"].dtype == getattr(torch, moment_dtype)
    mtol = 1e-6 if moment_dtype == "float32" else 1e-2
    for scale in (0.1, 0.3, 5.0):
        g = _tree(rng)
        g = {k: v * scale for k, v in g.items()}
        state, m = O.adamw_update(params, {k: torch.from_numpy(v)
                                           for k, v in g.items()}, state, oc)
        jparams, jstate, jm = JO.adamw_update(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jstate, joc)
        assert int(state["step"]) == int(jstate["step"])
        for name in ("lr", "grad_norm"):
            _close(m[name], jm[name], 1e-6, 0, name)
        for k in p0:
            _close(params[k], jparams[k], 1e-6, 1e-7, k)
            for mom in ("mu", "nu"):
                assert state[mom][k].dtype == getattr(torch, moment_dtype)
                _close(state[mom][k], jstate[mom][k].astype(jnp.float32),
                       mtol, 1e-12, f"{mom} {k}")


def test_adamw_updates_bf16_parameters_like_the_reference():
    rng = np.random.default_rng(1)
    oc = O.OptimizerConfig(lr=1e-2, warmup_steps=0, moment_dtype="bfloat16")
    joc = JO.OptimizerConfig(**dataclasses.asdict(oc))
    p0 = _tree(rng)
    params = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    g = _tree(rng)
    state, _ = O.adamw_update(
        params, {k: torch.from_numpy(v).to(torch.bfloat16)
                 for k, v in g.items()}, O.init_opt_state(params, oc), oc)
    jparams, _, _ = JO.adamw_update(
        jparams, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
        JO.init_opt_state(jparams, joc), joc)
    for k in p0:
        assert params[k].dtype == torch.bfloat16
        _close(params[k], jparams[k].astype(jnp.float32), 1e-2, 1e-2, k)


def test_adamw_optimizes_quadratic():
    oc = O.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=100,
                           weight_decay=0.0, grad_clip=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = O.init_opt_state(params, oc)
    for _ in range(60):
        state, _ = O.adamw_update(params, {"w": 2 * params["w"]}, state, oc)
    assert float(params["w"].abs().max()) < 0.5


def test_cosine_lr_matches_reference():
    oc = O.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    joc = JO.OptimizerConfig(**dataclasses.asdict(oc))
    steps = np.arange(0, 121, dtype=np.int32)
    got = O.cosine_lr(torch.from_numpy(steps), oc)
    assert got.dtype == torch.float32
    _close(got, JO.cosine_lr(jnp.asarray(steps), joc), 1e-6, 1e-7)
    assert float(O.cosine_lr(0, oc)) == 0.0
    assert float(O.cosine_lr(10, oc)) == pytest.approx(1.0)
    assert float(O.cosine_lr(100, oc)) == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(2))
    got, norm = O.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    want, jnorm = JO.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    _close(norm, jnorm, 1e-6, 0)
    for k in g:
        _close(got[k], want[k], 1e-6, 0, k)


# --- int8-compressed all-reduce --------------------------------------------------


def _psum_inputs(D):
    """Per-rank gradients and residuals (D, n) and a scale-edge case."""
    rng = np.random.default_rng(D)
    g = (rng.standard_normal((D, 4099)) * rng.uniform(0.1, 3.0, (D, 1))
         ).astype(np.float32)
    err = (rng.standard_normal((D, 4099)) * 1e-3).astype(np.float32)
    g[:, :8] = [[0.0, 127.0, -127.0, 63.5, -63.5, 0.5, -0.5, 1.5]] * D
    return g, err


def _jax_psum(mesh, g, err):
    from jax.sharding import PartitionSpec as P

    def local(g, e):
        mean, new = JO.compressed_psum(g[0], "data", e[0])
        return mean[None], new[None]

    mean, new = shard_map(
        local, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False)(
        jnp.asarray(g), jnp.asarray(err))
    return np.asarray(mean), np.asarray(new)


@pytest.fixture
def gloo_one_rank(tmp_path):
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "rendezvous"), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_compressed_psum_one_rank_is_bit_exact(gloo_one_rank):
    g, err = _psum_inputs(1)
    want_mean, want_err = _jax_psum(make_mesh((1,), ("data",)), g, err)
    for e in (torch.from_numpy(err[0]), None):
        mean, new = O.compressed_psum(torch.from_numpy(g[0]), None, e)
        assert mean.dtype == new.dtype == torch.float32
        if e is None:  # no residual carried in: the payload alone
            scale = torch.clamp(torch.tensor(np.abs(g[0]).max()),
                                min=1e-12) / 127.0
            q, deq = O.quantize_int8(torch.from_numpy(g[0]), scale)
            assert q.dtype == torch.int8 and torch.equal(mean, deq)
            continue
        np.testing.assert_array_equal(mean.numpy(), want_mean[0])
        np.testing.assert_array_equal(new.numpy(), want_err[0])


def test_quantize_int8_matches_reference():
    g, _ = _psum_inputs(3)
    scale = np.float32(np.abs(g).max() / 127.0)
    q, deq = O.quantize_int8(torch.from_numpy(g), torch.tensor(scale))
    jq, jdeq = JO.quantize_int8(jnp.asarray(g), jnp.asarray(scale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))


# the reference at D = 2 in a subprocess with two forced host devices:
# compressed_psum on the shared inputs, then the compressed DDP step of
# smoke llama3.2-1b and, by the same shard_map, its reduced gradients
_REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    out_dir = sys.argv[1]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import optim as O, train_lib as TL
    from repro.compat import make_mesh, shard_map
    from repro.configs import get_config, smoke_config
    from repro.models import transformer as T
    assert len(jax.devices()) == 2
    mesh = make_mesh((2,), ("data",))
    inp = dict(np.load(os.path.join(out_dir, "in.npz")))

    def local(g, e):
        mean, new = O.compressed_psum(g[0], "data", e[0])
        return mean[None], new[None]

    mean, new = shard_map(
        local, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False)(
        jnp.asarray(inp["g"]), jnp.asarray(inp["err"]))
    out = {"psum_mean": np.asarray(mean), "psum_err": np.asarray(new)}

    cfg = smoke_config(get_config("llama3.2-1b"))
    oc = O.OptimizerConfig()
    params = T.init_params(jax.random.PRNGKey(0), cfg)
    tok = inp["tokens"]
    batch = {"tokens": jnp.asarray(tok[:, :-1]),
             "labels": jnp.asarray(tok[:, 1:])}
    err = TL.init_error_feedback(params, mesh)

    def reduce_grads(params, err, batch):
        _, grads = jax.value_and_grad(TL.loss_fn, has_aux=True)(
            params, cfg, batch)
        return jax.tree.map(
            lambda g, e: O.compressed_psum(g, "data", e[0])[0], grads, err)

    reduced = jax.jit(shard_map(
        reduce_grads, mesh=mesh, in_specs=(P(), P("data"), P("data")),
        out_specs=P(), check_vma=False))(params, err, batch)
    step = TL.make_compressed_ddp_step(cfg, oc, mesh)
    new_params, _, _, metrics = step(params, O.init_opt_state(params, oc),
                                     err, batch)
    out["loss"] = np.asarray(metrics["loss"])
    out["lr"] = np.asarray(metrics["lr"])
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
    with open(os.path.join(out_dir, "ref_trees.pkl"), "wb") as f:
        pickle.dump({"reduced": jax.tree.map(np.asarray, reduced),
                     "params": jax.tree.map(np.asarray, new_params)}, f)
""")


def _ddp_worker(rank: int, D: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "store"),
        rank=rank, world_size=D)
    try:
        inp = dict(np.load(os.path.join(out_dir, "in.npz")))
        out = {}
        mean, new = O.compressed_psum(torch.from_numpy(inp["g"][rank]), None,
                                      torch.from_numpy(inp["err"][rank]))
        out["psum_mean"], out["psum_err"] = mean.numpy(), new.numpy()
        cfg = smoke_config(get_config("llama3.2-1b"))
        with open(os.path.join(out_dir, "params.pkl"), "rb") as f:
            model = params_from_jax(pickle.load(f), cfg, device="cpu")
        rows = inp["tokens"].shape[0] // D
        tok = torch.from_numpy(inp["tokens"][rank * rows:(rank + 1) * rows])
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        oc = O.OptimizerConfig()
        err = TL.init_error_feedback(model)
        _, grads = TL.value_and_grad(model, cfg, batch)
        for k, g in grads.items():
            r, _ = O.compressed_psum(g, None, err[k])
            out[f"reduced/{k}"] = r.numpy()
        step = TL.make_compressed_ddp_step(cfg, oc)
        _, err_new, metrics = step(model, O.init_opt_state(
            model.named_parameters(), oc), err, batch)
        out["loss"] = metrics["loss"].numpy()
        for k, p in model.named_parameters():
            out[f"params/{k}"] = p.detach().numpy()
            out[f"err/{k}"] = err_new[k].numpy()
        np.savez(os.path.join(out_dir, f"port{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    """(inputs, the reference's outputs and trees, each rank's port
    outputs) at D = 2: the reference's subprocess runs while the port's
    gloo group runs."""
    D = 2
    out_dir = str(tmp_path_factory.mktemp("compressed_ddp"))
    g, err = _psum_inputs(D)
    tokens = np.random.default_rng(5).integers(0, 256, (4, 17)).astype(
        np.int32)
    np.savez(os.path.join(out_dir, "in.npz"), g=g, err=err, tokens=tokens)
    jcfg = jsmoke_config(jget_config("llama3.2-1b"))
    with open(os.path.join(out_dir, "params.pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, JT.init_params(
            jax.random.PRNGKey(0), jcfg)), f)
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    # JAX_PLATFORMS=cpu: the image ships libtpu; without the pin jax probes
    # for a TPU and hangs the child
    env.update(PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, out_dir],
                            cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_ddp_worker, args=(D, out_dir), nprocs=D, join=True)
    finally:
        _, log = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-4000:]
    with open(os.path.join(out_dir, "ref_trees.pkl"), "rb") as f:
        trees = pickle.load(f)
    return ({"g": g, "err": err}, dict(np.load(os.path.join(out_dir,
                                                            "ref.npz"))),
            trees, [dict(np.load(os.path.join(out_dir, f"port{r}.npz")))
                    for r in range(D)])


def test_compressed_psum_two_ranks_is_bit_exact(ddp_runs):
    _, ref, _, port = ddp_runs
    for rank, out in enumerate(port):
        np.testing.assert_array_equal(out["psum_mean"], ref["psum_mean"][rank])
        np.testing.assert_array_equal(out["psum_err"], ref["psum_err"][rank])
    np.testing.assert_array_equal(port[0]["psum_mean"], port[1]["psum_mean"])


def test_compressed_ddp_step_matches_reference(ddp_runs):
    """Losses within rtol 1e-5; reduced gradients within one quantization
    step an element; the updated parameters equal on every rank and within
    the two Adam steps of lr that a flipped int8 value can move them."""
    _, ref, trees, port = ddp_runs
    cfg = smoke_config(get_config("llama3.2-1b"))
    reduced = _by_name(trees["reduced"], cfg)
    params = _by_name(trees["params"], cfg)
    for out in port:
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
    for name, want in reduced.items():
        got = port[0][f"reduced/{name}"]
        np.testing.assert_array_equal(got, port[1][f"reduced/{name}"])
        scale = np.abs(want.detach().numpy()).max() / 127.0
        assert np.abs(got - want.detach().numpy()).max() <= scale * 1.001, name
        np.testing.assert_array_equal(port[0][f"params/{name}"],
                                      port[1][f"params/{name}"])
        np.testing.assert_allclose(port[0][f"params/{name}"],
                                   params[name].detach().numpy(), rtol=0,
                                   atol=2 * float(ref["lr"]) + 1e-6,
                                   err_msg=name)
        assert not np.array_equal(port[0][f"err/{name}"],
                                  port[1][f"err/{name}"])  # per rank


def test_compressed_ddp_step_refuses_k5():
    cfg = dataclasses.replace(smoke_config(get_config("llama3.2-1b")),
                              use_pallas_attention=True)
    with pytest.raises(ValueError, match="use_pallas_attention"):
        TL.make_compressed_ddp_step(cfg, O.OptimizerConfig())


# --- the train step against the reference ---------------------------------------


@functools.cache
def _ref_value_and_grad(arch):
    jcfg = jsmoke_config(jget_config(arch))
    return jax.jit(jax.value_and_grad(
        lambda p, b: JTL.loss_fn(p, jcfg, b), has_aux=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg, jcfg = _cfgs(arch)
    model, jparams = _model(jcfg, cfg)
    batch = _batch(cfg)
    (total, (loss, aux)), grads = TL.value_and_grad(model, cfg,
                                                    _torch(batch))
    (jtotal, (jloss, jaux)), jgrads = _ref_value_and_grad(arch)(
        jparams, _jax(batch))
    rtol, atol = WIDE.get(arch, (RTOL, ATOL))
    for got, want, what in ((total, jtotal, "total"), (loss, jloss, "loss"),
                            (aux, jaux, "aux")):
        _close(got, want, rtol, atol, what)
    want = _by_name(jgrads, cfg)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        assert g.dtype == want[name].dtype
        _close(g, want[name].detach(), rtol, atol, name)
    assert all(p.requires_grad for p in model.parameters())
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_adamw_steps_match_reference(arch):
    """The parameters and both moments after 1 and 3 train steps on the
    same synthetic batches.  No warmup, so the first step moves each
    parameter by about lr = 3e-4, far above atol; the few elements whose
    gradient is within 10 eps of 0 (``_tiny_step``) are held as
    ``_updated_close`` says, and must stay under 1 % of all."""
    cfg, jcfg = _cfgs(arch)
    model, jparams = _model(jcfg, cfg, seed=2)
    oc = O.OptimizerConfig(warmup_steps=0)
    joc = JO.OptimizerConfig(warmup_steps=0)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = TL.make_train_step(cfg, oc)
    state = O.init_opt_state(model.named_parameters(), oc)
    jstate = JO.init_opt_state(jparams, joc)
    src = JSyntheticLM(JDataConfig(cfg.vocab, S, B, seed=4))
    n_elements = sum(p.numel() for p in model.parameters())
    loose = {k: np.zeros(p.shape, bool) for k, p in before.items()}
    lr_sum = 0.0
    for s in range(3):
        b = {k: np.asarray(v) for k, v in src.batch(s).items()}
        state, m = step(model, state, _torch(b))
        # the reference's train_step: its value_and_grad, then AdamW (the
        # gradient compiled once for this arch, shared with the test above)
        (jtotal, (jloss, jaux)), jgrads = _ref_value_and_grad(arch)(
            jparams, _jax(b))
        jparams, jstate, jom = JO.adamw_update(jparams, jgrads, jstate, joc)
        jm = {"loss": jloss, "aux_loss": jaux, "total_loss": jtotal, **jom}
        for name in ("loss", "aux_loss", "total_loss", "lr", "grad_norm"):
            _close(m[name], jm[name], what=name)
        lr_sum += float(jm["lr"])
        mu, nu = _by_name(jstate["mu"], cfg), _by_name(jstate["nu"], cfg)
        for name in loose:
            loose[name] |= _tiny_step(nu[name].detach(), s + 1, oc)
        if s == 0:  # the check below is not met by parameters left still
            for name, p in model.named_parameters():
                assert (p - before[name]).abs().max() > float(m["lr"]) / 2, \
                    name
        if s in (0, 2):
            assert int(state["step"]) == s + 1
            want = _by_name(jparams, cfg)
            for name, p in model.named_parameters():
                _updated_close(p, want[name].detach(), loose[name], lr_sum,
                               f"step {s} {name}")
                # mu (about (1 - b1) g) at the gradients' tolerance
                _close(state["mu"][name], mu[name].detach(), RTOL,
                       ATOL * (1 - oc.b1), what=f"step {s} mu {name}")
                # nu (about (1 - b2) g**2) enters the update as its root:
                # sqrt(nu) at the gradients' tolerance times sqrt(1 - b2)
                _close(state["nu"][name].sqrt(), nu[name].detach().sqrt(),
                       RTOL, ATOL * math.sqrt(1 - oc.b2),
                       what=f"step {s} sqrt(nu) {name}")
            n_loose = sum(int(v.sum()) for v in loose.values())
            assert n_loose <= n_elements // 100, (n_loose, n_elements)


def test_train_step_lowers_the_loss():
    cfg, jcfg = _cfgs("llama3.2-1b")
    model, _ = _model(jcfg, cfg)
    oc = O.OptimizerConfig(lr=3e-3, warmup_steps=0, total_steps=30)
    step = TL.make_train_step(cfg, oc)
    state = O.init_opt_state(model.named_parameters(), oc)
    batch = _torch(_batch(cfg, seed=6))
    losses = []
    for _ in range(15):
        state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


# --- remat, K5, the chunked loss ------------------------------------------------


@pytest.mark.parametrize("arch,policy", [
    ("llama3.2-1b", "nothing"), ("qwen3-moe-30b-a3b", "nothing"),
    ("jamba-v0.1-52b", "dots"), ("whisper-small", "nothing")])
def test_remat_changes_neither_loss_nor_gradients(arch, policy, monkeypatch):
    """Each period (and each encoder layer) runs under checkpoint with
    remat on, none with it off; "dots" remats as "nothing"."""
    cfg, jcfg = _cfgs(arch)
    model, _ = _model(jcfg, cfg)
    batch = _torch(_batch(cfg, seed=3))
    calls = []
    real = T.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    results = []
    for remat in (True, False):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        results.append(TL.value_and_grad(model, c, batch))
        periods = cfg.repeats + cfg.encoder_layers
        assert len(calls) == (periods if remat else 0)
    (on, on_grads), (off, off_grads) = results
    for a, b in zip(jax.tree.leaves(on), jax.tree.leaves(off)):
        _close(a, b.numpy(), 1e-6, 0)
    for name in on_grads:
        _close(on_grads[name], off_grads[name].numpy(), 1e-6, 0, name)


def test_forward_under_inference_mode_takes_no_checkpoint(monkeypatch):
    cfg, jcfg = _cfgs("llama3.2-1b")
    model, _ = _model(jcfg, cfg)
    monkeypatch.setattr(T, "checkpoint", None)  # would raise if called
    with torch.inference_mode():
        logits = TL.make_prefill_step(cfg)(model, _torch(_batch(cfg)))
    assert logits.shape == (B, S, cfg.vocab)


def test_k5_refuses_inputs_that_require_grad():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32)) for _ in range(3))
    want = flash_attention_kernel(q, k, v)  # no grad asked: runs
    with torch.no_grad():
        assert torch.equal(flash_attention_kernel(q, k, v.requires_grad_()),
                           want)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_kernel(q, k, v)
    cfg = dataclasses.replace(smoke_config(get_config("llama3.2-1b")),
                              use_pallas_attention=True)
    with pytest.raises(ValueError, match="use_pallas_attention"):
        TL.make_train_step(cfg, O.OptimizerConfig())
    # a trained model's prefill with K5 on still runs: inference mode
    model, _ = _model(jsmoke_config(jget_config("llama3.2-1b")), cfg)
    TL.value_and_grad(model, dataclasses.replace(
        cfg, use_pallas_attention=False), _torch(_batch(cfg)))
    assert TL.make_prefill_step(cfg)(model, _torch(_batch(cfg))).shape == (
        B, S, cfg.vocab)
    with pytest.raises(RuntimeError, match="no backward"):
        T.forward(model, cfg, _torch(_batch(cfg))["tokens"])


@pytest.mark.parametrize("S_,chunk", [(40, 16), (16, 512), (48, 16)])
def test_chunked_ce_matches_reference(S_, chunk):
    """Loss and its gradients (hidden, head), padded chunks and -1 labels
    included."""
    rng = np.random.default_rng(S_)
    h = rng.standard_normal((2, S_, 16)).astype(np.float32)
    head = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
    lab = rng.integers(-1, 50, (2, S_)).astype(np.int32)
    th, thead = (torch.from_numpy(x).requires_grad_() for x in (h, head))
    loss = TL.chunked_ce(th, thead, torch.from_numpy(lab), chunk)
    loss.backward()
    jloss, (jgh, jghead) = jax.value_and_grad(
        lambda a, b: JTL.chunked_ce(a, b, jnp.asarray(lab), chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    _close(loss, jloss, 1e-6, 1e-6)
    _close(th.grad, jgh, 1e-5, 1e-7)
    _close(thead.grad, jghead, 1e-5, 1e-7)
    with torch.no_grad():
        assert math.isclose(float(TL.chunked_ce(th, thead, torch.from_numpy(
            lab), chunk)), float(loss), rel_tol=1e-7)


def test_value_and_grad_gives_zeros_where_the_loss_does_not_reach():
    """whisper without frames: no encoder or cross-attention runs, and
    their gradients are zeros, as jax.grad gives."""
    cfg, jcfg = _cfgs("whisper-small")
    model, jparams = _model(jcfg, cfg)
    batch = _batch(cfg)
    del batch["frontend"]
    _, grads = TL.value_and_grad(model, cfg, _torch(batch))
    _, jgrads = jax.value_and_grad(lambda p, b: JTL.loss_fn(p, jcfg, b),
                                   has_aux=True)(jparams, _jax(batch))
    want = _by_name(jgrads, cfg)
    zero = [n for n, g in grads.items() if not g.any()]
    assert zero and all(n.startswith("encoder.") or ".cross." in n
                        or ".norm_x." in n for n in zero)
    for name, g in grads.items():
        _close(g, want[name].detach(), what=name)


def test_train_step_keeps_the_model_copyable():
    """Parameters stay leaves with no .grad: a deep copy (as a replica or
    a checkpoint snapshot takes) works after a step."""
    cfg, jcfg = _cfgs("qwen3-moe-30b-a3b")
    model, _ = _model(jcfg, cfg)
    oc = O.OptimizerConfig()
    state = O.init_opt_state(model.named_parameters(), oc)
    TL.make_train_step(cfg, oc)(model, state, _torch(_batch(cfg)))
    twin = copy.deepcopy(model)
    for (n, a), b in zip(model.named_parameters(), twin.parameters()):
        assert a.is_leaf and a.grad is None and torch.equal(a, b), n
