"""The port's sharded paths over real process groups, against the JAX
reference's on forced host devices.

One module fixture runs four things side by side: the reference in one
subprocess with four forced host devices (its (2, 2) ``("data",
"model")`` mesh, a (4,) split-KV mesh and a (4,) pipeline mesh) and in
another (the unsharded steps of the tensor-parallel cases), the port in
one ``torch.multiprocessing.spawn`` of a four-rank gloo group
(the (2, 2) mesh and a (4, 1) one), every port check inside the
workers, and the train driver under ``torch.distributed.run`` on a
(2, 2) mesh.  Weights come from the reference's initialisers through
``params_from_jax``; inputs from numpy seeds.  Held:

* each rank's ``local_shard`` of every parameter of smoke llama3.2-1b and
  qwen3-moe equals the reference's addressable shard on the device at
  the same mesh coordinate, bit for bit;
* ``shard_train_step`` after 1 and 3 AdamW steps: the loss and the
  gathered parameters within rtol 1e-4 / atol 1e-5 of the reference's
  ``shard_train_step`` on its (2, 2) mesh (the few elements whose
  gradient lies within 10 eps of 0 within 2 lr, as in
  ``test_torch_train.py``) and of the port's unsharded
  ``make_train_step``; every parameter moved;
* qwen3-moe on the (2, 2) mesh at ``capacity_factor = E`` (per-shard
  capacity then drops nothing, as the reference's own test sets it): the
  logits within 2e-4 of the reference's meshed forward, every gradient
  (router and experts included) and the aux loss within rtol 1e-4 /
  atol 1e-5 of the unsharded ones, the dispatch through ``moe_ranks``
  (K1 and K2's wrappers);
* split-KV decode at 4 shards within 1e-5 of the reference's
  ``shard_map`` run at ``update_cache=False``; with ``update_cache=True``
  the new K/V land only at the global ``pos``, on its owner.  The
  reference writes them at ``pos`` clamped into every shard's slice (a
  fault of the reference, recorded here);
* ``gpipe_apply`` with S = 4, M = 6, mb = 2, D = 16 within 1e-5 of the
  reference's and of its sequential application;
* the driver restarts from its checkpoint and its losses equal the
  one-rank driver's;
* tensor parallelism on the (2, 2) mesh: each rank's block of the
  ``shard_prefill_step`` logits and of the ``T.decode_step`` logits over
  four positions (B = 2: the cache's sequence over `model`; for llama
  also B = 1: over both axes), its batch shard and its vocab shard,
  within 1e-5 of the same block of the reference's ``make_prefill_step``
  / ``decode_step`` on the same weights, for smoke llama3.2-1b,
  whisper-small at its published vocab of 51,865 (cross-attention on the
  slice; the vocab, which `model` does not divide, whole), llama with
  ``n_kv_heads = 1`` (k and v gathered over `model`) and with
  ``n_heads = 3`` (the layer gathered whole), jamba (mamba on the slice,
  capacity_factor = E) and xlstm (the mLSTM and sLSTM on the slice); the
  first layer's cache gathered by ``cache_specs`` and
  ``shard_decode_step``'s next tokens equal the reference's; every case's
  but llama's gradients, gathered, within rtol 1e-4 / atol 1e-5 of the
  unsharded ones (jamba's and xlstm's logits and gradients within the
  2e-4 their families are held to against the reference: the rounding
  of their recurrences, see ``TP_TOL``); each rank's q
  heads, product widths, mamba channels and xLSTM heads and units are
  its `model` slice's; ``shard_decode_step`` breaks an argmax tie across
  the two vocab shards to the lower index.

The (1, 1) mesh runs in this process, on a one-rank gloo group.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import optim as O
from repro_torch import sharding as SH
from repro_torch import train_lib as TL
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import moe_dispatch
from repro_torch.launch import train as train_driver
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import act_sharding as AS
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models.convert import params_from_jax
from repro_torch.pipeline import gpipe_apply

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA, MOE = "llama3.2-1b", "qwen3-moe-30b-a3b"
RTOL, ATOL = 1e-4, 1e-5
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 16, 3
KV_S, KV_POS = 64, 37  # 4 shards of 16 positions: pos 37 is rank 2's 5th
PIPE = dict(S=4, M=6, mb=2, D=16)
# whisper at its published vocab, which 2 does not divide: its embedding
# and head stay whole, as the reference's _fit_spec keeps them
TP_CASES = {"llama": (LLAMA, {}),
            "whisper": ("whisper-small", {"vocab": 51865}),
            "kv1": (LLAMA, {"n_kv_heads": 1}),
            "h3": (LLAMA, {"n_heads": 3, "n_kv_heads": 1}),
            "jamba": ("jamba-v0.1-52b", {}), "xlstm": ("xlstm-125m", {})}
TP_B, TP_S, TP_FRAMES, TP_LEN, TP_STEPS = 2, 16, 12, 8, 4
# decode batches: 2 splits the cache's sequence over `model`, 1 over both
# axes (the batch replicated)
TP_BATCHES = {case: (2, 1) if case == "llama" else (2,) for case in TP_CASES}
# the recurrent families within the 2e-4 they are held to against the
# reference (test_torch_families, test_torch_ssm, test_torch_xlstm): their
# unsharded logits are themselves 2.7e-5 (jamba) and 6.9e-6 (xlstm) off
# the reference's, jamba's unsharded fp32 gradients 3e-5 off a float64
# run (by norm, in the first layer), and the split adds rounding of the
# same order through their recurrences; 1e-5 for the others
TP_TOL = {"jamba": 2e-4, "xlstm": 2e-4}
# the tie of shard_decode_step's argmax: an untied smoke llama whose head
# is zero but for +e_0 at vocab 5 and 135 and -e_0 at 9 and 130 (each pair
# across the two shards of 128), and whose final norm keeps only x_0
TIE_COLS = {5: 1.0, 135: 1.0, 9: -1.0, 130: -1.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the suite runs
    several test processes on the host's cores, where torch's default
    thread pool waits on busy cores (a smoke jamba gradient took 9.4 s
    on 8 threads against 0.15 s on one, beside six busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch):
    """Smoke configs, qwen3-moe at capacity_factor = E."""
    cfg = smoke_config(get_config(arch))
    jcfg = jsmoke_config(jget_config(arch))
    if cfg.moe is not None:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.num_experts)))
            for c in (cfg, jcfg))
    return cfg, jcfg


def _at_capacity_e(cfg):
    """An MoE config at capacity_factor = E (per-shard capacity drops
    nothing); others as they are."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _tp_cfgs(case):
    """Smoke configs of a tensor-parallel case, overrides applied, MoE at
    capacity_factor = E."""
    arch, over = TP_CASES[case]
    return (_at_capacity_e(dataclasses.replace(
                smoke_config(get_config(arch)), **over)),
            _at_capacity_e(dataclasses.replace(
                jsmoke_config(jget_config(arch)), **over)))


def _flat(tree: dict, pre: str = "") -> dict:
    """``{"a/b": leaf}`` of a nested dict (a decode cache's layer)."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {pre + k: v})
    return out


def _block(x, rank: int, vocab_split: bool):
    """Rank ``rank``'s block of whole logits (B, S, V) on the (2, 2) mesh
    (ranks row-major over (data, model)): its half of the batch, and its
    half of the vocab where ``vocab_split``."""
    d, m = divmod(rank, 2)
    x = x[d * x.shape[0] // 2:(d + 1) * x.shape[0] // 2]
    if vocab_split:
        x = x[..., m * x.shape[-1] // 2:(m + 1) * x.shape[-1] // 2]
    return x


def _batch(tok) -> dict:
    tok = torch.from_numpy(np.array(tok))
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _inputs() -> dict:
    """Every input both sides read, as numpy."""
    inp = {"params": {}}
    for arch in (LLAMA, MOE):
        _, jcfg = _cfgs(arch)
        inp["params"][arch] = jax.tree.map(np.asarray, JT.init_params(
            jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(24)
    cfg, jcfg = _cfgs(LLAMA)
    inp["train"] = [rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S + 1)).astype(
        np.int32) for _ in range(TRAIN_STEPS)]
    inp["moe_tokens"] = rng.integers(0, _cfgs(MOE)[0].vocab, (4, 17)).astype(
        np.int32)
    hd = cfg.resolved_head_dim
    inp["attn"] = jax.tree.map(np.asarray, JL.attn_init(
        jax.random.PRNGKey(3), jcfg, np.float32))
    inp["kv_x"] = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    inp["kv_k"], inp["kv_v"] = (rng.standard_normal(
        (2, KV_S, cfg.n_kv_heads, hd)).astype(np.float32) for _ in range(2))
    inp["tp_params"] = {case: jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(5), _tp_cfgs(case)[1])) for case in TP_CASES}
    inp["tp_tokens"] = rng.integers(0, cfg.vocab, (TP_B, TP_S)).astype(
        np.int32)
    inp["tp_frames"] = rng.standard_normal(
        (TP_B, TP_FRAMES, cfg.d_model)).astype(np.float32)
    p = PIPE
    inp["pipe_w"] = (rng.standard_normal((p["S"], p["D"], p["D"])) * 0.3
                     ).astype(np.float32)
    inp["pipe_x"] = rng.standard_normal((p["M"], p["mb"], p["D"])).astype(
        np.float32)
    return inp


# the reference on four forced host devices
_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, functools, os, pickle, sys
    out_dir = sys.argv[1]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import optim as O, sharding as SH, train_lib as TL
    from repro.compat import make_mesh, shard_map
    from repro.configs import get_config, smoke_config
    from repro.models import act_sharding, layers as L, transformer as T
    from repro.pipeline import gpipe_apply
    assert len(jax.devices()) == 4
    with open(os.path.join(out_dir, "in.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"))
    rank_of = {d.id: r for r, d in enumerate(mesh.devices.flat)}

    def cfg_of(arch):
        cfg = smoke_config(get_config(arch))
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        return cfg

    def params_of(arch):
        return jax.tree.map(jnp.asarray, inp["params"][arch])

    out, trees = {}, {}
    for arch in ("llama3.2-1b", "qwen3-moe-30b-a3b"):
        cfg = cfg_of(arch)
        params = params_of(arch)
        placed = jax.device_put(params, SH.param_shardings(params, mesh, cfg))
        for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
            for sh in leaf.addressable_shards:
                out[f"shard/{arch}/{rank_of[sh.device.id]}/"
                    f"{SH._path_str(path)}"] = np.asarray(sh.data)

    cfg = cfg_of("llama3.2-1b")
    oc = O.OptimizerConfig(warmup_steps=0)
    params = params_of("llama3.2-1b")
    opt = O.init_opt_state(params, oc)
    batches = [{"tokens": jnp.asarray(t[:, :-1]),
                "labels": jnp.asarray(t[:, 1:])} for t in inp["train"]]
    step = TL.shard_train_step(TL.make_train_step(cfg, oc), mesh, params, opt,
                               batches[0], cfg)
    params = jax.device_put(params, SH.param_shardings(params, mesh, cfg))
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, b)
        out[f"train/loss/{i}"] = np.asarray(m["loss"])
        out[f"train/lr/{i}"] = np.asarray(m["lr"])
        trees[f"params/{i}"] = jax.tree.map(np.asarray, params)
        trees[f"nu/{i}"] = jax.tree.map(np.asarray, opt["nu"])
    act_sharding.set_batch_axes(None)

    cfg = cfg_of("qwen3-moe-30b-a3b")
    act_sharding.set_batch_axes(("data",), mesh)
    params = params_of("qwen3-moe-30b-a3b")
    params_s = jax.device_put(params, SH.param_shardings(params, mesh, cfg))
    tokens = jax.device_put(jnp.asarray(inp["moe_tokens"][:, :-1]),
                            NamedSharding(mesh, P("data")))
    with mesh:
        logits, aux = jax.jit(lambda p, t: T.forward(p, cfg, t))(params_s,
                                                                 tokens)
    out["moe/logits"], out["moe/aux"] = np.asarray(logits), np.asarray(aux)
    act_sharding.set_batch_axes(None)

    cfg = cfg_of("llama3.2-1b")
    mesh4 = make_mesh((4,), ("data",))
    p = jax.tree.map(jnp.asarray, inp["attn"])
    args = [jnp.asarray(inp[k]) for k in ("kv_x", "kv_k", "kv_v")]
    for update in (False, True):
        body = functools.partial(L.attn_decode, p, cfg, update_cache=update,
                                 kv_seq_axis="data")
        f = shard_map(lambda x_, k_, v_, pos_: body(x_, k_, v_, pos_),
                      mesh=mesh4,
                      in_specs=(P(), P(None, "data"), P(None, "data"), P()),
                      out_specs=(P(), P(None, "data"), P(None, "data")),
                      check_vma=False)
        o, k2, _ = f(*args, jnp.asarray(KV_POS))
        out[f"kv/{update}/out"], out[f"kv/{update}/k"] = (np.asarray(o),
                                                          np.asarray(k2))

    stages = make_mesh((4,), ("stage",))
    w, x = jnp.asarray(inp["pipe_w"]), jnp.asarray(inp["pipe_x"])
    stage_fn = lambda p, x: jax.nn.gelu(x @ p["w"])
    out["pipe/got"] = np.asarray(gpipe_apply(stage_fn, stages, "stage",
                                             {"w": w}, x))
    seq = x
    for s in range(w.shape[0]):
        seq = stage_fn({"w": w[s]}, seq)
    out["pipe/seq"] = np.asarray(seq)
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
    with open(os.path.join(out_dir, "ref_trees.pkl"), "wb") as f:
        pickle.dump(trees, f)
""").replace("KV_POS", str(KV_POS))


# the reference's unsharded prefill and decode of the tensor-parallel cases,
# in a process of its own beside the other
_REF_TP_SCRIPT = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    out_dir = sys.argv[1]
    import numpy as np, jax, jax.numpy as jnp
    from repro import train_lib as TL
    from repro.configs import get_config, smoke_config
    from repro.models import transformer as T
    with open(os.path.join(out_dir, "in.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}

    def flat(tree, pre=""):
        for k, v in tree.items():
            yield from (flat(v, f"{pre}{k}/") if isinstance(v, dict)
                        else [(pre + k, v)])

    for case, (arch, over) in TP_CASES.items():
        cfg = dataclasses.replace(smoke_config(get_config(arch)), **over)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        params = jax.tree.map(jnp.asarray, inp["tp_params"][case])
        batch = {"tokens": jnp.asarray(inp["tp_tokens"])}
        frames = jnp.asarray(inp["tp_frames"])
        if cfg.encoder_layers:
            batch["frontend"] = frames
        out[f"tp/{case}/prefill"] = np.asarray(
            jax.jit(TL.make_prefill_step(cfg))(params, batch))
        decode = jax.jit(lambda p, c, t, pos, x: T.decode_step(
            p, cfg, c, t, pos, cross_kv=x))
        for B in TP_BATCHES[case]:
            cache = T.init_cache(cfg, B, TP_LEN, jnp.float32)
            cross = (T.encode_cross_kv(params, cfg, frames[:B])[0]
                     if cfg.encoder_layers else None)
            tok = batch["tokens"][:B]
            for pos in range(TP_STEPS):
                logits, cache = decode(params, cache, tok[:, pos:pos + 1],
                                       pos, cross)
                out[f"tp/{case}/decode/{B}/{pos}"] = np.asarray(logits)
            # make_decode_step's next token: the argmax of decode_step's
            # logits (one compile of the step, not two)
            logits, cache = decode(params, cache,
                                   tok[:, TP_STEPS:TP_STEPS + 1], TP_STEPS,
                                   cross)
            out[f"tp/{case}/next/{B}"] = np.asarray(
                jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32))
            for key, leaf in flat(cache["b0"]):
                out[f"tp/{case}/cache/{B}/{key}"] = np.asarray(leaf[0])
    np.savez(os.path.join(out_dir, "ref_tp.npz"), **out)
""").replace("TP_CASES", repr(TP_CASES)).replace(
    "TP_BATCHES", repr(TP_BATCHES)).replace("TP_LEN", str(TP_LEN)).replace(
    "TP_STEPS", str(TP_STEPS))


def _count_calls(module, names, counts):
    """Wrap ``module.<name>`` to count its calls into ``counts``."""
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(module, name, counted)


def _worker(rank: int, out_dir: str) -> None:
    """Rank ``rank`` of the four-rank gloo group: every port check on the
    meshes, its results into ``port<rank>.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "store"),
        rank=rank, world_size=4)
    try:
        with open(os.path.join(out_dir, "in.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = make_host_mesh(2, 2, device="cpu")
        mesh4 = make_host_mesh(4, 1, device="cpu")
        out = {}
        for arch in (LLAMA, MOE):
            cfg, _ = _cfgs(arch)
            model = params_from_jax(inp["params"][arch], cfg, device="cpu")
            TL.shard_model(model, cfg, mesh)
            for name, p in model.named_parameters():
                out[f"shard/{arch}/{name}"] = p.detach().numpy()

        # shard_train_step, 3 steps
        cfg, _ = _cfgs(LLAMA)
        model = params_from_jax(inp["params"][LLAMA], cfg, device="cpu")
        TL.shard_model(model, cfg, mesh)
        oc = O.OptimizerConfig(warmup_steps=0)
        state = O.init_opt_state(model.named_parameters(), oc)
        step = TL.shard_train_step(cfg, oc, mesh)
        for i, tok in enumerate(inp["train"]):
            state, m = step(model, state, _batch(tok))
            out[f"train/loss/{i}"] = m["loss"].numpy()
            out[f"train/grad_norm/{i}"] = m["grad_norm"].numpy()
            full = TL.gather_state(model, state, mesh)
            for name, t in full["params"].items():
                out[f"train/params/{i}/{name}"] = t.numpy()

        # qwen3-moe under the mesh: forward, gradients, the dispatch
        cfg, _ = _cfgs(MOE)
        model = params_from_jax(inp["params"][MOE], cfg, device="cpu")
        TL.shard_model(model, cfg, mesh)
        calls = {}
        _count_calls(moe_dispatch, ("fractal_histogram",
                                    "fractal_rank_kernel"), calls)
        local = {k: SH.local_shard(v, ("data", None), mesh)
                 for k, v in _batch(inp["moe_tokens"]).items()}
        with AS.meshed(("data",), mesh):
            with torch.no_grad():
                logits, aux = T.forward(model, cfg, local["tokens"])
            out["moe/calls"] = np.array([calls.get("fractal_histogram", 0),
                                         calls.get("fractal_rank_kernel", 0)])
            (_, (loss, aux_g)), grads = TL.value_and_grad(model, cfg, local)
        out["moe/logits"] = SH.gather_full(logits, ("data", None, "model"),
                                           mesh).numpy()
        out["moe/aux"], out["moe/aux_grad_pass"] = aux.numpy(), aux_g.numpy()
        dist.all_reduce(loss, op=dist.ReduceOp.AVG,
                        group=mesh.get_group("data"))
        out["moe/loss"] = loss.numpy()
        for name, p in model.named_parameters():
            out[f"moe/grad/{name}"] = SH.gather_full(
                grads[name], p.shard_spec, mesh).numpy()

        # split-KV decode over the (4, 1) mesh's data axis
        cfg, _ = _cfgs(LLAMA)
        attn = _attention(inp, cfg)
        x = torch.from_numpy(inp["kv_x"])
        spec = (None, "data", None, None)
        with AS.meshed(None, mesh4), torch.inference_mode():
            for update in (False, True):
                ck, cv = (SH.local_shard(torch.from_numpy(inp[k]), spec,
                                         mesh4) for k in ("kv_k", "kv_v"))
                o, ck, _ = L.attn_decode(attn, cfg, x, ck, cv, KV_POS,
                                         update_cache=update,
                                         kv_seq_axis="data")
                out[f"kv/{update}/out"] = o.numpy()
                out[f"kv/{update}/k"] = SH.gather_full(ck, spec,
                                                       mesh4).numpy()

        _tp_worker(inp, mesh, out)
        _tie_worker(mesh, out)

        # gpipe over the (4, 1) mesh's data axis
        w = torch.from_numpy(inp["pipe_w"])
        out["pipe/got"] = gpipe_apply(
            lambda p, x: F.gelu(x @ p["w"], approximate="tanh"), mesh4,
            "data", {"w": w[mesh4.get_local_rank("data")]},
            torch.from_numpy(inp["pipe_x"])).numpy()
        np.savez(os.path.join(out_dir, f"port{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _tp_train_batch(inp, cfg) -> dict:
    batch = _batch(inp["tp_tokens"])
    if cfg.encoder_layers:
        batch["frontend"] = torch.from_numpy(inp["tp_frames"])
    return batch


def _tp_worker(inp, mesh, out) -> None:
    """The tensor-parallel cases on the (2, 2) mesh: prefill, four decode
    positions at B = 2 and 1, the next token, each rank's blocks of the
    logits; the product shapes of llama's prefill and the mixers' widths
    of jamba's and xlstm's."""
    seen = {"heads": [], "widths": [], "mamba": set(), "mlstm": set(),
            "slstm": set()}
    flash, gather = L.flash_attention, L.fsdp_gather
    scan, mlstm_in, slstm_step = S._linear_scan, X._mlstm_inputs, X._slstm_step

    def heads(q, *a, **kw):
        seen["heads"].append(q.shape[2])
        return flash(q, *a, **kw)

    def widths(w, tp_dim):
        w = gather(w, tp_dim)
        seen["widths"].append(tuple(w.shape))
        return w

    def channels(a, b):  # a: (B, L, d_in on this rank, N)
        seen["mamba"].add(a.shape[2])
        return scan(a, b)

    def mlstm_heads(*a, **kw):
        q = mlstm_in(*a, **kw)
        seen["mlstm"].add(q[0].shape[-2])
        return q

    def units(r, f_bias, xs, state):
        seen["slstm"].add((xs[0].shape[-1], tuple(r[0].shape)))
        return slstm_step(r, f_bias, xs, state)

    tokens = torch.from_numpy(inp["tp_tokens"])
    frames = torch.from_numpy(inp["tp_frames"])
    for case in TP_CASES:
        cfg, _ = _tp_cfgs(case)
        model = params_from_jax(inp["tp_params"][case], cfg, device="cpu")
        TL.shard_model(model, cfg, mesh)
        batch = {"tokens": tokens}
        if cfg.encoder_layers:
            batch["frontend"] = frames
        L.flash_attention, L.fsdp_gather = heads, widths
        S._linear_scan, X._mlstm_inputs, X._slstm_step = (
            channels, mlstm_heads, units)
        try:
            logits = TL.shard_prefill_step(cfg, mesh)(model, batch)
        finally:
            L.flash_attention, L.fsdp_gather = flash, gather
            S._linear_scan, X._mlstm_inputs, X._slstm_step = (
                scan, mlstm_in, slstm_step)
        if case == "llama":
            out["tp/shapes/heads"] = np.array(seen["heads"])
            out["tp/shapes/widths"] = np.array(seen["widths"])
        with AS.meshed(("data",), mesh):
            out[f"tp/{case}/vocab_split"] = np.array(
                T.vocab_start(model, cfg) is not None)
        out[f"tp/{case}/prefill"] = logits.numpy()
        for B in TP_BATCHES[case]:
            split = B % 2 == 0
            bspec = ("data" if split else None, None)
            cache = T.init_cache(cfg, B, TP_LEN, torch.float32, device="cpu",
                                 mesh=mesh)
            cross = None
            with AS.meshed(("data",), mesh), torch.inference_mode():
                if cfg.encoder_layers:
                    cross, _ = T.encode_cross_kv(model, cfg, frames[:B])
                    cross_local = [{k: SH.local_shard(v, bspec + (None,) * 2,
                                                      mesh)
                                    for k, v in c.items()} for c in cross]
                for pos in range(TP_STEPS):
                    tok = SH.local_shard(tokens[:B, pos:pos + 1], bspec, mesh)
                    logits, cache = T.decode_step(
                        model, cfg, cache, tok, pos,
                        cross_kv=cross_local if cross else None,
                        kv_seq_axis="model" if split else ("data", "model"))
                    out[f"tp/{case}/decode/{B}/{pos}"] = logits.numpy()
            nxt, cache = TL.shard_decode_step(cfg, mesh)(
                model, cache, tokens[:B, TP_STEPS:TP_STEPS + 1], TP_STEPS,
                cross_kv=cross)
            out[f"tp/{case}/next/{B}"] = SH.gather_full(nxt, bspec,
                                                        mesh).numpy()
            specs = _flat(SH.cache_specs(mesh, T.init_cache(
                cfg, B, TP_LEN, torch.float32, device="meta"), B, False)[0])
            for key, leaf in _flat(cache[0]).items():
                out[f"tp/{case}/cache/{B}/{key}"] = SH.gather_full(
                    leaf, specs[key], mesh).numpy()
        if case != "llama":  # llama's: the sharded train step's test
            local = TL._local_batch(_tp_train_batch(inp, cfg), mesh)
            with AS.meshed(("data",), mesh):
                _, grads = TL.value_and_grad(model, cfg, local)
            for name, p in model.named_parameters():
                out[f"tp/{case}/grad/{name}"] = SH.gather_full(
                    grads[name], p.shard_spec, mesh).numpy()
    out["tp/shapes/mamba"] = np.array(sorted(seen["mamba"]))
    out["tp/shapes/mlstm"] = np.array(sorted(seen["mlstm"]))
    out["tp/shapes/slstm"] = np.array([[d, *r] for d, r in sorted(
        seen["slstm"])])


def _tie_model():
    """The untied smoke llama of ``TIE_COLS``: its logits are +-x_0 at the
    four columns and zero elsewhere, so the largest tie across the two
    vocab shards whatever x_0's sign."""
    cfg = dataclasses.replace(smoke_config(get_config(LLAMA)),
                              tie_embeddings=False)
    model = T.Transformer(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(26))
    with torch.no_grad():
        model.lm_head.zero_()
        for col, sign in TIE_COLS.items():
            model.lm_head[0, col] = sign
        model.final_norm.scale.zero_()
        model.final_norm.scale[0] = 1.0
    return cfg, model


def _tie_worker(mesh, out) -> None:
    """``shard_decode_step`` on the tie model (B = 2, one step), beside the
    unsharded logits and argmax."""
    cfg, model = _tie_model()
    tok = torch.from_numpy(np.random.default_rng(26).integers(
        0, cfg.vocab, (2, 1)))
    with torch.inference_mode():
        logits, _ = T.decode_step(model, cfg, T.init_cache(
            cfg, 2, TP_LEN, torch.float32, device="cpu"), tok, 0)
    out["tie/logits"] = logits.numpy()
    TL.shard_model(model, cfg, mesh)
    nxt, _ = TL.shard_decode_step(cfg, mesh)(
        model, T.init_cache(cfg, 2, TP_LEN, torch.float32, device="cpu",
                            mesh=mesh), tok, 0)
    out["tie/next"] = SH.gather_full(nxt, ("data", None), mesh).numpy()


def _driver_cmd(ck: str, *launch) -> list:
    return [*launch, "-m", "repro_torch.launch.train", "--smoke",
            "--steps", "8", "--global-batch", "4", "--seq-len", "16",
            "--ckpt-dir", ck, "--ckpt-every", "3", "--induce-failure", "5",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs and trees, each rank's port
    outputs, the sharded driver's (stdout, journal)): the reference's
    subprocess, the driver's launcher and the port's spawned group run
    at once."""
    out_dir = str(tmp_path_factory.mktemp("sharded"))
    inp = _inputs()
    with open(os.path.join(out_dir, "in.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    # JAX_PLATFORMS=cpu: the image ships libtpu; without the pin jax probes
    # for a TPU and hangs the child
    env.update(PYTHONPATH="src", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    ref, ref_tp = (subprocess.Popen(
        [sys.executable, "-c", script, out_dir], cwd=REPO_ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for script in (_REF_SCRIPT, _REF_TP_SCRIPT))
    ck = os.path.join(out_dir, "ck")
    driver = subprocess.Popen(
        _driver_cmd(ck, sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "4") +
        ["--data-mesh", "2", "--model-mesh", "2"],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_worker, args=(out_dir,), nprocs=4, join=True)
    finally:
        _, ref_log = ref.communicate(timeout=600)
        _, tp_log = ref_tp.communicate(timeout=600)
        drv_out, drv_log = driver.communicate(timeout=600)
    assert ref.returncode == 0, ref_log[-4000:]
    assert ref_tp.returncode == 0, tp_log[-4000:]
    assert driver.returncode == 0, drv_out + drv_log[-4000:]
    with open(os.path.join(out_dir, "ref_trees.pkl"), "rb") as f:
        trees = pickle.load(f)
    with open(os.path.join(ck, "journal.jsonl")) as f:
        journal = [json.loads(line) for line in f]
    return (inp, {**np.load(os.path.join(out_dir, "ref.npz")),
                  **np.load(os.path.join(out_dir, "ref_tp.npz"))}, trees,
            [dict(np.load(os.path.join(out_dir, f"port{r}.npz")))
             for r in range(4)], (drv_out, journal))


def _ref_path(name: str, period: int) -> tuple:
    """(the reference's path of port parameter ``name``, its layer's
    repeat or None)."""
    parts = name.split(".")
    if parts[-1] == "scale":
        parts = parts[:-1]
    if parts[0] == "blocks":
        r, i = divmod(int(parts[1]), period)
        return "/".join(["blocks", f"b{i}"] + parts[2:]), r
    return {"embed": "embed/table", "lm_head": "lm_head/head"}.get(
        parts[0], "/".join(parts)), None


@pytest.mark.parametrize("arch", [LLAMA, MOE])
def test_local_shards_match_reference_bit_for_bit(runs, arch):
    _, ref, _, port, _ = runs
    cfg, _ = _cfgs(arch)
    n = 0
    for rank, out in enumerate(port):
        for key, got in out.items():
            if not key.startswith(f"shard/{arch}/"):
                continue
            path, r = _ref_path(key[len(f"shard/{arch}/"):],
                                len(cfg.pattern))
            want = ref[f"shard/{arch}/{rank}/{path}"]
            want = want if r is None else want[r]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)
            n += 1
    assert n == 4 * len(list(T.Transformer(
        cfg, device="meta").parameters()))


def _tiny_step(nu, t, oc):
    """Elements whose gradients' root mean square after ``t`` AdamW steps
    lies in (0, 10 eps): there fp32 noise in the gradient moves the
    parameter by a good part of lr (``test_torch_train._tiny_step``)."""
    rms = np.sqrt(np.asarray(nu, np.float32) / (1 - oc.b2 ** t))
    return (rms > 0) & (rms < 10 * oc.eps)


def test_shard_train_step_matches_reference_and_unsharded(runs):
    inp, ref, trees, port, _ = runs
    cfg, _ = _cfgs(LLAMA)
    oc = O.OptimizerConfig(warmup_steps=0)
    model = params_from_jax(inp["params"][LLAMA], cfg, device="cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = O.init_opt_state(model.named_parameters(), oc)
    step = TL.make_train_step(cfg, oc)
    loose, lr_sum = {}, 0.0
    for i, tok in enumerate(inp["train"]):
        state, m = step(model, state, _batch(tok))
        for out in port:
            np.testing.assert_allclose(out[f"train/loss/{i}"], ref[
                f"train/loss/{i}"], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(out[f"train/loss/{i}"],
                                       m["loss"].numpy(), rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_allclose(port[0][f"train/grad_norm/{i}"],
                                   m["grad_norm"].numpy(), rtol=RTOL)
        lr_sum += float(ref[f"train/lr/{i}"])
        want = dict(params_from_jax(trees[f"params/{i}"], cfg,
                                    device="cpu").named_parameters())
        nu = dict(params_from_jax(trees[f"nu/{i}"], cfg,
                                  device="cpu").named_parameters())
        for name, p in model.named_parameters():
            loose[name] = loose.get(name, False) | _tiny_step(
                nu[name].detach().numpy(), i + 1, oc)
            if i not in (0, 2):
                continue
            got = port[0][f"train/params/{i}/{name}"]
            for other in port[1:]:  # every rank gathers the same
                np.testing.assert_array_equal(
                    other[f"train/params/{i}/{name}"], got)
            np.testing.assert_allclose(got, p.detach().numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{i} {name}")
            w, lz = want[name].detach().numpy(), loose[name]
            np.testing.assert_allclose(got[~lz], w[~lz], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{i} {name}")
            assert np.abs(got - w)[lz].max(initial=0) <= (
                2 * lr_sum + ATOL), name
            if i == 0:
                assert np.abs(got - before[name].numpy()).max() > (
                    float(ref["train/lr/0"]) / 2), name
    n_loose = sum(int(v.sum()) for v in loose.values())
    assert n_loose <= sum(p.numel() for p in model.parameters()) // 100


def test_meshed_moe_forward_matches_reference(runs):
    inp, ref, _, port, _ = runs
    cfg, _ = _cfgs(MOE)
    model = params_from_jax(inp["params"][MOE], cfg, device="cpu")
    with torch.no_grad():
        logits, aux = T.forward(model, cfg, _batch(inp["moe_tokens"])[
            "tokens"])
    for out in port:
        np.testing.assert_allclose(out["moe/logits"], ref["moe/logits"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out["moe/logits"], logits.numpy(),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out["moe/aux"], ref["moe/aux"],
                                   rtol=RTOL, atol=ATOL)


def test_meshed_moe_gradients_match_unsharded(runs):
    """The router's and the experts' gradients (and every other one)
    through the expert-parallel branch, gathered, against one rank's; the
    aux loss is the global one."""
    inp, _, _, port, _ = runs
    cfg, _ = _cfgs(MOE)
    model = params_from_jax(inp["params"][MOE], cfg, device="cpu")
    (_, (loss, aux)), grads = TL.value_and_grad(model, cfg,
                                                _batch(inp["moe_tokens"]))
    assert {n.rsplit(".", 1)[1] for n in grads if ".ffn." in n} == {
        "router", "wi", "wg", "wd"}
    for out in port:
        np.testing.assert_allclose(out["moe/loss"], loss.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(out["moe/aux_grad_pass"], aux.numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out["moe/aux"], aux.numpy(), rtol=RTOL,
                                   atol=ATOL)
        for name, g in grads.items():
            np.testing.assert_allclose(out[f"moe/grad/{name}"], g.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_meshed_moe_dispatches_on_moe_ranks(runs):
    """The branch's dispatch is ``moe_ranks``: K1 (the histogram) and K2
    (the ranks) once per MoE layer of the forward."""
    _, _, _, port, _ = runs
    cfg, _ = _cfgs(MOE)
    n_moe = sum(f == "moe" for _, f in cfg.pattern) * cfg.repeats
    for out in port:
        np.testing.assert_array_equal(out["moe/calls"], [n_moe, n_moe])


def _attention(inp, cfg):
    attn = L.Attention(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, w in inp["attn"].items():
            getattr(attn, name).copy_(torch.from_numpy(np.array(w)))
    return attn


def _dense_decode(inp, update: bool) -> tuple:
    """The one-rank decode over the whole cache: (out, K after)."""
    cfg, _ = _cfgs(LLAMA)
    k = torch.from_numpy(inp["kv_k"].copy())
    with torch.inference_mode():
        out, _, _ = L.attn_decode(
            _attention(inp, cfg), cfg, torch.from_numpy(inp["kv_x"]), k,
            torch.from_numpy(inp["kv_v"].copy()), KV_POS,
            update_cache=update)
    return out.numpy(), k.numpy()


def test_split_kv_decode_matches_reference(runs):
    """At ``update_cache=False`` against the reference's split-KV run and
    the dense decode; at ``update_cache=True`` against the dense decode
    (the reference's write is at fault there, see below)."""
    inp, ref, _, port, _ = runs
    for out in port:
        np.testing.assert_allclose(out["kv/False/out"], ref["kv/False/out"],
                                   rtol=1e-5, atol=1e-5)
        for update in (False, True):
            np.testing.assert_allclose(out[f"kv/{update}/out"],
                                       _dense_decode(inp, update)[0],
                                       rtol=1e-5, atol=1e-5)


def test_split_kv_cache_write_lands_on_the_owner_only(runs):
    """The one intended divergence of this slice: the port writes the new
    K/V at the global ``pos`` on the rank that owns it.  The reference's
    split-KV write is a fault: it writes at ``pos`` clamped into every
    shard's local slice (``dynamic_update_slice`` at the global index),
    so each shard's last position takes the new K."""
    inp, ref, _, port, _ = runs
    changed = lambda k: sorted(set(np.nonzero(
        (k != inp["kv_k"]).any(axis=(0, 2, 3)))[0].tolist()))
    shard = KV_S // 4
    assert changed(ref["kv/True/k"]) == [shard * r + shard - 1
                                         for r in range(4)]
    assert changed(ref["kv/False/k"]) == []
    for out in port:
        assert changed(out["kv/True/k"]) == [KV_POS]
        assert changed(out["kv/False/k"]) == []
    # the port's written row is the dense path's
    np.testing.assert_array_equal(port[0]["kv/True/k"],
                                  _dense_decode(inp, True)[1])


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tensor_parallel_prefill_and_decode_match_reference(runs, case):
    """Each rank's block of the prefill logits and of four decode
    positions' at B = 2 (cache sequence over `model`) and B = 1 (over both
    axes) -- its batch shard and, where `model` divides the vocab, its
    vocab shard, as the reference's output splits them -- the first
    layer's cache after them and the next token, on the (2, 2) mesh
    against the reference's unsharded steps."""
    _, ref, _, port, _ = runs
    cfg, _ = _tp_cfgs(case)
    split = cfg.vocab % 2 == 0
    tol = TP_TOL.get(case, 1e-5)
    for rank, out in enumerate(port):
        assert bool(out[f"tp/{case}/vocab_split"]) == split
        np.testing.assert_allclose(
            out[f"tp/{case}/prefill"],
            _block(ref[f"tp/{case}/prefill"], rank, split), rtol=tol,
            atol=tol)
        for B in TP_BATCHES[case]:
            for pos in range(TP_STEPS):
                key = f"tp/{case}/decode/{B}/{pos}"
                want = ref[key]
                if B == 1:  # the batch replicated over `data`
                    want = np.concatenate([want, want])
                np.testing.assert_allclose(out[key], _block(want, rank, split),
                                           rtol=tol, atol=tol, err_msg=key)
            keys = [k for k in ref if k.startswith(f"tp/{case}/cache/{B}/")]
            assert keys and sorted(keys) == sorted(
                k for k in out if k.startswith(f"tp/{case}/cache/{B}/"))
            for key in keys:
                np.testing.assert_allclose(out[key], ref[key], rtol=tol,
                                           atol=tol, err_msg=key)
            np.testing.assert_array_equal(out[f"tp/{case}/next/{B}"],
                                          ref[f"tp/{case}/next/{B}"])


@pytest.mark.parametrize("case", [c for c in TP_CASES if c != "llama"])
def test_tensor_parallel_gradients_match_unsharded(runs, case):
    """Every gradient through the split layers (whisper's cross-attention,
    the k and v gathered over `model` and their reduce-scattered
    gradients, the layer gathered whole, mamba's all-to-all and x_proj
    sum, the sLSTM's two gathers of h, the vocab-parallel loss), gathered,
    against one rank's."""
    inp, _, _, port, _ = runs
    cfg, _ = _tp_cfgs(case)
    rtol, atol = (TP_TOL[case],) * 2 if case in TP_TOL else (RTOL, ATOL)
    model = params_from_jax(inp["tp_params"][case], cfg, device="cpu")
    _, grads = TL.value_and_grad(model, cfg, _tp_train_batch(inp, cfg))
    for out in port:
        for name, g in grads.items():
            np.testing.assert_allclose(out[f"tp/{case}/grad/{name}"],
                                       g.numpy(), rtol=rtol, atol=atol,
                                       err_msg=name)


def test_tensor_parallel_products_run_on_the_model_slice(runs):
    """llama's prefill on the (2, 2) mesh: attention over n_heads / 2 q
    heads, and every dense weight at its `model` slice's width: wq, wk,
    wv (D, H hd / 2), wo (H hd / 2, D), wi, wg (D, d_ff / 2), wd (d_ff /
    2, D), each gathered over `data` only."""
    _, _, _, port, _ = runs
    cfg, _ = _tp_cfgs("llama")
    D, q = cfg.d_model, cfg.n_heads * cfg.resolved_head_dim // 2
    kv = cfg.n_kv_heads * cfg.resolved_head_dim // 2
    f = cfg.d_ff // 2
    for out in port:
        assert out["tp/shapes/heads"].tolist() == [cfg.n_heads // 2]
        assert [tuple(w) for w in out["tp/shapes/widths"]] == [
            (D, q), (D, kv), (D, kv), (q, D), (D, f), (D, f), (f, D)]


def test_recurrent_mixers_run_on_the_model_slice(runs):
    """jamba's mamba scans d_inner / 2 channels a rank; xlstm's mLSTM
    runs n_heads / 2 heads and its sLSTM D / 2 units (recurrent weights
    (D, D / 2)) a rank."""
    _, _, _, port, _ = runs
    jamba, _ = _tp_cfgs("jamba")
    xlstm, _ = _tp_cfgs("xlstm")
    d_in = jamba.mamba.expand * jamba.d_model
    D = xlstm.d_model
    for out in port:
        assert out["tp/shapes/mamba"].tolist() == [d_in // 2]
        assert out["tp/shapes/mlstm"].tolist() == [xlstm.n_heads // 2]
        assert out["tp/shapes/slstm"].tolist() == [[D // 2, D, D // 2]]


def test_shard_decode_step_breaks_vocab_ties_to_the_lower_index(runs):
    """The largest logit ties across the two vocab shards (exactly: both
    are x_0); ``shard_decode_step`` gives the lower index, as the
    unsharded ``torch.argmax`` and the reference's ``jnp.argmax`` do."""
    _, _, _, port, _ = runs
    logits = port[0]["tie/logits"][:, 0]
    top = logits.max(axis=-1)
    for pair in ((5, 135), (9, 130)):
        np.testing.assert_array_equal(logits[:, pair[0]], logits[:, pair[1]])
    for row, t in zip(logits, top):
        assert t > 0 and sorted(np.nonzero(row == t)[0].tolist()) in (
            [5, 135], [9, 130])
    want = np.argmax(logits, axis=-1)[:, None]
    assert set(want[:, 0].tolist()) <= {5, 9}
    for out in port:
        np.testing.assert_array_equal(out["tie/next"], want)


def test_gpipe_matches_reference_and_sequential(runs):
    inp, ref, _, port, _ = runs
    seq = torch.from_numpy(inp["pipe_x"])
    for w in torch.from_numpy(inp["pipe_w"]):
        seq = F.gelu(seq @ w, approximate="tanh")
    for out in port:
        np.testing.assert_allclose(out["pipe/got"], ref["pipe/got"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["pipe/got"], ref["pipe/seq"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["pipe/got"], seq.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_sharded_driver_restarts_like_the_one_rank_driver(runs, tmp_path,
                                                          capsys):
    """``torch.distributed.run`` of four ranks on a (2, 2) mesh: the
    induced failure, the restart from the gathered checkpoint, and the
    journal's losses equal to the one-rank driver's in this process."""
    _, _, _, _, (stdout, journal) = runs
    for line in ("[train] step 5 failed: induced failure at step 5; "
                 "restoring", "[train] restarted from step 3",
                 "[train] done; straggler count:"):
        assert stdout.count(line) == 1, stdout  # rank 0 speaks alone
    train_driver.main(_driver_cmd(str(tmp_path / "ck"))[2:])
    assert "[train] restarted from step 3" in capsys.readouterr().out
    with open(tmp_path / "ck" / "journal.jsonl") as f:
        one = [json.loads(line) for line in f]
    assert [j["step"] for j in journal] == [j["step"] for j in one] == [
        0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    np.testing.assert_allclose([j["loss"] for j in journal],
                               [j["loss"] for j in one], rtol=1e-5)


# --- the (1, 1) mesh in this process ----------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "store"), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", [LLAMA, MOE])
def test_one_rank_mesh_step_equals_make_train_step(one_rank, arch):
    cfg, jcfg = _cfgs(arch)
    params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(1),
                                                     jcfg))
    plain = params_from_jax(params, cfg, device="cpu")
    sharded = params_from_jax(params, cfg, device="cpu")
    specs = TL.shard_model(sharded, cfg, one_rank)
    assert set(specs) == {n for n, _ in plain.named_parameters()}
    oc = O.OptimizerConfig(warmup_steps=0)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 17))
    s1, m1 = TL.make_train_step(cfg, oc)(
        plain, O.init_opt_state(plain.named_parameters(), oc), _batch(tok))
    s2, m2 = TL.shard_train_step(cfg, oc, one_rank)(
        sharded, O.init_opt_state(sharded.named_parameters(), oc),
        _batch(tok))
    for k in ("loss", "aux_loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m2[k].numpy(), m1[k].numpy(), rtol=1e-6,
                                   err_msg=k)
    full = TL.gather_state(sharded, s2, one_rank)
    for name, p in plain.named_parameters():
        np.testing.assert_allclose(full["params"][name].numpy(),
                                   p.detach().numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(full["opt"]["mu"][name].numpy(),
                                   s1["mu"][name].numpy(), rtol=RTOL,
                                   atol=ATOL * 0.1)
    # and back: load_state puts a full state into the sharded model
    TL.load_state(sharded, s2, TL.gather_state(sharded, s2, one_rank),
                  one_rank)
    assert int(s2["step"]) == 1


def test_one_rank_split_kv_and_gpipe(one_rank):
    """A one-rank split-KV decode of a whole model equals the dense
    decode; ``init_cache(kv_shards=)`` gives the slice's shape; gpipe at
    S = 1 is the stage applied to each microbatch."""
    cfg, jcfg = _cfgs(LLAMA)
    model = params_from_jax(jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(1), jcfg)), cfg, device="cpu")
    dense = T.init_cache(cfg, 2, 32, torch.float32, device="cpu")
    split = T.init_cache(cfg, 2, 32, torch.float32, device="cpu",
                         kv_shards=1)
    assert T.init_cache(cfg, 2, 32, torch.float32, device="cpu",
                        kv_shards=4)[0]["k"].shape == (
        2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    with pytest.raises(ValueError, match="equal slices"):
        T.init_cache(cfg, 2, 30, torch.float32, device="cpu", kv_shards=4)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 6)))
    with AS.meshed(None, one_rank), torch.inference_mode():
        for pos in range(tokens.shape[1]):
            a, _ = T.decode_step(model, cfg, dense, tokens[:, pos:pos + 1],
                                 pos)
            b, _ = T.decode_step(model, cfg, split, tokens[:, pos:pos + 1],
                                 pos, kv_seq_axis="data")
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-5)
    x = torch.randn(3, 2, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(1))
    got = gpipe_apply(lambda p, x: torch.tanh(x @ p), one_rank, "data", w,
                      x)
    torch.testing.assert_close(got, torch.tanh(x @ w), rtol=0, atol=0)


def test_split_kv_needs_a_mesh():
    cfg, _ = _cfgs(LLAMA)
    attn = L.Attention(cfg, torch.float32, "cpu")
    cache = T.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        L.attn_decode(attn, cfg, torch.zeros(1, 1, cfg.d_model),
                      cache[0]["k"], cache[0]["v"], 0, kv_seq_axis="data")


def test_mesh_must_hold_the_whole_world(one_rank):
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_host_mesh(2, 1, device="cpu")
    cfg, _ = _cfgs(LLAMA)
    model = T.Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="sharded model"):
        TL.shard_train_step(cfg, O.OptimizerConfig(), one_rank)(
            model, O.init_opt_state(model.named_parameters(),
                                    O.OptimizerConfig()),
            _batch(np.zeros((2, 5), np.int32)))


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="initialised process group"):
        make_host_mesh(1, 1, device="cpu")
