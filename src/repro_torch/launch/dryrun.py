"""Multi-pod dry-run: rank 0's program of every (architecture x input
shape x mesh) cell on a fake process group (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's step for 256 or 512
placeholder devices and reads XLA's analyses.  The port runs rank 0's
step itself, SPMD as on a real mesh, with nothing allocated:

* the process group is ``"fake"`` (``torch.testing._internal.
  distributed.fake_pg.FakeStore``) of 256 ranks (16 x 16) or 512 (2 x
  16 x 16): every collective returns at once and moves nothing;
* the mesh is :func:`repro_torch.launch.mesh.make_production_mesh`;
* parameters (stored by spec, :func:`repro_torch.train_lib.shard_model`),
  optimizer state, caches and inputs are on the ``meta`` device: every
  op gives its output's shape and dtype and computes nothing (the MoE
  dispatch through its registered fake, no kernel);
* :class:`~repro_torch.launch.comm_stats.CommStats` records what the
  step does: FLOPs, bytes, collectives and the peak of live bytes.

So the numbers are those of the port's own program: its tensor-parallel
dense layers, its gathers and the collectives it issues, per rank.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import optim as O
from repro_torch import sharding as SH
from repro_torch import train_lib as TL
from repro_torch.configs import get_config, list_configs
from repro_torch.launch.comm_stats import CommStats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T

__all__ = ["SHAPES", "PARAM_DTYPE", "WHISPER_CROSS_LEN", "cell_supported",
           "input_specs", "fake_world", "dry_run_cell", "main"]

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

PARAM_DTYPE = torch.bfloat16
WHISPER_CROSS_LEN = 1500  # whisper's native encoder frame budget


def cell_supported(cfg, shape_name: str):
    """(supported, reason).  Skips are part of the assignment contract."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: no sub-quadratic mixer in "
                       "the published config; 0.5M-token dense decode is "
                       "outside its operating envelope (DESIGN.md §6)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str, cfg=None) -> dict:
    """``meta`` stand-ins for every global model input of this cell (the
    decode cache excepted: :func:`dry_run_cell` makes each rank's block of
    it); ``cfg``: the config, where overridden."""
    cfg = cfg or get_config(arch)
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    if sh["kind"] in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        if sh["kind"] == "train":
            batch["labels"] = _meta((B, S), torch.int32)
        if cfg.frontend == "audio":
            batch["frontend"] = _meta((B, S, cfg.d_model), PARAM_DTYPE)
        elif cfg.frontend == "patch":
            batch["frontend"] = _meta((B, cfg.num_patches, cfg.d_model),
                                      PARAM_DTYPE)
        return batch
    # decode: one new token against an S-long cache
    out = {"token": _meta((B, 1), torch.int32), "pos": S - 1}
    if cfg.encoder_layers:
        kv = (B, WHISPER_CROSS_LEN, cfg.n_kv_heads, cfg.resolved_head_dim)
        out["cross_kv"] = [{"ck": _meta(kv, PARAM_DTYPE),
                            "cv": _meta(kv, PARAM_DTYPE)}
                           for _ in range(cfg.n_layers)]
    return out


def _opt_config(cfg):
    # counter-width-tapered moments for the very large cells (DESIGN.md §5)
    big = cfg.params_count() > 30e9
    return O.OptimizerConfig(moment_dtype="bfloat16" if big else "float32")


@contextlib.contextmanager
def fake_world(n: int):
    """A ``"fake"`` default process group of ``n`` ranks, this process rank
    0, destroyed on exit.  It stays in the process's ``torch.distributed``
    state while it exists: run the dry-run in a process of its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise ValueError("fake_world: a process group is already "
                         "initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def dry_run_cell(arch: str, shape_name: str, multi_pod: bool,
                 verbose: bool = True, overrides: Optional[dict] = None):
    """Rank 0's train, prefill or decode step of one cell on a fake group
    of 256 (``multi_pod``: 512) ranks and the production mesh, everything
    on ``meta``.  Returns the reference's result dict, the port's
    meanings:

    * ``trace_seconds`` (the reference's ``compile_seconds``): the step's
      run under the recorder; the reference's ``xla_flops_static`` has no
      counterpart;
    * ``flops_per_device``, ``bytes_*_per_device``, ``collectives``:
      :meth:`~repro_torch.launch.comm_stats.CommStats.analyze` of rank 0;
    * ``memory``: ``argument_bytes`` the step's arguments on this rank
      (parameter shards, optimizer state, its block of the inputs and the
      cache), exact; ``output_bytes`` what the reference's step returns
      (train: the parameters, moments and metrics; prefill: the logits;
      decode: the next token and the cache); ``alias_bytes`` the part of
      it the port updates in place (parameters and moments; the cache),
      the reference's donated buffers; ``temp_bytes`` the peak of the
      bytes of tensors the step allocated while it ran (its fresh outputs
      included); ``code_bytes`` 0 (nothing is compiled).

    The train step is :func:`~repro_torch.train_lib.shard_train_step`,
    prefill :func:`~repro_torch.train_lib.shard_prefill_step` and decode
    :func:`~repro_torch.train_lib.shard_decode_step` on a model stored by
    the reference's serving policy (:func:`~repro_torch.train_lib.
    serving_config`) at ``pos = seq - 1``."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sh = SHAPES[shape_name]
    ins = input_specs(arch, shape_name, cfg)
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        model = T.Transformer(cfg, device="meta", dtype=PARAM_DTYPE)
        stats = CommStats()
        if sh["kind"] == "train":
            TL.shard_model(model, cfg, mesh)
            oc = _opt_config(cfg)
            opt = O.init_opt_state(model.named_parameters(), oc)
            step = TL.shard_train_step(cfg, oc, mesh)
            state = _nbytes(list(model.parameters())) + _nbytes(opt)
            args = state + _nbytes(TL._local_batch(ins, mesh))
            t0 = time.time()
            with stats:
                _, metrics = step(model, opt, ins)
            trace_s = time.time() - t0
            out_b, alias = state + _nbytes(metrics), state
        elif sh["kind"] == "prefill":
            TL.shard_model(model, cfg, mesh)
            step = TL.shard_prefill_step(cfg, mesh)
            args = (_nbytes(list(model.parameters()))
                    + _nbytes(TL._local_batch(ins, mesh)))
            t0 = time.time()
            with stats:
                logits = step(model, ins)
            trace_s = time.time() - t0
            out_b, alias = _nbytes(logits), 0
        else:  # decode
            B = sh["batch"]
            TL.shard_model(model, TL.serving_config(cfg, mesh), mesh)
            cache = T.init_cache(cfg, B, sh["seq"], PARAM_DTYPE,
                                 device="meta", mesh=mesh)
            step = TL.shard_decode_step(cfg, mesh)
            local = TL._local_batch({"token": ins["token"]}, mesh)
            cross = ins.get("cross_kv")
            cross_b = 0 if cross is None else _nbytes(cross) // (
                SH.dp_size(mesh) if B % SH.dp_size(mesh) == 0 else 1)
            args = (_nbytes(list(model.parameters())) + _nbytes(cache)
                    + _nbytes(local) + cross_b)
            t0 = time.time()
            with stats:
                nxt, cache = step(model, cache, ins["token"], ins["pos"],
                                  cross_kv=cross)
            trace_s = time.time() - t0
            out_b, alias = _nbytes(nxt) + _nbytes(cache), _nbytes(cache)
    st = stats.analyze()
    colls = st["collectives"]
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "kind": sh["kind"],
        "trace_seconds": round(trace_s, 1),
        "flops_per_device": st["flops"],
        "bytes_read_per_device": st["bytes_read"],
        "bytes_written_per_device": st["bytes_written"],
        "collectives": colls,
        "memory": {
            "argument_bytes": args,
            "output_bytes": out_b,
            "temp_bytes": stats.peak_bytes,
            "alias_bytes": alias,
            "code_bytes": 0,
        },
        "params_total": cfg.params_count(),
        "params_active": cfg.active_params_count(),
    }
    if verbose:
        m = result["memory"]
        per_dev_gib = (m["argument_bytes"] + m["temp_bytes"]
                       + m["output_bytes"] - m["alias_bytes"]) / 2**30
        print(f"[dryrun] {arch} x {shape_name} x {result['mesh']}: "
              f"trace {trace_s:.1f}s, "
              f"flops/dev {result['flops_per_device']:.3e}, "
              f"rd/wr GiB {result['bytes_read_per_device'] / 2**30:.1f}/"
              f"{result['bytes_written_per_device'] / 2**30:.1f}, "
              f"mem/dev ~{per_dev_gib:.2f} GiB, "
              f"collective wire {colls['total_wire_bytes'] / 2**30:.3f} GiB "
              f"({colls['count']} ops)", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. --override n_layers=2")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        if v in ("true", "false"):
            overrides[k] = v == "true"
        else:
            try:
                overrides[k] = float(v) if "." in v else int(v)
            except ValueError:
                overrides[k] = v

    archs = list_configs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])

    os.makedirs(args.out_dir, exist_ok=True)
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            ok, reason = cell_supported(cfg, shape)
            if not ok:
                print(f"[dryrun] SKIP {arch} x {shape}: {reason}")
                continue
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                out_path = os.path.join(args.out_dir, tag + ".json")
                try:
                    res = dry_run_cell(arch, shape, mp, overrides=overrides)
                    with open(out_path, "w") as f:
                        json.dump(res, f, indent=1)
                except Exception as e:  # noqa: BLE001 — report all failures
                    failures.append((tag, repr(e)))
                    print(f"[dryrun] FAIL {tag}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for t, e in failures:
            print("  ", t, e)
        raise SystemExit(1)
    print("[dryrun] all requested cells ran OK")


if __name__ == "__main__":
    main()
