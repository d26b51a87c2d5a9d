"""End-to-end training driver with fault tolerance (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --steps 50 --ckpt-dir <dir> [--device cpu]

Wires together: config registry → model init → synthetic data pipeline
(batches prefetched to the device) → AdamW → train step → step journal +
straggler monitor → async checkpointing → auto-resume.
``--induce-failure N`` crashes step N once to exercise the restart path
end to end.  ``--device`` defaults to the card and raises without one.

``--data-mesh D --model-mesh M`` above 1 x 1 runs SPMD, one process a
rank, under ``torch.distributed.run`` (the process group comes from its
environment; its world size must be D x M)::

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --smoke \
        --data-mesh 2 --model-mesh 2 --device cpu

The model is stored by spec and stepped by ``train_lib.shard_train_step``.
Checkpoints keep the port's format with full tensors: every leaf is
gathered and rank 0 writes; a restore reads the full leaves and each
rank keeps its shard.  Every rank fails and restores at the same step;
rank 0 prints and keeps the journal.
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import checkpoint as CK
from repro_torch import optim as O
from repro_torch import runtime as RT
from repro_torch import train_lib as TL
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.fractal_sort import resolve_device
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM, put_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--induce-failure", type=int, default=-1,
                    help="crash this step once (tests auto-restart)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run here)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    device = resolve_device(args.device)
    oc = O.OptimizerConfig(lr=args.lr, warmup_steps=10,
                           total_steps=args.steps)
    mesh, rank = None, 0
    n_ranks = args.data_mesh * args.model_mesh
    if n_ranks > 1:
        world = int(os.environ.get("WORLD_SIZE", 0))  # torch.distributed.run's
        if world != n_ranks:
            raise ValueError(
                f"--data-mesh {args.data_mesh} --model-mesh "
                f"{args.model_mesh} runs {n_ranks} ranks under "
                f"torch.distributed.run; the world size is {world or 'unset'}")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        mesh = make_host_mesh(args.data_mesh, args.model_mesh, device)
        rank = dist.get_rank()

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    model = T.Transformer(cfg, device=device).init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    if mesh is not None:
        TL.shard_model(model, cfg, mesh)
    opt_state = O.init_opt_state(model.named_parameters(), oc)

    data = Prefetcher(
        SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                               global_batch=args.global_batch,
                               seed=args.seed), device="cpu"),
        functools.partial(put_batch, device=device))
    step_fn = (TL.make_train_step(cfg, oc) if mesh is None
               else TL.shard_train_step(cfg, oc, mesh))

    journal = RT.StepJournal(f"{args.ckpt_dir}/journal.jsonl")
    monitor = RT.StragglerMonitor()
    ckpt = CK.AsyncCheckpointer(args.ckpt_dir, keep=3)
    state = {"opt": opt_state}

    def tree() -> dict:
        """The state to save: full tensors (gathered under a mesh)."""
        if mesh is None:
            return {"params": dict(model.named_parameters()),
                    "opt": state["opt"]}
        return TL.gather_state(model, state["opt"], mesh)

    def latest_step():
        """The newest checkpoint, once rank 0's writes are done."""
        ckpt.wait()
        if mesh is not None:
            dist.barrier()
        return CK.latest_step(args.ckpt_dir)

    @torch.no_grad()
    def load(step: int) -> None:
        if mesh is None:
            restored = CK.restore(args.ckpt_dir, step, tree())
            for name, p in model.named_parameters():
                p.copy_(restored["params"][name])
            state["opt"] = restored["opt"]
            return
        like = T.Transformer(cfg, device="meta", dtype=model.dtype)
        full = dict(like.named_parameters())
        moments = {n: torch.empty_like(t, dtype=state["opt"]["mu"][n].dtype)
                   for n, t in full.items()}
        restored = CK.restore(args.ckpt_dir, step, {
            "params": full, "opt": {"mu": moments, "nu": moments,
                                    "step": state["opt"]["step"]}},
            device="cpu")
        state["opt"] = TL.load_state(model, state["opt"], restored, mesh)

    # resume if a checkpoint exists
    start = 0
    latest = latest_step()
    if latest is not None:
        load(latest)
        start = latest
        say(f"[train] resumed from step {latest}")

    failed_once = {"done": False}

    def run_step(step: int):
        if step == args.induce_failure and not failed_once["done"]:
            failed_once["done"] = True
            raise RuntimeError(f"induced failure at step {step}")
        t0 = time.time()
        batch = data.get(step)
        state["opt"], metrics = step_fn(model, state["opt"], batch)
        loss = float(metrics["loss"])  # waits for the step on the card
        dt = time.time() - t0
        straggler = monitor.observe(dt)
        if rank == 0:
            journal.append(step, loss=loss, step_time=dt,
                           straggler=straggler)
        if step % 10 == 0 or straggler:
            tag = " STRAGGLER" if straggler else ""
            say(f"[train] step {step} loss {loss:.4f} ({dt:.2f}s){tag}")
        if step > 0 and step % args.ckpt_every == 0:
            full = tree()  # a collective under a mesh: every rank gathers
            if rank == 0:
                ckpt.save_async(step, full)
            del full

    def restore_latest() -> int:
        latest = latest_step()
        if latest is None:
            return 0
        load(latest)
        say(f"[train] restarted from step {latest}")
        return latest

    RT.run_with_restarts(run_step, start, args.steps - start,
                         restore_latest, max_restarts=args.max_restarts,
                         on_restart=lambda s, e: say(
                             f"[train] step {s} failed: {e}; restoring"))
    ckpt.wait()
    say(f"[train] done; straggler count: {monitor.flagged}")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
