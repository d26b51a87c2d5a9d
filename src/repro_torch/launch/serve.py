"""Batched serving driver: continuous-batching-lite decode loop with a
fractal-sort request scheduler (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --smoke --device cpu

Requests arrive with prompt lengths and token budgets; the scheduler
orders the admission queue by remaining-length bucket using the paper's
sort (16-bit keys, :func:`~repro_torch.core.fractal_argsort` on the
model's device, so on the card through kernels K1 and K2), then the
decode loop advances all active slots one token per step, retiring and
refilling slots as budgets are exhausted.

Every registered architecture is served, as the reference serves it: an
enc-dec model (whisper) runs its decoder alone, with no ``cross_kv``.

The loop keeps the reference's behaviour token for token, faults
included (ROADMAP queue 3):

* one decode position for every slot, ``decode(..., pos.max())``: every
  slot's K/V is written at the largest slot position;
* no clearing of a slot on refill: a new request inherits the previous
  one's K/V and, in mamba and xLSTM layers, its recurrent state.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import train_lib as TL
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.fractal_sort import fractal_argsort, resolve_device
from repro_torch.models import transformer as T

__all__ = ["Request", "FractalScheduler", "serve", "make_requests", "main"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)


class FractalScheduler:
    """Admission queue ordered by remaining-length bucket (fractal sort
    on ``device``; ``None`` means cuda)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.queue: list = []

    def add(self, req: Request):
        self.queue.append(req)

    def take(self, n: int) -> list:
        if not self.queue:
            return []
        keys = torch.tensor(
            [min(len(r.prompt) + r.max_new, (1 << 16) - 1)
             for r in self.queue], dtype=torch.int32, device=self.device)
        order = fractal_argsort(keys, 16, device=self.device).cpu().numpy()
        picked = [self.queue[i] for i in order[:n]]
        remaining = set(int(i) for i in order[:n])
        self.queue = [r for i, r in enumerate(self.queue)
                      if i not in remaining]
        return picked


def make_requests(num_requests: int, vocab: int,
                  rng: np.random.Generator) -> list:
    """The reference driver's synthetic requests: prompts of 4..15 random
    tokens, budgets of 4..11 new tokens."""
    reqs = []
    for rid in range(num_requests):
        plen = int(rng.integers(4, 16))
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new=int(rng.integers(4, 12))))
    return reqs


def serve(model: T.Transformer, requests: list, batch_slots: int,
          max_len: int) -> list:
    """Serve ``requests`` with ``batch_slots`` decode slots and a KV cache
    of ``max_len`` positions; fills each request's ``out`` with its greedy
    tokens and returns the requests."""
    cfg = model.cfg
    decode = TL.make_decode_step(cfg)
    sched = FractalScheduler(model.device)
    for r in requests:
        sched.add(r)

    B = batch_slots
    cache = T.init_cache(cfg, B, max_len, model.dtype, model.device)
    slots: list = [None] * B
    pos = np.zeros(B, np.int64)
    done = 0
    t0 = time.time()
    steps = 0

    def refill():
        for b in range(B):
            if slots[b] is None:
                nxt = sched.take(1)
                if nxt:
                    slots[b] = nxt[0]
                    pos[b] = 0

    refill()
    while done < len(requests) and steps < 10_000:
        steps += 1
        # feed prompt tokens or decode
        feed = np.zeros((B, 1), np.int32)
        for b, r in enumerate(slots):
            if r is None:
                continue
            if pos[b] < len(r.prompt):
                feed[b, 0] = r.prompt[pos[b]]
            else:
                feed[b, 0] = r.out[-1] if r.out else 0
        nxt, cache = decode(model, cache,
                            torch.from_numpy(feed).to(model.device),
                            int(pos.max()))
        nxt = nxt.cpu().numpy()
        for b, r in enumerate(slots):
            if r is None:
                continue
            pos[b] += 1
            if pos[b] >= len(r.prompt):
                r.out.append(int(nxt[b, 0]))
            if len(r.out) >= r.max_new or pos[b] >= max_len - 1:
                print(f"[serve] rid={r.rid} done: prompt {len(r.prompt)} "
                      f"tokens -> {len(r.out)} generated")
                slots[b] = None
                done += 1
        refill()
    dt = time.time() - t0
    print(f"[serve] {done}/{len(requests)} requests, {steps} decode "
          f"steps, {steps * B / dt:.1f} tok/s ({dt:.1f}s)")
    return requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = T.Transformer(cfg, device=device,
                          dtype=getattr(torch, args.dtype)).init_params(gen)
    serve(model, make_requests(args.num_requests, cfg.vocab, rng),
          args.batch_slots, args.max_len)


if __name__ == "__main__":
    main()
