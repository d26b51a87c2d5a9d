"""Data pipeline: deterministic, shardable, restart-safe synthetic token
streams + fractal-sort length-bucketed batching (port of ``repro.data``).

``SyntheticLM.batch(step)`` is a pure function of ``(seed, step)``, drawn
with the reference's numpy generator, so its tokens equal the
reference's bit for bit, restarts never replay or skip data, and every
data-parallel rank can slice its rows independently.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.fractal_sort import (fractal_argsort, resolve_device,
                                           to_device)

__all__ = ["DataConfig", "SyntheticLM", "length_bucketed_order",
           "put_batch", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Deterministic synthetic LM batches: ``batch(step)`` is pure.  Its
    ``{"tokens", "labels"}`` are (global_batch, seq_len) int32 tensors on
    ``device`` (``None`` means ``"cuda"`` and raises without a card)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        tokens = rng.integers(0, c.vocab, (c.global_batch, c.seq_len + 1),
                              dtype=np.int32)
        return put_batch({"tokens": torch.from_numpy(tokens[:, :-1]),
                          "labels": torch.from_numpy(tokens[:, 1:])},
                         self.device)


def length_bucketed_order(lengths, bucket_bits: int = 16, *, device=None):
    """Order examples by length with a fractal sort (``bucket_bits``-bit
    keys, lengths clipped into them) so each batch sees near-uniform
    sequence lengths — less padding waste.  This is the paper's sort on
    the data-pipeline hot path: K1 and K2 on the card.  Returns the stable
    int32 permutation on ``device`` (``None`` means ``"cuda"``)."""
    keys = torch.clamp(to_device(lengths, device).to(torch.int32), 0,
                       (1 << bucket_bits) - 1)
    return fractal_argsort(keys, bucket_bits, device=keys.device)


def put_batch(batch: dict, device) -> dict:
    """``batch``'s tensors on ``device``: to a card through pinned host
    memory with ``non_blocking`` copies, so the copy overlaps the running
    step; tensors already there are returned as they are."""
    device = resolve_device(device)
    out = {}
    for k, t in batch.items():
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.contiguous().pin_memory()
        out[k] = t.to(device, non_blocking=device.type == "cuda")
    return out


class Prefetcher:
    """Double-buffered host->device prefetch around any ``batch(step)``:
    ``put_fn`` moves one batch (e.g. ``functools.partial(put_batch,
    device="cuda")``)."""

    def __init__(self, source, put_fn, depth: int = 2):
        self.source = source
        self.put = put_fn
        self.depth = depth
        self._buf = {}

    def get(self, step: int):
        for s in range(step, step + self.depth):
            if s not in self._buf:
                self._buf[s] = self.put(self.source.batch(s))
        out = self._buf.pop(step)
        # drop stale entries (restart/skip safety)
        for s in list(self._buf):
            if s < step:
                del self._buf[s]
        return out
