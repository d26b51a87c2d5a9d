"""Zipf-distributed 32-bit keys made on the device from the seed: a
skewed column, where a few hot values hold most of the rows.

The harness's own maker, independent of the program:
``config["inputs"]`` distinct sets of ``2**config["log2n"]`` keys, each
drawn from Zipf(``config["zipf_a"]``) by Devroye's rejection method (the
sampler of numpy's ``Generator.zipf``) in float64, draws past 2**63
rejected as numpy rejects them, then clamped to 2**32 - 1 and viewed as
``torch.uint32``.

Set ``i`` is drawn :data:`CHUNK` keys at a time, which bounds the
float64 temporaries (a whole 2**29-key draw would hold about 4 GiB in
each, and set-up counts towards the device's memory peak).  Chunk ``c``
draws from its own generator, seeded from the seed's stream ``200 + i``
(``host_rng``) and ``c``, and redraws its rejected slots from it, so a
chunk's keys depend on the seed, the set and the chunk only."""

from __future__ import annotations

import torch

from sortbench.harness.loop import host_rng

CHUNK = 1 << 24   # keys of one generator, drawn at once
KEY_MAX = (1 << 32) - 1


def zipf_chunk(gen: torch.Generator, n: int, a: float, device) -> torch.Tensor:
    """``n`` draws of Zipf(``a``) from ``gen`` as int32 bits of the
    draws clamped to :data:`KEY_MAX` (values above 2**31 - 1 wrap)."""
    am1 = a - 1.0
    b = 2.0 ** am1
    x_out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)  # slots not yet accepted
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand(m, generator=gen, dtype=torch.float64,
                             device=device)
        v = torch.rand(m, generator=gen, dtype=torch.float64, device=device)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1) & (x < 2.0 ** 63) & (v * x * (t - 1.0) / (b - 1.0)
                                            <= t / b)
        x_out[todo[ok]] = x[ok]
        todo = todo[~ok]
    k = x_out.clamp_(max=KEY_MAX).to(torch.int64)
    return torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)


def make(config: dict, seed: int, device, size: int | None = None) -> dict:
    """``{"p": 32, "keys": [set, ...]}``; ``size`` replaces ``log2n``
    (the CPU tests' small sets)."""
    p = int(config["p"])
    if p != 32:
        raise ValueError(f"zipf_keys makes 32-bit keys, not p={p}")
    n = (1 << int(config["log2n"])) if size is None else int(size)
    a = float(config["zipf_a"])
    keys = []
    for i in range(int(config["inputs"])):
        seeds = host_rng(seed, 200 + i).integers(1 << 62,
                                                 size=-(-n // CHUNK))
        out = torch.empty(n, dtype=torch.int32, device=device)
        for c, s in enumerate(seeds.tolist()):
            gen = torch.Generator(device=device).manual_seed(s)
            c0 = c * CHUNK
            c1 = min(n, c0 + CHUNK)
            out[c0:c1] = zipf_chunk(gen, c1 - c0, a, device)
        keys.append(out.view(torch.uint32))
    return {"p": p, "keys": keys}
