"""Uniform p-bit keys made on the device from the seed (the paper's
§IV.A test bed: keys drawn uniformly over [0, 2**p)).

The harness's own maker, independent of the program: ``config["inputs"]``
distinct sets of ``2**config["log2n"]`` keys, set ``i`` drawn from the
seed's stream ``100 + i`` by one ``torch.randint`` on the device.  A
p = 32 set is a ``torch.uint32`` tensor (the bits drawn as int32), a
p <= 31 set int32 (the port's key types)."""

from __future__ import annotations

import torch

from sortbench.harness.loop import device_gen


def make(config: dict, seed: int, device, size: int | None = None) -> dict:
    """``{"p": p, "keys": [set, ...]}``; ``size`` replaces ``log2n`` (the
    CPU tests' small sets)."""
    p = int(config["p"])
    n = (1 << int(config["log2n"])) if size is None else int(size)
    keys = []
    for i in range(int(config["inputs"])):
        gen = device_gen(seed, 100 + i, device)
        if p == 32:
            k = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                              generator=gen, device=device).view(torch.uint32)
        else:
            k = torch.randint(0, 1 << p, (n,), dtype=torch.int32,
                              generator=gen, device=device)
        keys.append(k)
    return {"p": p, "keys": keys}
