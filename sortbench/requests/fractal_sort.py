"""``fractal_sort(keys, p)``: the paper's own operation.

The configuration's key sets are used in turn.  The client gets the
sorted keys on the device.  Judged: the sorted keys against
``torch.sort`` of the same set (exact); the control sorts by the top
``control.key_bits`` bits only."""

from __future__ import annotations

import torch
from repro_torch.core.autotune import tuned_plan
from repro_torch.core.fractal_sort import backend_name, fractal_sort

from sortbench.harness.loop import Outcome
from sortbench.reference import sort as ref
from sortbench.reference.compare import mismatches

NAME = "sort.mismatches"
# the port's entry this kind calls, by its name in this module, and the
# faults the CPU tests plant in it (:func:`broken`)
PORT_ENTRY = "fractal_sort"
FAULTS = ("unchanged", "half", "altered")


def prepare(data: dict, config: dict) -> dict:
    return {"keys": data["keys"], "p": data["p"],
            "control_bits": int(config["control"]["key_bits"])}


def describe(state: dict) -> str:
    keys = state["keys"][0]
    plan = tuned_plan(keys.numel(), state["p"],
                      backend=backend_name(None, keys.device))
    return f"fractal_sort n={keys.numel()} p={state['p']}: {plan.describe()}"


def call(state: dict, j: int):
    keys = state["keys"][j % len(state["keys"])]
    return fractal_sort(keys, state["p"], device=keys.device)


def deliver(state: dict, j: int, out) -> Outcome:
    i = j % len(state["keys"])
    return Outcome(judged=(i, out), work=state["keys"][i].numel())


def judge(state: dict, judged) -> dict:
    i, out = judged
    want = ref.sorted_keys(state["keys"][i], state["p"])
    return {NAME: mismatches(ref.as_int64(out), want)}


def control(state: dict) -> list:
    """The reference by the top ``control_bits`` bits, one answer a set."""
    return [(i, ref.sorted_keys(keys, state["p"], bits=state["control_bits"]))
            for i, keys in enumerate(state["keys"])]


def broken(fault: str, sort):
    """``sort`` with a fault planted where its answer is produced: the
    keys returned unsorted (``unchanged``), the second half of the keys
    left out of the sort (``half``), or one key's lowest bit flipped
    (``altered``)."""
    def entry(keys, p, **kw):
        n = keys.numel()
        if fault == "unchanged":
            return keys
        if fault == "half":
            out = sort(keys[: n // 2], p, **kw)
            return torch.cat([out.view(torch.int32),
                              keys[n // 2:].view(torch.int32)]).view(out.dtype)
        out = sort(keys, p, **kw).clone()
        out.view(torch.int32)[n // 3] ^= 1
        return out
    return entry
