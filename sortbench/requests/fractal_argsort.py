"""``fractal_argsort(keys, p)``: the call that query operators and MoE
dispatch make; the int32 permutation rides every pass.

The configuration's key sets are used in turn.  The client gets the
permutation on the device.  Judged: the permutation against the stable
``torch.argsort`` of the same set (exact); the control sorts by the top
``control.key_bits`` bits only."""

from __future__ import annotations

import torch
from repro_torch.core.autotune import tuned_plan
from repro_torch.core.fractal_sort import backend_name, fractal_argsort

from sortbench.harness.loop import Outcome
from sortbench.reference import sort as ref
from sortbench.reference.compare import mismatches

NAME = "argsort.mismatches"
# the port's entry this kind calls, by its name in this module, and the
# faults the CPU tests plant in it (:func:`broken`)
PORT_ENTRY = "fractal_argsort"
FAULTS = ("unchanged", "half", "altered")


def prepare(data: dict, config: dict) -> dict:
    return {"keys": data["keys"], "p": data["p"],
            "control_bits": int(config["control"]["key_bits"])}


def describe(state: dict) -> str:
    keys = state["keys"][0]
    plan = tuned_plan(keys.numel(), state["p"],
                      backend=backend_name(None, keys.device))
    return (f"fractal_argsort n={keys.numel()} p={state['p']}: "
            f"{plan.describe()}")


def call(state: dict, j: int):
    keys = state["keys"][j % len(state["keys"])]
    return fractal_argsort(keys, state["p"], device=keys.device)


def deliver(state: dict, j: int, perm) -> Outcome:
    i = j % len(state["keys"])
    return Outcome(judged=(i, perm), work=state["keys"][i].numel())


def judge(state: dict, judged) -> dict:
    i, perm = judged
    return {NAME: mismatches(perm, ref.stable_perm(state["keys"][i],
                                                   state["p"]))}


def control(state: dict) -> list:
    """The reference by the top ``control_bits`` bits, one answer a set."""
    return [(i, ref.stable_perm(keys, state["p"], bits=state["control_bits"]))
            for i, keys in enumerate(state["keys"])]


def broken(fault: str, argsort):
    """``argsort`` with a fault planted where its answer is produced: the
    identity returned (``unchanged``), the second half of the keys left
    out of the sort (``half``), or the first and last entries swapped
    (``altered``)."""
    def entry(keys, p, **kw):
        n = keys.numel()
        if fault == "unchanged":
            return torch.arange(n, dtype=torch.int32, device=keys.device)
        if fault == "half":
            return torch.cat([argsort(keys[: n // 2], p, **kw),
                              torch.arange(n // 2, n, dtype=torch.int32,
                                           device=keys.device)])
        perm = argsort(keys, p, **kw).clone()
        perm[[0, -1]] = perm[[-1, 0]]
        return perm
    return entry
