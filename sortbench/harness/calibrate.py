"""The readings that the limits of ``correct`` are set from.

For each of the program's seeds: set-up, a short closed-loop window at
the cell's own load, and the judge over its sample, as a run makes them
(the lower reading of a number is the largest over these seeds).  For
each of the control's seeds: the plain reference in the nearest lower
precision (each request module's ``control``), put in the program's
place and judged the same way (the upper reading is the smallest)."""

from __future__ import annotations

import gc

import torch

from sortbench.harness.cell import Setup, judge, set_up
from sortbench.harness.loop import Sample, closed_loop, traffic_order
from sortbench.harness.manifest import Cell, load_module


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def program_readings(cell: Cell, seed: int, seconds: float, device,
                     size=None) -> dict:
    """``{name: value}`` of one short window of the program."""
    setup = set_up(cell, seed, device, size)
    sample = Sample(seed, cell.traffic["kinds"], seconds)
    block = sum(int(s) for s in cell.traffic["kinds"].values())
    window = closed_loop(traffic_order(cell.traffic, seed), setup.kinds,
                         setup.states, setup.counters, seconds, device,
                         sample, min_requests=block)
    checks = judge(setup, sample.drain(), cell.config["limits"])
    checks["failed_requests"] = (window.failed, 0)
    del setup, sample
    _free(device)
    return {name: value for name, (value, _) in checks.items()}


def control_readings(cell: Cell, seed: int, device, size=None) -> dict:
    """``{name: value}`` of the control in the program's place."""
    kinds = {k: load_module("requests", k) for k in cell.traffic["kinds"]}
    data = load_module("datagen", cell.config["generator"]).make(
        cell.config, seed, device, size)
    states = {k: mod.prepare(data, cell.config) for k, mod in kinds.items()}
    answers = ((k, judged) for k, mod in kinds.items()
               for judged in mod.control(states[k]))
    checks = judge(Setup(kinds, states, {}), answers, cell.config["limits"])
    del data, states, answers
    _free(device)
    return {name: value for name, (value, _) in checks.items()}


def fails(cell: Cell, readings: dict) -> list:
    """The names of ``readings`` over the configuration's limits."""
    limits = dict(cell.config["limits"], kinds_unjudged=0, failed_requests=0)
    return sorted(n for n, v in readings.items() if not v <= limits[n])
