"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Its configuration is the JSON file ``configs/<config>.json``, whose
``generator`` names the data maker ``datagen/<generator>.py``; its mix is
``traffic/<traffic>.json``, whose ``kinds`` name the request modules
``requests/<kind>.py``; each metric is ``metrics/<metric>.py``.  Adding
a cell, a mix or a metric adds files and entries and edits none."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_module(group: str, name: str):
    """``sortbench/<group>/<name>.py`` as a module (a name may hold dots
    and dashes, so it is loaded by path)."""
    path = BENCH_DIR / group / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {group} module named {name!r} "
                                f"({path.relative_to(ROOT)})")
    key = f"sortbench.{group}._{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(group: str, name: str) -> dict:
    path = BENCH_DIR / group / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {group} file named {name!r} "
                                f"({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with what it names, loaded."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # the manifest's metric entries this cell reports
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (its ``workloads`` list, or
    every cell where it has none)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    manifest = load_manifest() if manifest is None else manifest
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]), config=config,
        traffic=load_json("traffic", w["traffic"]),
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, name)])
