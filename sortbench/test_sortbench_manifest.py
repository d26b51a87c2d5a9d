"""``BENCHMARK.json`` against the benchmark's contract, its lookups by
name, and the import hygiene of everything the harness runs."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_manifest_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "sortbench/run.py"]
    assert MANIFEST["paths"] == ["sortbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts_use_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry and group in ("configs", "workloads",
                                              "per_layer"):
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (entry["name"], key)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry
            if "better" in entry:
                assert entry["better"] in ("lower", "higher"), entry
    for w in MANIFEST["workloads"]:
        names += [w["config"], w["traffic"]]
        assert w["chips"] in (1, 4)
    for c in MANIFEST["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names
                                               if not NAME.match(n)]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in MANIFEST[group]]
        assert len(group_names) == len(set(group_names)), group


def test_bounds_and_sources():
    assert "setup_s" in E2E
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "bound" not in m


def test_every_name_is_found_by_name():
    for c in MANIFEST["configs"]:
        path = ROOT / c["file"]
        assert path.is_relative_to(BENCH) and path.is_file(), c["file"]
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert (BENCH / "datagen" / f"{cfg['generator']}.py").is_file()
        assert cfg["test_size"] >= 1 and cfg["control_test_size"] >= 1
        for key in c["reduced"]:
            assert key in cfg, key
    for w in MANIFEST["workloads"]:
        traffic = BENCH / "traffic" / f"{w['traffic']}.json"
        assert traffic.is_file(), traffic
        for kind in json.loads(traffic.read_text())["kinds"]:
            path = BENCH / "requests" / f"{kind}.py"
            assert path.is_file(), kind
            tree = ast.parse(path.read_text())
            names = {t.id for n in tree.body if isinstance(n, ast.Assign)
                     for t in n.targets if isinstance(t, ast.Name)}
            names |= {n.name for n in tree.body
                      if isinstance(n, ast.FunctionDef)}
            assert {"PORT_ENTRY", "FAULTS", "prepare", "describe", "call",
                    "deliver", "judge", "control", "broken"} <= names, kind
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_every_cell_reports_what_its_metrics_move():
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in E2E, m
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS, (m["name"], cell)
            assert reports(E2E[m["moves"]], cell), (m["name"], cell)
    for cell in CELLS:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(reports(m, cell) for m in MANIFEST["per_layer"]), cell


def test_every_cell_loads_and_its_kinds_have_limits():
    sys.path.insert(0, str(ROOT))
    from sortbench.harness.manifest import load_cell

    for cell in CELLS:
        c = load_cell(cell)
        assert c.end_to_end and c.per_layer
        assert c.config["limits"], cell


def _code_strings(path: Path):
    """String constants of a source, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_harness_reads_no_reference_benchmark_or_smoke_script():
    sources = [p for p in BENCH.rglob("*.py") if not p.name.startswith("test_")]
    bad = [(p.name, s) for p in sources for s in _code_strings(p)
           if "chip_smoke" in s or "BENCH_" in s or "benchmarks" in s]
    assert not bad, bad


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {m.partition(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "torch", "sortbench"}, (path.name, tops)
        assert not any(m.startswith("sortbench.") and not m.startswith(
            "sortbench.reference") for m in _imports(path)), path.name


def test_loaded_modules_hold_no_jax_and_no_jax_package():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from sortbench.harness.manifest import load_module, load_cell\n"
        "from sortbench.harness import cell, calibrate, devtrace\n"
        "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
        "    c = load_cell(w['name'])\n"
        "    load_module('datagen', c.config['generator'])\n"
        "    [load_module('requests', k) for k in c.traffic['kinds']]\n"
        "    [load_module('metrics', m['name'])\n"
        "     for m in c.end_to_end + c.per_layer]\n"
        "tops = {m.partition('.')[0] for m in sys.modules}\n"
        "print(json.dumps(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro',"
        " 'chip_smoke', 'benchmarks'})))\n"
        "assert 'repro_torch' in tops\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_run_refuses_a_machine_without_the_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, "sortbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA is not available" in res.stderr
