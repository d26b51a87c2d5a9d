"""Import and loop hygiene of the PyTorch port: ``repro_torch`` and
``chip_smoke.py`` import neither JAX nor the reference package, and the
executor stays the port's only pass loop."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", *sorted((ROOT / "examples").glob("torch_*.py"))]


def test_port_imports_load_no_jax_and_no_reference_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.obs, repro_torch.configs, repro_torch.train_lib\n"
        "import repro_torch.models.transformer, repro_torch.models.convert\n"
        "import repro_torch.models.moe, repro_torch.kernels.moe_dispatch\n"
        "import repro_torch.models.ssm, repro_torch.models.xlstm\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.checkpoint\n"
        "import repro_torch.runtime, repro_torch.sharding\n"
        "import repro_torch.launch.mesh, repro_torch.models.act_sharding\n"
        "import repro_torch.pipeline\n"
        "import repro_torch.query, repro_torch.query.operators\n"
        "import repro_torch.core.dispatch, repro_torch.core.faults\n"
        "import repro_torch.stream, repro_torch.stream.table_ops\n"
        "repro_torch.configs.get_config('llama3.2-1b')\n"
        "assert len(repro_torch.configs.list_configs()) == 10\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax_or_reference_import():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\.|"
        r"import\s+repro\s*$|from\s+repro\s+import)", re.M)
    offenders = [f"{path.relative_to(ROOT)}: {m.group(0).strip()}"
                 for path in _port_sources()
                 for m in pattern.finditer(path.read_text())]
    assert not offenders, offenders


def test_executor_is_the_only_pass_loop():
    loop = re.compile(r"for (\w+, )?dp in (enumerate\()?plan\.passes")
    hits = sorted(str(path.relative_to(PORT)) for path in PORT.rglob("*.py")
                  if loop.search(path.read_text()))
    assert hits == [os.path.join("core", "executor.py")], hits
