"""Run one cell of ``BENCHMARK.json`` against ``repro_torch`` on the card.

    python3 sortbench/run.py --workload paper-p32.sort --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; ``checks`` last); the
numbers compared against the plain reference are also the last lines of
standard error, each beside its limit.  Exits non-zero, printing no
result, where CUDA or the cell's cards are missing, where the port
cannot be imported, or where JAX or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole (``repro_torch`` is not
    ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.partition(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it (``700.00 W``):
    a card set below its maximum runs slower under load, so every
    number of a run stands beside it."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "--id=0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unknown ({type(exc).__name__})"
    return res.stdout.strip() or f"unknown (nvidia-smi rc {res.returncode})"


def finite(x):
    """``x`` with infinite floats (a relative error against a length that
    differs) written as the largest float, which JSON holds."""
    if isinstance(x, float) and not math.isfinite(x):
        return -sys.float_info.max if x < 0 else sys.float_info.max
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # caches inside the checkout, at fixed paths; an all-defaults plan
    # resolves from an empty autotune cache of this run's own
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.pop("REPRO_TRACE", None)
    tune_dir = tempfile.mkdtemp(prefix="sortbench-autotune-")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tune_dir,
                                                            "autotune.json")
    try:
        return run(args)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run(args) -> int:
    sys.path.insert(0, str(ROOT))
    from sortbench.harness.manifest import load_cell

    cell = load_cell(args.workload)
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available():
        print("sortbench: CUDA is not available; the benchmark measures "
              "the card and has no CPU fallback", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"sortbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"sortbench: the port does not import ({exc}); run from the "
              f"root of a checkout that holds src/repro_torch",
              file=sys.stderr)
        return 3
    from sortbench.harness.cell import log, run_cell

    log(f"[setup] torch imported {t_torch - T_START:.2f} s after the "
        f"start")
    log(f"[cell] {cell.name}: config {cell.config_name}, traffic "
        f"{cell.traffic_name}, seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}; autotune cache "
        f"{os.environ['REPRO_TORCH_AUTOTUNE_CACHE']} (empty)")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"sortbench: the run loaded {bad}; nothing it runs may load "
              f"JAX or the JAX package", file=sys.stderr)
        return 4
    result = finite(result)
    # read once the window has closed, so that it costs set-up nothing
    log(f"[card] {torch.cuda.get_device_name(0)}, power limit "
        f"{power_limit()}")
    for name, m in result["metrics"].items():
        log(f"[metric] {name} = {m['value']!r} {m['unit']}")
    for name, c in result["checks"].items():
        log(f"[check] {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
