"""Measured plan autotuning: pick (digit width x rank engine) per machine.

Port of ``repro.core.autotune``.  The SortPlan decomposition (§III.G)
and the per-pass rank engines give a two-axis execution space: *width*
trades passes against per-pass bin count, *engine* trades one-hot tile
arithmetic against sorted-tile scatter arithmetic.  The analytic cost
model (:func:`~repro_torch.core.sort_plan.plan_cost`) ranks the space a
priori, but the real crossover moves with the machine and the backend,
so :func:`autotune_plan` *measures* the grid once per (machine, backend,
key width, shape bucket) and caches the winner:

* **backends** — ``"torch"`` (:class:`~repro_torch.core.executor.
  TorchBackend` on the CPU, timed by ``time.perf_counter``) and
  ``"cuda"`` (:class:`~repro_torch.core.executor.CudaBackend` on the
  card, timed by CUDA events; it raises where there is no card).
* **shape bucket** — ``ceil(log2 n)``: one measurement covers every n in
  the bucket; measurement arrays are capped at 2**18 keys so tuning a
  huge-n bucket stays a one-off cost.
* **persistence** — a JSON file (``REPRO_TORCH_AUTOTUNE_CACHE``, else
  ``~/.cache/repro-fractalsort-torch/autotune.json``), keyed by
  ``machine|backend|p|l_n|bucket``; the machine key of ``"cuda"`` names
  the card, so a file copied between machines never hands one card's
  winner to another.  A hit never re-measures; delete the file (or pass
  ``force=True``) to re-sweep.
* **zero-cost default** — :func:`tuned_plan` is the cache-consult-only
  resolution every all-defaults sort, query operator and external sort
  uses: the cached winner if one exists, otherwise the static
  ``DEFAULT_MAX_BINS_LOG2`` plan.  Nothing measures implicitly.
"""

from __future__ import annotations

import datetime
import json
import os
import platform
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sort_plan import (
    DEFAULT_MAX_BINS_LOG2,
    SortPlan,
    make_sort_plan,
)
from repro_torch.obs import metrics

__all__ = [
    "autotune_plan",
    "candidate_grid",
    "cache_key",
    "consult_count",
    "default_cache_path",
    "host_key",
    "shape_bucket",
    "tuned_plan",
]

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

#: The backends a plan is tuned for.
BACKENDS = ("torch", "cuda")

#: Measurement arrays are capped at this many keys: big enough that the
#: engine crossover is the asymptotic one, small enough that a full grid
#: sweep is seconds, not minutes.
MEASURE_CAP_LOG2 = 18

#: Plans measured per grid point (median of this many timed runs after
#: one warm-up, which on the card also pays the kernels' first build).
_MEASURE_REPEAT = 3

#: Widest digit the sweep pairs with the one-hot engine: past it the
#: torch-op one-hot tile is O(n * 2**w), never a winner.
_ONEHOT_WIDTH_CAP = 8

# in-process caches: parsed cache files by path, resolved entries by
# (path, key) — the disk is read at most once per path per process.
_FILE_CACHE: dict = {}
_MEM_CACHE: dict = {}

# Monotone count of cache consultations (every autotune_plan call with
# p > 0).  Hot loops must not pay one per item: the external sort
# resolves one plan per (length, sort-bits) bucket per call, not per
# partition.  Tests read this counter to pin that invariant.
_CONSULTS = 0

# host name and core count, the part of host_key() that cannot change
# within a process: every all-defaults sort consults the cache, so it is
# read once
_HOST: Optional[str] = None


def consult_count() -> int:
    """Autotune cache consultations since process start (monotone)."""
    return _CONSULTS


def default_cache_path() -> str:
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-fractalsort-torch",
        "autotune.json")


def host_key(backend: str) -> str:
    """Identity of the measuring machine for ``backend``: host name and
    core count (read once a process), and for ``"cuda"`` the card's name
    too (``"no-card"`` where CUDA is unavailable, a key no sweep can
    fill)."""
    global _HOST
    if backend not in BACKENDS:
        raise ValueError(f"autotune backend {backend!r}: 'torch' or 'cuda'")
    if _HOST is None:
        _HOST = f"{platform.node() or 'unknown-host'}-cpu{os.cpu_count()}"
    key = _HOST
    if backend == "cuda":
        key += "-" + (torch.cuda.get_device_name()
                      if torch.cuda.is_available() else "no-card")
    return key


def shape_bucket(n: int) -> int:
    """ceil(log2 n): one tuning point covers the whole power-of-two
    bucket."""
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def cache_key(backend: str, p: int, l_n: Optional[int], bucket: int) -> str:
    return f"{host_key(backend)}|{backend}|p{p}|l{l_n or 0}|n2^{bucket}"


def candidate_grid(p: int,
                   widths: Optional[Sequence[int]] = None,
                   engines: Optional[Sequence[str]] = None,
                   ) -> Tuple[Tuple[int, str], ...]:
    """The (width, engine) points a sweep measures: the static default,
    the wide-pass candidates the scatter engine unlocks, and the paper's
    16-bit field when the key is wide enough."""
    if widths is None:
        widths = sorted({DEFAULT_MAX_BINS_LOG2, 6, 8, 11, min(16, p)})
    widths = [w for w in widths if 1 <= w <= min(16, p)]
    if not widths:
        raise ValueError(f"no candidate widths for p={p}")
    if engines is None:
        engines = ("onehot", "scatter")
    return tuple((w, e) for w in widths for e in engines
                 if not (e == "onehot" and w > _ONEHOT_WIDTH_CAP))


def _load(path: str) -> dict:
    if path not in _FILE_CACHE:
        try:
            with open(path) as f:
                _FILE_CACHE[path] = json.load(f)
        except (OSError, ValueError):
            _FILE_CACHE[path] = {}
    return _FILE_CACHE[path]


def _store(path: str, data: dict) -> None:
    _FILE_CACHE[path] = data
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        pass  # best-effort: an unwritable cache degrades to per-process


def _measure_plan(n: int, p: int, plan: SortPlan, backend: str,
                  repeat: int = _MEASURE_REPEAT) -> float:
    """Median seconds of one full plan execution on ``backend``: CUDA
    events around each run on ``"cuda"``, the host clock on
    ``"torch"``."""
    from repro_torch.core.executor import (CudaBackend, PlanExecutor,
                                           TorchBackend)

    if backend == "torch":
        device, ex = torch.device("cpu"), PlanExecutor(TorchBackend())
    elif backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("autotune backend 'cuda': CUDA is not "
                               "available")
        device, ex = torch.device("cuda"), PlanExecutor(CudaBackend())
    else:
        raise ValueError(f"autotune backend {backend!r}: 'torch' or 'cuda' "
                         "(tune distributed plans via max_bins_log2: the "
                         "collective, not the rank engine, dominates there)")
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 1 << p, n, dtype=np.uint64).astype(np.uint32)
    keys = torch.from_numpy(raw if p == 32 else raw.astype(np.int32)
                            ).to(device)
    ex.run(keys, plan)  # warm-up, outside the clock
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize()
        for _ in range(repeat):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ex.run(keys, plan)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(repeat):
            t0 = time.perf_counter()
            ex.run(keys, plan)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def autotune_plan(n: int, p: int, backend: str,
                  l_n: Optional[int] = None,
                  widths: Optional[Sequence[int]] = None,
                  engines: Optional[Sequence[str]] = None,
                  cache_path: Optional[str] = None,
                  measure: bool = True,
                  force: bool = False) -> SortPlan:
    """The fastest measured plan for an ``n``-key ``p``-bit sort on
    ``backend``.

    Consults the persisted per-machine cache first: a hit returns the
    recorded (width, engine) winner, re-instantiated for the exact ``n``.
    On a miss, measures every :func:`candidate_grid` point at the shape
    bucket's size (capped at 2**18 keys), records the winner with the
    full sweep, persists, and returns it.  ``measure=False`` turns the
    miss into the static default plan (what :func:`tuned_plan` wraps).
    ``force`` re-measures through an existing entry.

    A cached winner only satisfies a call whose (``widths``, ``engines``)
    grid contains it: a restricted grid that the recorded winner falls
    outside re-sweeps and re-records.
    """
    if p == 0:
        # zero-width keys: the identity plan, nothing to measure or cache
        # (the external sort reaches it once partitioning has consumed
        # every key bit)
        return make_sort_plan(n, 0)
    global _CONSULTS
    _CONSULTS += 1
    metrics.counter("autotune.consults").inc()
    path = cache_path or default_cache_path()
    bucket = shape_bucket(n)
    key = cache_key(backend, p, l_n, bucket)
    grid = candidate_grid(p, widths, engines)
    unrestricted = widths is None and engines is None
    entry = None if force else _MEM_CACHE.get((path, key)) \
        or _load(path).get(key)
    if entry is not None and (
            unrestricted
            or (entry["max_bins_log2"], entry["engine"]) in grid):
        metrics.counter("autotune.hit").inc()
        return make_sort_plan(n, p, l_n=l_n,
                              max_bins_log2=entry["max_bins_log2"],
                              engine=entry["engine"])
    metrics.counter("autotune.miss").inc()
    if not measure:
        return make_sort_plan(n, p, l_n=l_n)
    n_meas = 1 << min(bucket, MEASURE_CAP_LOG2)
    sweep = []
    for w, engine in grid:
        plan = make_sort_plan(n_meas, p, l_n=l_n, max_bins_log2=w,
                              engine=engine)
        wall = _measure_plan(n_meas, p, plan, backend)
        sweep.append({"max_bins_log2": w, "engine": engine,
                      "wall_s": wall, "plan": plan.describe()})
    best = min(sweep, key=lambda s: s["wall_s"])
    entry = {
        "max_bins_log2": best["max_bins_log2"],
        "engine": best["engine"],
        "wall_s": best["wall_s"],
        "n_measured": n_meas,
        "sweep": sweep,
        "date": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }
    data = dict(_load(path))
    data[key] = entry
    _MEM_CACHE[(path, key)] = entry
    _store(path, data)
    return make_sort_plan(n, p, l_n=l_n,
                          max_bins_log2=entry["max_bins_log2"],
                          engine=entry["engine"])


def tuned_plan(n: int, p: int, backend: str,
               l_n: Optional[int] = None,
               cache_path: Optional[str] = None) -> SortPlan:
    """Cache-consult-only plan resolution (never measures): the recorded
    winner for ``backend`` on this machine when one exists, the static
    default otherwise.  Callers pass the backend that will run the plan
    (``backend_name(backend, device)``)."""
    return autotune_plan(n, p, backend=backend, l_n=l_n,
                         cache_path=cache_path, measure=False)
