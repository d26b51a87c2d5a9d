#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) of FractalSort on one
NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--log2n 27]

Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every CUDA source of ``src/repro_torch/kernels/csrc`` (timed);
3. every kernel (K1 histogram, K2 one-hot rank, K3 scatter rank, K4
   reconstruct) against its plain PyTorch version on the card, bit-exact
   (tolerance 0: integer outputs), at n in {1, 1000, 2**20 + 37} and
   n_bins in {16, 256, 2**16};
4. the main path at n = 2**log2n keys (default 2**27 = 512 MiB of uint32
   keys, the smallest data set of the paper's evaluation), generated from
   ``--seed``: ``fractal_sort`` at p = 32 and p = 16 on uniform and
   zipf-skewed keys, ``fractal_sort_pairs``, ``fractal_argsort``, the
   kernel entry points, the 8-bit scatter-engine plan, and the paper's
   16b+16b plan at n = 2**24 (also through the torch-op backend); every
   result bit-exact against ``torch.sort``/``torch.argsort(stable=True)``
   on int64, used here only as the check;
5. the kernels' launch counts over phase 4 (each must be > 0);
6. per-kernel times at the main path's shapes beside their bounds, the
   plain versions and one PyTorch library call, and the end-to-end sort
   time beside ``torch.sort``.

The last line of output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 2, iters: int = 7) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_sort(fn, top: int = 15) -> dict:
    """Device time of one warm call of ``fn`` by kernel name (the
    profiler's device-side events: kernels, memsets, copies), beside the
    call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue  # host-side op: its kernels are listed on their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append({"name": ev.key[:90], "calls": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms), "top": rows[:top]}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2n", type=int, default=27,
                    help="main-path key count 2**log2n (default 27)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one p=32 sort with torch.profiler and "
                         "print device time by kernel and op")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (exclusive_cumsum, fractal_argsort,
                                  fractal_sort, fractal_sort_pairs,
                                  make_sort_plan)
    from repro_torch.core.fractal_tree import u32_to_int64
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.fractal_histogram import fractal_histogram
    from repro_torch.kernels.fractal_rank import (fractal_rank_kernel,
                                                  fractal_rank_scatter_kernel)
    from repro_torch.kernels.fractal_reconstruct import fractal_reconstruct

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    t_all = time.perf_counter()

    # -- 1. the card ----------------------------------------------------------
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.build_log)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s (0 when already built)")
    for name, text in sorted(_build.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 3. kernel vs plain, bit-exact -----------------------------------------
    errs = {k: 0 for k in ops.KERNELS}

    def agree(kernel: str, got, want, what: str) -> None:
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        if err != 0:
            raise AssertionError(f"{kernel} disagrees with its plain "
                                 f"version at {what}: max |err| = {err}")

    t0 = time.perf_counter()
    cases = 0
    for n in (1, 1000, (1 << 20) + 37):
        for n_bins in (16, 256, 1 << 16):
            what = f"n={n} n_bins={n_bins}"
            # digits with some out-of-range pads (-1 and n_bins) mixed in
            d = rng.integers(0, n_bins, n).astype(np.int32)
            d[rng.random(n) < 0.01] = -1
            d[rng.random(n) < 0.01] = n_bins
            keys = torch.from_numpy(d).to(dev)
            agree("fractal_histogram", fractal_histogram(keys, n_bins),
                  ref.histogram_ref(keys, n_bins), what)
            init = torch.from_numpy(
                rng.integers(0, 1000, n_bins).astype(np.int32)).to(dev)
            agree("fractal_histogram", fractal_histogram(keys, n_bins, init=init),
                  ref.histogram_ref(keys, n_bins, init=init), what + " init")
            start = torch.from_numpy(
                rng.integers(0, 1 << 20, n_bins).astype(np.int32)).to(dev)
            agree("fractal_rank_kernel",
                  fractal_rank_kernel(keys, start, n_bins),
                  ref.rank_ref(keys, start, n_bins), what)
            # block 256 at 2**16 bins would pass the rank table's cap
            for block in ((1024, 256) if n_bins <= 256 else (1024,)):
                agree("fractal_rank_scatter_kernel",
                      fractal_rank_scatter_kernel(keys, start, n_bins,
                                                  block=block),
                      ref.rank_ref(keys, start, n_bins),
                      f"{what} block={block}")
            for t in (0, 4, 16):
                p = n_bins.bit_length() - 1 + t
                raw = rng.integers(0, 1 << p, n, dtype=np.uint64)
                s = torch.from_numpy(np.sort(raw).astype(np.uint32).view(np.int32)).to(dev)
                su = u32_to_int64(s)
                counts = ref.histogram_ref(su >> t, n_bins)
                trailing = (su & ((1 << t) - 1)).to(torch.int32)
                got = fractal_reconstruct(counts, trailing, n_bins, t)
                agree("fractal_reconstruct", got,
                      ref.reconstruct_ref(counts, trailing, t), f"{what} t={t}")
                agree("fractal_reconstruct", u32_to_int64(got), su,
                      f"{what} t={t} p={p} vs sorted keys")
            cases += 1
    # the histogram's init carried over ragged chunks equals one histogram
    d = torch.from_numpy(rng.integers(0, 256, (1 << 20) + 37).astype(np.int32)).to(dev)
    carried = None
    for lo in range(0, d.shape[0], 300007):
        carried = fractal_histogram(d[lo:lo + 300007], 256, init=carried)
    agree("fractal_histogram", carried, ref.histogram_ref(d, 256),
          "init carried over ragged chunks")
    log(f"[kernels] K1-K4 bit-exact against their plain versions over "
        f"{cases} shape cases in {time.perf_counter() - t0:.1f} s; "
        f"max |err| {json.dumps(errs)}")

    # -- 4. the main path at n = 2**log2n ------------------------------------------
    n = 1 << args.log2n
    t0 = time.perf_counter()
    uni32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    zipf = rng.zipf(1.2, n)
    data = {
        (32, "uniform"): torch.from_numpy(uni32).to(dev),
        (32, "zipf"): torch.from_numpy(
            np.minimum(zipf, (1 << 32) - 1).astype(np.uint32)).to(dev),
        (16, "uniform"): torch.from_numpy(
            (uni32 >> 16).astype(np.int32)).to(dev),
        (16, "zipf"): torch.from_numpy(
            np.minimum(zipf, (1 << 16) - 1).astype(np.int32)).to(dev),
    }
    del uni32, zipf
    log(f"[data] n = 2**{args.log2n} keys per set, seed {args.seed}, "
        f"{time.perf_counter() - t0:.1f} s to generate")

    def expect(keys):
        k64 = u32_to_int64(keys)
        return torch.sort(k64, stable=True).values, torch.argsort(k64, stable=True)

    def check(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: result differs from torch.sort")

    ops.reset_launch_counts()
    t_main = time.perf_counter()
    per_sort = None
    for (p, dist), keys in data.items():
        t1 = time.perf_counter()
        out = fractal_sort(keys, p)
        if per_sort is None:  # the first sort: p=32 uniform, default plan
            per_sort = ops.launch_counts()
        want_keys, want_perm = expect(keys)
        check(f"fractal_sort p={p} {dist}", u32_to_int64(out), want_keys)
        if dist == "uniform" and p == 32:
            rowid = torch.arange(n, dtype=torch.int32, device=dev)
            sk, sv = fractal_sort_pairs(keys, rowid, p)
            check("fractal_sort_pairs keys", u32_to_int64(sk), want_keys)
            check("fractal_sort_pairs values", sv.long(), want_perm)
            del sk, sv, rowid
        if dist == "zipf":
            perm = fractal_argsort(keys, p)
            check(f"fractal_argsort p={p} {dist}", perm.long(), want_perm)
            sk, sv = ops.fractal_sort_pairs_kernel(
                keys, torch.arange(n, dtype=torch.int32, device=dev), p)
            check(f"fractal_sort_pairs_kernel p={p} {dist}",
                  sv.long(), want_perm)
            del perm, sk, sv
        if p == 16 and dist == "uniform":
            check("fractal_sort_kernel p=16", u32_to_int64(
                ops.fractal_sort_kernel(keys, p)), want_keys)
        log(f"[main] p={p} {dist}: {make_sort_plan(n, p).describe()} "
            f"bit-exact ({time.perf_counter() - t1:.1f} s with checks)")
        del out, want_keys, want_perm
    keys = data[(32, "uniform")]
    plan8 = make_sort_plan(n, 32, max_bins_log2=8, engine="scatter")
    check("fractal_sort 8-bit scatter plan",
          u32_to_int64(fractal_sort(keys, 32, plan=plan8)), expect(keys)[0])
    log(f"[main] p=32 uniform, plan {plan8.describe()} (engine scatter) "
        f"bit-exact")
    n24 = min(n, 1 << 24)
    keys24 = keys[:n24].contiguous()
    plan16 = make_sort_plan(n24, 32, max_bins_log2=16)
    via_cuda = fractal_sort(keys24, 32, plan=plan16)
    check("fractal_sort 16b+16b plan", u32_to_int64(via_cuda), expect(keys24)[0])
    via_torch = fractal_sort(keys24, 32, plan=plan16, backend="torch")
    check("TorchBackend 16b+16b plan", u32_to_int64(via_torch),
          u32_to_int64(via_cuda))
    log(f"[main] n=2**{n24.bit_length() - 1} p=32 plan {plan16.describe()}: "
        f"CudaBackend and TorchBackend bit-exact")
    counts = ops.launch_counts()
    main_s = time.perf_counter() - t_main

    # -- 5. launch counts over the main path ------------------------------------
    log(f"[launches] main path ({main_s:.1f} s): {json.dumps(counts)}; "
        f"one default-plan p=32 sort: {json.dumps(per_sort)}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} was never launched on the main path")

    # -- 6. times at the main path's shapes ---------------------------------------
    kbits = keys.view(torch.int32)
    d16 = (kbits >> 4) & 15   # pass 1 digit of the default p=32 plan
    d256 = kbits & 255        # pass 0 digit of the 8-bit plan
    c16 = fractal_histogram(d16, 16)
    c256 = fractal_histogram(d256, 256)
    s16, s256 = exclusive_cumsum(c16), exclusive_cumsum(c256)
    msd = make_sort_plan(n, 32).passes[-1]  # depth 4, t = 28
    sorted_keys = fractal_sort(keys, 32).view(torch.int32)
    trail = sorted_keys & ((1 << msd.shift) - 1)
    mcounts = fractal_histogram((sorted_keys >> msd.shift) & (msd.n_bins - 1),
                                msd.n_bins)
    cdf = torch.cumsum(mcounts, 0, dtype=torch.int32)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    rows = [
        ("fractal_histogram", "fractal_histogram.cu",
         "src/repro/kernels/fractal_histogram.py:88",
         lambda: fractal_histogram(d16, 16),
         lambda: ref.histogram_ref(d16, 16),
         lambda: torch.bincount(d16, minlength=16),
         4 * n + 2 * 4 * 16, f"n=2**{args.log2n}, 16 bins"),
        ("fractal_rank_kernel", "fractal_rank.cu",
         "src/repro/kernels/fractal_rank.py:81",
         lambda: fractal_rank_kernel(d16, s16, 16),
         lambda: ref.rank_ref(d16, s16, 16),
         lambda: torch.sort(d16, stable=True),
         4 * n + 4 * 16 + 4 * n, f"n=2**{args.log2n}, 16 bins"),
        ("fractal_rank_scatter_kernel", "fractal_rank.cu",
         "src/repro/kernels/fractal_rank.py:150",
         lambda: fractal_rank_scatter_kernel(d256, s256, 256),
         lambda: ref.rank_ref(d256, s256, 256),
         lambda: torch.sort(d256, stable=True),
         4 * n + 4 * 256 + 4 * n, f"n=2**{args.log2n}, 256 bins"),
        ("fractal_reconstruct", "fractal_reconstruct.cu",
         "src/repro/kernels/fractal_reconstruct.py:53",
         lambda: fractal_reconstruct(mcounts, trail, msd.n_bins, msd.shift),
         lambda: ref.reconstruct_ref(mcounts, trail, msd.shift),
         lambda: torch.searchsorted(cdf, slots, right=True),
         4 * n + 4 * msd.n_bins + 4 * n,
         f"n=2**{args.log2n}, {msd.n_bins} bins, t={msd.shift}"),
    ]
    table = []
    for name, src, replaces, kern, plain, lib, nbytes, shape in rows:
        agree(name, kern(), plain(), shape)
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, 1, 3),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": cuda_ms(lib), "shape": shape,
        }
        table.append(entry)
        log(f"[time] {name} ({shape}): {entry['ms']:.3f} ms, bound "
            f"{entry['bound_ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, "
            f"library {entry['library_ms']:.3f} ms")
    del d16, d256, sorted_keys, trail, slots

    # the 16b+16b plan's shapes at n = 2**24: 2**16-bin digits, MSD t = 16
    lsd, msd16 = plan16.passes
    rank16 = (fractal_rank_scatter_kernel if lsd.engine == "scatter"
              else fractal_rank_kernel)
    k24 = keys24.view(torch.int32)
    d24 = (k24 >> lsd.shift) & (lsd.n_bins - 1)
    s24 = exclusive_cumsum(fractal_histogram(d24, lsd.n_bins))
    sorted24 = via_cuda.view(torch.int32)
    trail24 = sorted24 & ((1 << msd16.shift) - 1)
    c24 = fractal_histogram((sorted24 >> msd16.shift) & (msd16.n_bins - 1),
                            msd16.n_bins)
    what = f"n=2**{n24.bit_length() - 1}, {lsd.n_bins} bins"
    agree("fractal_histogram", fractal_histogram(d24, lsd.n_bins),
          ref.histogram_ref(d24, lsd.n_bins), what)
    agree(rank16.__name__, rank16(d24, s24, lsd.n_bins),
          ref.rank_ref(d24, s24, lsd.n_bins), what)
    agree("fractal_reconstruct",
          fractal_reconstruct(c24, trail24, msd16.n_bins, msd16.shift),
          ref.reconstruct_ref(c24, trail24, msd16.shift),
          f"{what}, t={msd16.shift}")
    log(f"[kernels] bit-exact against their plain versions at the main "
        f"path's shapes (n=2**{args.log2n} and {what}); max |err| "
        f"{json.dumps(errs)}")
    del k24, d24, sorted24, trail24

    e2e = []
    for p in (32, 16):
        keys = data[(p, "uniform")]
        k64 = u32_to_int64(keys)
        native = keys if p == 16 else k64
        e2e.append({
            "name": f"fractal_sort p={p} uniform",
            "plan": make_sort_plan(n, p).describe(), "n": n,
            "ms": cuda_ms(lambda: fractal_sort(keys, p), 1, 5),
            "torch_sort_ms": cuda_ms(lambda: torch.sort(native), 1, 5),
            "torch_sort_dtype": str(native.dtype),
        })
        log(f"[e2e] {e2e[-1]}")
        del k64, native
    keys = data[(32, "uniform")]
    e2e.append({
        "name": "fractal_sort p=32 uniform, 8-bit scatter plan",
        "plan": plan8.describe(), "n": n,
        "ms": cuda_ms(lambda: fractal_sort(keys, 32, plan=plan8), 1, 5),
    })
    log(f"[e2e] {e2e[-1]}")

    if args.profile:
        log(json.dumps({"profile": profile_sort(
            lambda: fractal_sort(keys, 32)), "card": card}))

    name = torch.cuda.get_device_name(0)
    log(json.dumps({"e2e": e2e, "card": card}))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
