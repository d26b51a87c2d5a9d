"""Distributed fractal sort on the PyTorch port: local histograms, one
all-reduce merge, exact global ranks, one bucketed all-to-all a pass — no
sampling.

    PYTHONPATH=src python examples/torch_distributed_sort.py               # one NCCL rank on the card
    PYTHONPATH=src python examples/torch_distributed_sort.py --device cpu  # 8 gloo ranks

The twin of ``examples/distributed_sort.py``.  With ``--device cpu`` it
spawns ``--ranks`` gloo processes on this host; on the card it runs one
NCCL rank (one process a card).  Each rank sorts its shard of uniform and
zipf(1.2) 16-bit keys collectively, and rank 0 checks the gathered result
against ``np.sort``.
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import distributed_fractal_sort


def sort_cases(rank: int, ranks: int, device: str, init: str) -> None:
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=ranks)
    try:
        rng = np.random.default_rng(0)
        n = 1 << 15
        for name, keys in {
            "uniform": rng.integers(0, 1 << 16, n).astype(np.int32),
            "zipf-skewed": np.clip(rng.zipf(1.2, n), 0, 65535)
            .astype(np.int32),
        }.items():
            s = n // ranks
            mine = torch.from_numpy(keys[rank * s:(rank + 1) * s]).to(device)
            out, overflow = distributed_fractal_sort(mine, None, 16)
            every = [torch.empty_like(out) for _ in range(ranks)]
            dist.all_gather(every, out)
            if rank == 0:
                ok = np.array_equal(torch.cat(every).cpu().numpy(),
                                    np.sort(keys))
                print(f"{name:12s}: sorted={ok} overflow={bool(overflow)} "
                      f"({ranks} shards x {s} keys on {device})")
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: one NCCL rank on the card; cpu: gloo ranks")
    ap.add_argument("--ranks", type=int, default=8,
                    help="gloo ranks with --device cpu (default 8)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    ranks = 1 if args.device == "cuda" else args.ranks
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.spawn(sort_cases, args=(ranks, args.device, init), nprocs=ranks,
                 join=True)


if __name__ == "__main__":
    main()
