"""Quickstart on the PyTorch port: the paper's algorithm end to end.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The twin of ``examples/quickstart.py``:

1. Sort 65k 12-bit keys with the compressed-histogram fractal sort.
2. Stream the same keys in batches through one cached histogram.
3. Query the trie (Algorithms 2/3) without materializing the sorted array.
4. Use the same primitive as an MoE dispatch (the framework integration).

On a CUDA device the sorts and the dispatch run the hand-written kernels;
on the CPU their plain versions.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    build_histogram, fractal_sort, fractal_sort_batched, fractal_sort_stats,
    get_index, get_item, histogram_nbytes, taper_levels, trie_depth,
)
from repro_torch.kernels import ops


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the keys (default cuda)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    n, p = 1 << 16, 12  # small; same code path at any scale
    keys = torch.from_numpy(rng.integers(0, 1 << p, n).astype(np.int32)).to(
        dev)

    # 1. sort
    out = fractal_sort(keys, p, device=dev)
    assert bool((out[1:] >= out[:-1]).all())
    stats = fractal_sort_stats(n, p)
    print(f"sorted {n} keys (p={p}) on {out.device}: "
          f"{stats.bytes_per_key:.1f} analytic bytes/key, trie resident "
          f"bytes = {stats.histogram_bytes}")

    # 2. batch streaming with a cached histogram (paper §III.C/D)
    streamed, hists = fractal_sort_batched(keys, p, num_batches=4,
                                           device=dev)
    assert bool((streamed == out).all())
    print(f"streamed in 4 batches -> identical output; "
          f"{len(hists)} per-batch histograms merged")

    # 3. trie queries (no sorted array needed)
    depth = trie_depth(n, p)
    h = build_histogram(keys, p, depth)
    _, saturated = taper_levels(h, n_hint=n)
    print(f"trie depth {depth}: tapered {histogram_nbytes(h, True, n)} B vs "
          f"wide {histogram_nbytes(h, False, n)} B "
          f"(saturated={bool(saturated)})")
    value = get_item(h, 12345)
    print(f"  value at sorted index 12345: {int(value)}")
    print(f"  first index of that value:   {int(get_index(h, value))}")

    # 4. the same pipeline as MoE dispatch (histogram = expert load, free)
    expert_ids = torch.from_numpy(rng.integers(0, 128, 4096).astype(
        np.int32)).to(dev)
    perm, _, counts = ops.moe_dispatch(expert_ids, 128)
    grouped = expert_ids[perm.long()]
    assert bool((grouped[1:] >= grouped[:-1]).all())
    print(f"moe dispatch: 4096 tokens -> 128 experts, max load "
          f"{int(counts.max())}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
