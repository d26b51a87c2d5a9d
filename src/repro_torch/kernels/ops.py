"""Public entry points over the CUDA kernels.

Port of ``repro.kernels.ops`` for the sort path, MoE dispatch and flash
attention.  On CUDA tensors every function launches the hand-written
kernels; on CPU tensors the wrappers compute their plain versions.  :func:`launch_counts` /
:func:`reset_launch_counts` read and clear the wrappers' launch counters.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.executor import CudaBackend, PlanExecutor, _like_keys
from repro_torch.core.fractal_sort import to_device
from repro_torch.core.sort_plan import make_sort_plan
from repro_torch.kernels.flash_attention import (
    flash_attention_kernel as _flash)
from repro_torch.kernels.fractal_histogram import (
    digit_histograms as _digit_hists, fractal_histogram as _hist,
    fractal_histogram_cluster as _hist_cluster,
    fractal_histogram_digits as _hist_digits)
from repro_torch.kernels.fractal_rank import (
    fractal_rank_digit as _rank_digit, fractal_rank_kernel as _rank,
    fractal_rank_scatter_kernel as _rank_scatter)
from repro_torch.kernels.fractal_reconstruct import (
    fractal_reconstruct as _recon)
from repro_torch.kernels.moe_dispatch import moe_dispatch as _dispatch

__all__ = [
    "flash_attention",
    "histogram",
    "digit_histograms",
    "rank",
    "rank_digit",
    "reconstruct",
    "moe_dispatch",
    "fractal_sort_kernel",
    "fractal_sort_pairs_kernel",
    "launch_counts",
    "reset_launch_counts",
]

#: name -> wrapper, for the launch counters
KERNELS = {
    "fractal_histogram": _hist,
    "fractal_histogram_digits": _hist_digits,
    "fractal_histogram_cluster": _hist_cluster,
    "fractal_rank_kernel": _rank,
    "fractal_rank_scatter_kernel": _rank_scatter,
    "fractal_reconstruct": _recon,
    "flash_attention_kernel": _flash,
}
#: the kernels of the sort path (K1-K4; "fractal_histogram" counts every
#: K1 launch, "fractal_histogram_digits" its one-sweep launches and
#: "fractal_histogram_cluster" its launches above 2**14 bins too); K5
#: runs on the LM's prefill path, and MoE dispatch launches K1 and K2
SORT_KERNELS = ("fractal_histogram", "fractal_histogram_digits",
                "fractal_rank_kernel", "fractal_rank_scatter_kernel",
                "fractal_reconstruct")


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_kv: int = 128):
    return _flash(q, k, v, causal=causal, block_q=block_q, block_kv=block_kv)


def histogram(keys, n_bins: int):
    return _hist(keys, n_bins)


def digit_histograms(keys, passes):
    return _digit_hists(keys, passes)


def rank_digit(keys, digit_pass, block: int = 1024, bin_start=None):
    return _rank_digit(keys, digit_pass, block=block, bin_start=bin_start)


def rank(keys, bin_start, n_bins: int, block: int = 1024):
    return _rank(keys, bin_start, n_bins, block=block)


def reconstruct(counts, trailing, n_bins: int, t_bits: int):
    return _recon(counts, trailing, n_bins, t_bits)


def moe_dispatch(expert_ids, num_experts: int, block: int = 1024):
    return _dispatch(expert_ids, num_experts, block=block)


def fractal_sort_kernel(keys, p: int, block: int = 1024,
                        max_bins_log2: Optional[int] = None, *, device=None):
    """End-to-end kernel-path sort for keys in [0, 2**p), p <= 32: a
    :class:`~repro_torch.core.sort_plan.SortPlan` run by the
    :class:`~repro_torch.core.executor.PlanExecutor` over the
    :class:`~repro_torch.core.executor.CudaBackend` — every pass's counts
    from one histogram sweep, then per LSD pass an exclusive scan, the
    rank kernel and full-key scatter;
    the MSD pass scatters only the trailing-bit entries and the
    reconstruct kernel rebuilds the prefix bits."""
    keys = to_device(keys, device)
    plan = make_sort_plan(keys.shape[0], p, max_bins_log2=max_bins_log2)
    out = PlanExecutor(CudaBackend(block=block)).run(keys, plan)
    return _like_keys(out, keys)


def fractal_sort_pairs_kernel(keys, values, p: int, block: int = 1024,
                              max_bins_log2: Optional[int] = None, *,
                              device=None):
    """Kernel-path key–value sort: the payload rides every pass's scatter
    next to the keys (rank kernel per digit, reconstruct kernel for the
    prefix bits)."""
    keys = to_device(keys, device)
    values = torch.as_tensor(values).to(keys.device)
    plan = make_sort_plan(keys.shape[0], p, max_bins_log2=max_bins_log2)
    out, vals = PlanExecutor(CudaBackend(block=block)).run_pairs(
        keys, values, plan)
    return _like_keys(out, keys), vals
