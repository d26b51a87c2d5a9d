"""K1: digit histogram — wrapper over ``csrc/fractal_histogram.cu``.

Port of ``repro.kernels.fractal_histogram``.  :func:`fractal_histogram`
bincounts an int32 digit stream over ``[0, n_bins)`` onto carried counts
(``init``, the streaming accumulation of paper §III.D); values outside the
range are ignored.  :func:`fractal_histogram_digits` is K1's second entry:
every digit of a sort plan counted in one read of the key stream (a
digit's histogram does not change when the keys are permuted, so a sort
takes every pass's counts from it before the pass loop).
:func:`digit_histograms` is the multi-digit driver: one sweep when the
plan's digits fit in shared memory (:func:`sweep_eligible`), else one
single-digit launch per digit.  On a CPU tensor each wrapper computes the
plain version (:mod:`~repro_torch.kernels.ref`); on a CUDA tensor it
launches the kernel or raises.

:func:`fractal_histogram` counts in registers up to 16 bins and in
shared sub-histograms up to :data:`SHARED_MAX_BINS`; wider digits (up to
2**16 bins) take the cluster path: the bins are cut into slices of
2**:data:`CLUSTER_SLICE_BITS` counters, one a block's shared memory, and
a thread-block cluster of one block a slice (:func:`cluster_layout`)
reads its share of the stream once from device memory, each block
counting the keys of its own slice; only each block's non-zero counts
reach the output by device atomics.  Its grid is one wave of clusters
(:func:`cluster_grid`), and its launches count on
:func:`fractal_histogram_cluster` too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.fractal_tree import as_u32_bits
from repro_torch.kernels import _build, ref

__all__ = ["CLUSTER_SLICE_BITS", "CLUSTER_THREADS", "SHARED_MAX_BINS",
           "SWEEP_GROUP_BITS", "SWEEP_MAX_BINS", "cluster_grid",
           "cluster_layout", "fractal_histogram",
           "fractal_histogram_cluster", "fractal_histogram_digits",
           "digit_histograms", "sweep_eligible", "sweep_groups"]

_MAX_BINS = 1 << 16

#: The widest digit counted in one block's shared sub-histograms; wider
#: ones take the cluster path, whose blocks each hold a slice of
#: 2**CLUSTER_SLICE_BITS counters (128 KiB of shared memory).
SHARED_MAX_BINS = 1 << 14
CLUSTER_SLICE_BITS = 15
#: threads a block of the cluster path, and the least keys a thread before
#: its grid is capped (the kernel's kClusterThreads and kKeysPerThread)
CLUSTER_THREADS = 1024
KEYS_PER_THREAD = 16

#: The sweep's limits: the plan's bins summed (its per-digit counts and
#: the joint histograms each fit in one block's shared memory), the widest
#: group of adjacent digits counted as one joint digit (one shared atomic
#: a key for the group), and the kernel's most digits and groups.
SWEEP_MAX_BINS = 1 << 14
SWEEP_GROUP_BITS = 12
SWEEP_MAX_DIGITS = 32
SWEEP_MAX_GROUPS = 8


@functools.cache
def _lib():
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    return _build.library("fractal_histogram", {
        "fs_histogram": [vp, ll, vp, i, vp],
        "fs_histogram_cluster": [vp, ll, vp, i, i, i, i, vp],
        "fs_histogram_cluster_capacity": [i, i, ip],
        "fs_histogram_digits": [vp, ll, vp, i, ip, ip, ip, vp],
    })


def cluster_layout(n_bins: int) -> tuple:
    """The cluster path's shape for ``n_bins`` above
    :data:`SHARED_MAX_BINS`: (blocks a cluster, bits of a block's slice).
    Block r holds bins ``[r << bits, (r + 1) << bits)``; the last block's
    slice is short where ``n_bins`` is not a multiple of ``1 << bits``."""
    if not SHARED_MAX_BINS < n_bins <= _MAX_BINS:
        raise ValueError(f"n_bins={n_bins} is not a cluster-path width "
                         f"({SHARED_MAX_BINS + 1}..{_MAX_BINS})")
    return -(-n_bins >> CLUSTER_SLICE_BITS), CLUSTER_SLICE_BITS


def cluster_grid(n: int, max_clusters: int) -> int:
    """Clusters for ``n`` keys: one wave (at most ``max_clusters``, what
    the card runs at once), and no more than one a
    ``CLUSTER_THREADS * KEYS_PER_THREAD`` keys (every block of a cluster
    reads all of the cluster's keys), so that a block's flush (one device
    atomic a non-zero counter) is never more atomics than its keys."""
    if max_clusters < 1:
        raise RuntimeError("no cluster of the histogram's shape fits the card")
    return max(1, min(max_clusters,
                      -(-n // (CLUSTER_THREADS * KEYS_PER_THREAD))))


@functools.cache
def _max_clusters(cluster: int, bits: int) -> int:
    """What the card runs at once of the cluster kernel at this shape."""
    got = ctypes.c_int(0)
    _build.check(_lib().fs_histogram_cluster_capacity(
        cluster, bits, ctypes.byref(got)), "fractal_histogram_cluster")
    return got.value


def fractal_histogram(keys: torch.Tensor, n_bins: int,
                      init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leaf counts (bincount) of the int32 ``keys`` over ``[0, n_bins)``,
    added onto ``init`` when given."""
    if keys.device.type == "cpu":
        return ref.histogram_ref(keys, n_bins, init=init)
    if not 1 <= n_bins <= _MAX_BINS:
        raise ValueError(f"n_bins={n_bins} out of range (1..{_MAX_BINS})")
    _build.check_operand(keys, "keys")
    out = torch.empty((n_bins,), dtype=torch.int32, device=keys.device)
    if init is None:
        out.zero_()
    else:
        _build.check_operand(init, "init", n_bins)
        out.copy_(init)
    n = keys.shape[0]
    if n:
        if n_bins <= SHARED_MAX_BINS:
            _build.check(_lib().fs_histogram(
                keys.data_ptr(), n, out.data_ptr(), n_bins,
                _build.stream(keys.device)), "fractal_histogram")
        else:
            fractal_histogram_cluster(keys, out)
        _build.count_launch(fractal_histogram)
    return out


fractal_histogram.launches = 0


def fractal_histogram_cluster(keys: torch.Tensor, out: torch.Tensor) -> None:
    """Add the bincount of the int32 CUDA ``keys`` over
    ``[0, out.shape[0])`` onto ``out`` in place by the cluster path
    (``SHARED_MAX_BINS < out.shape[0] <= 2**16``), the launch that
    :func:`fractal_histogram` makes for such widths.  Checks nothing the
    caller has checked; a launch counts here (``.launches``)."""
    n_bins = out.shape[0]
    cluster, bits = cluster_layout(n_bins)
    clusters = cluster_grid(keys.shape[0], _max_clusters(cluster, bits))
    _build.check(_lib().fs_histogram_cluster(
        keys.data_ptr(), keys.shape[0], out.data_ptr(), n_bins, cluster, bits,
        clusters, _build.stream(keys.device)), "fractal_histogram_cluster")
    _build.count_launch(fractal_histogram_cluster)


fractal_histogram_cluster.launches = 0


def sweep_groups(passes) -> Optional[tuple]:
    """The joint group of each digit in one sweep, or None when the plan
    does not fit the sweep (its bins summed above :data:`SWEEP_MAX_BINS`,
    or more digits or groups than the kernel takes).

    Digits are grouped greedily in plan order while a group's bits (its
    lowest to highest digit bit) span at most :data:`SWEEP_GROUP_BITS`;
    the groups' joint histograms together stay within
    :data:`SWEEP_MAX_BINS` counters, else every digit is its own group."""
    passes = tuple(passes)
    if (not passes or len(passes) > SWEEP_MAX_DIGITS
            or sum(dp.n_bins for dp in passes) > SWEEP_MAX_BINS):
        return None
    groups, spans = [], []
    for dp in passes:
        lo, hi = dp.shift, dp.shift + dp.bits
        if spans:
            glo, ghi = spans[-1]
            if max(ghi, hi) - min(glo, lo) <= SWEEP_GROUP_BITS:
                spans[-1] = (min(glo, lo), max(ghi, hi))
                groups.append(len(spans) - 1)
                continue
        spans.append((lo, hi))
        groups.append(len(spans) - 1)
    if sum(1 << (hi - lo) for lo, hi in spans) > SWEEP_MAX_BINS:
        groups = list(range(len(passes)))
    if max(groups) >= SWEEP_MAX_GROUPS:
        return None
    return tuple(groups)


def sweep_eligible(passes) -> bool:
    """Whether :func:`digit_histograms` counts ``passes`` in one sweep
    (else one single-digit launch per digit)."""
    return sweep_groups(passes) is not None


def fractal_histogram_digits(keys: torch.Tensor, passes,
                             init=None) -> tuple:
    """Every digit's histogram from one read of the (uint32) key stream:
    the bincount of each pass's ``bits``-wide digit at ``shift``, each
    added onto the matching entry of ``init`` (one counts tensor per
    pass) when given.  Raises unless :func:`sweep_eligible`.  Returns a
    tuple of ``(2**bits,)`` int32 tensors, plan order (views of one
    buffer).  A launch counts as one of K1's (``fractal_histogram
    .launches``) and one of this entry's."""
    passes = tuple(passes)
    u = as_u32_bits(keys)
    if u.device.type == "cpu":
        return ref.digit_histograms_ref(u, passes, init=init)
    groups = sweep_groups(passes)
    if groups is None:
        raise ValueError(f"{len(passes)} digits of {[dp.bits for dp in passes]} "
                         f"bits do not fit one sweep; use digit_histograms")
    _build.check_operand(u, "keys")
    sizes = [dp.n_bins for dp in passes]
    out = torch.empty((sum(sizes),), dtype=torch.int32, device=u.device)
    if init is None:
        out.zero_()
    else:
        for dp, carried in zip(passes, init):
            _build.check_operand(carried, "init", dp.n_bins)
        torch.cat(tuple(init), out=out)
    n = u.shape[0]
    if n:
        arr = ctypes.c_int * len(passes)
        _build.check(_lib().fs_histogram_digits(
            u.data_ptr(), n, out.data_ptr(), len(passes),
            arr(*(dp.shift for dp in passes)),
            arr(*(dp.bits for dp in passes)), arr(*groups),
            _build.stream(u.device)), "fractal_histogram_digits")
        _build.count_launch(fractal_histogram)
        _build.count_launch(fractal_histogram_digits)
    return tuple(out.split(sizes))


fractal_histogram_digits.launches = 0


def digit_histograms(keys: torch.Tensor, passes, init=None):
    """One leaf histogram per :class:`~repro_torch.core.sort_plan.DigitPass`:
    the bincount of each pass's ``bits``-wide digit at ``shift`` of the
    (uint32) key stream, each added onto the matching entry of ``init``
    (one counts tensor per pass) when given.  One sweep
    (:func:`fractal_histogram_digits`) when the plan fits it; wider plans
    (the 16b+16b plan's 2 x 2**16 bins) take one single-digit K1 launch
    per digit.  Returns a tuple of ``(2**bits,)`` int32 tensors, plan
    order."""
    passes = tuple(passes)
    if sweep_eligible(passes):
        return fractal_histogram_digits(keys, passes, init=init)
    u = as_u32_bits(keys)
    if init is None:
        init = (None,) * len(passes)
    return tuple(
        fractal_histogram(((u >> dp.shift) & (dp.n_bins - 1)).contiguous(),
                          dp.n_bins, init=carried)
        for dp, carried in zip(passes, init))
