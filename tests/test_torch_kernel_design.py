"""The numerics and host-side sizing of the redesigned K5, K2 and K1, on the CPU.

K5's fp32 instance runs attention as 3xTF32 tensor-core products: each
operand splits into big = tf32_rna(x) and small = tf32_rna(x - big), and
small*big + big*small + big*big accumulate in fp32.  The CUDA kernel
cannot run here, so a plain-torch emulation of that arithmetic (rounding
on the fp32 bit pattern, the kernel's 64-key tiles and online softmax) is
held against the port's plain version and the JAX package's Pallas kernel
in interpret mode, at the reference's test shapes and the kernel's stated
fp32 tolerance; plain TF32 is shown to miss it.  K2's look-back path is
sized by pure functions: its tile count, status buffer and the switch to
the two-level path above 256 bins.

K2's two-level path (257 to 2**16 bins) is emulated in plain torch with
the kernels' arithmetic: the digit's high byte ranked by a look-back over
tiles from the high bins' dense starts (each valid key's slot in the
stable high-major stream), the low byte ranked the same way over that
stream from zero starts, and rank = bin_start[d] - C[hi][lo] + the low
rank at the key's slot.  The emulation is held bit-exact against the
plain version and the reference's one-hot Pallas kernel (interpret mode),
and its sizing helpers against their formulas.

K1's cluster path (2**14 to 2**16 bins) is emulated the same way: the
grid's threads walk the key stream in the kernel's order, every block of
a cluster walks its cluster's share and adds the keys of its own slice,
equal keys in a row of one thread as one run, and each block's non-zero
counters are added onto the carried counts.  It is held bit-exact against the plain version, the
reference's Pallas K1 (interpret mode) and, at 2**16 bins, the
reference's plain ``histogram_ref``; its layout and grid helpers against
their formulas.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_kernel as jax_flash
from repro.kernels.fractal_histogram import fractal_histogram as jax_histogram
from repro.kernels.fractal_rank import fractal_rank_kernel as jax_rank_onehot
from repro_torch.kernels import ref
from repro_torch.kernels.fractal_histogram import (CLUSTER_SLICE_BITS,
                                                   CLUSTER_THREADS,
                                                   KEYS_PER_THREAD,
                                                   SHARED_MAX_BINS,
                                                   cluster_grid,
                                                   cluster_layout)
from repro_torch.kernels.fractal_rank import (LOOKBACK_MAX_BINS, LOOKBACK_TILE,
                                              WIDE_LO_BITS,
                                              lookback_status_bytes,
                                              lookback_tiles, uses_lookback,
                                              wide_hi_bins,
                                              wide_rank_scratch_bytes)

TOL_F32 = 2e-5  # K5's fp32 tolerance (sums in another order)
SHAPES = [(2, 64, 4, 16, 64), (1, 48, 2, 8, 80), (2, 100, 2, 32, 100)]
KV_TILE = 64  # keys a kv tile of the CUDA kernel


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, on the bit pattern: what ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (mag | (bits & -0x80000000)).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """a @ b from TF32 pieces: small*big + big*small + big*big (3xTF32),
    or big*big alone (terms=1, plain TF32)."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    out = a_big @ b_big
    if terms == 3:
        a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
        out = a_small @ b_big + a_big @ b_small + out
    return out


def emulated_attention(q, k, v, causal: bool, terms: int = 3):
    """The kernel's fp32 arithmetic: 64-key tiles, online softmax with the
    finite -1e30 mask, QK^T and PV as split products."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, S, hd)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, KV_TILE):
        kt, vt = kh[:, :, k0:k0 + KV_TILE], vh[:, :, k0:k0 + KV_TILE]
        s = split_matmul(qh, kt.transpose(-1, -2), terms) * scale
        cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
        if causal:
            s = s.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + split_matmul(p, vt, terms)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3)


def _qkv(seed, shape):
    B, S, H, hd, Skv = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, Skv, H, hd), (B, Skv, H, hd))]


def test_tf32_rounding_emulation():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      1 + 3 * 2 ** -11, 3.0e-7, -1234.5678], dtype=torch.float32)
    got = tf32_rna(x)
    # ties go away from zero; below half an ulp rounds down
    np.testing.assert_array_equal(
        got[:4].numpy(), np.float32([1 + 2 ** -10, 1, -(1 + 2 ** -10),
                                     1 + 2 ** -9]))
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    big = tf32_rna(x)
    rest = x - big
    # big + small keeps about 21 bits of x, against TF32's 11
    err = (big + tf32_rna(rest) - x).abs() / x.abs()
    assert float(err.max()) < 2 ** -20
    assert float(((big - x).abs() / x.abs()).max()) > 2 ** -15


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_attention_within_fp32_tolerance(shape, causal):
    arrs = _qkv(sum(shape) + causal, shape)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    got = emulated_attention(q, k, v, causal).numpy()
    plain = ref.flash_attention_ref(q, k, v, causal=causal).numpy()
    pallas = np.asarray(jax_flash(*(jnp.asarray(a) for a in arrs),
                                  causal=causal, block_q=16, block_kv=32))
    for want in (plain, pallas):
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_tf32_misses_the_fp32_tolerance(shape):
    """Why the kernel pays for three products: one TF32 product a product
    keeps about three digits, far outside 2e-5."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(sum(shape), shape))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    err = (emulated_attention(q, k, v, True, terms=1) - want).abs().max()
    assert float(err) > 10 * TOL_F32


@pytest.mark.parametrize("n,tiles", [(1, 1), (LOOKBACK_TILE - 1, 1),
                                     (LOOKBACK_TILE, 1), (LOOKBACK_TILE + 1, 2),
                                     ((1 << 20) + 37, 129), (1 << 27, 16384)])
def test_lookback_tile_count(n, tiles):
    assert lookback_tiles(n) == tiles


@pytest.mark.parametrize("n,n_bins,nbytes", [
    (1, 1, 16),                          # one word and the counter
    (1 << 27, 16, 8 * (16384 * 16 + 1)),  # 2 MiB at the main path's shape
    (1 << 27, 256, 8 * (16384 * 256 + 1)),
    (LOOKBACK_TILE + 1, 7, 8 * (2 * 7 + 1)),
])
def test_lookback_status_buffer_bytes(n, n_bins, nbytes):
    assert lookback_status_bytes(n, n_bins) == nbytes


@pytest.mark.parametrize("n_bins,lookback", [(1, True), (2, True), (16, True),
                                             (255, True), (256, True),
                                             (257, False), (1 << 16, False)])
def test_lookback_path_switch_at_256_bins(n_bins, lookback):
    assert LOOKBACK_MAX_BINS == 256
    assert uses_lookback(n_bins) is lookback


# --- K2's two-level path above 256 bins ---------------------------------------

LO_BINS = 1 << WIDE_LO_BITS


def tile_ranks(x: torch.Tensor, n_bins: int, tile: int) -> tuple:
    """Each element's rank among the equal elements before it in its tile,
    and every tile's count of each bin; elements outside [0, n_bins) are
    in no bin."""
    n = x.shape[0]
    tiles = max(1, -(-n // tile))
    padded = torch.full((tiles * tile,), -1, dtype=torch.int64)
    padded[:n] = x
    onehot = (padded.view(tiles, tile, 1)
              == torch.arange(n_bins)).to(torch.int64)
    before = torch.cumsum(onehot, 1) - onehot
    return (before * onehot).sum(-1).view(-1)[:n], onehot.sum(1)


def lookback_rank(x: torch.Tensor, start: torch.Tensor, n_bins: int,
                  tile: int) -> torch.Tensor:
    """One look-back sweep: start[bin] + the bin's elements in earlier
    tiles (the carry) + the rank in the tile; 0 outside [0, n_bins)."""
    r, counts = tile_ranks(x, n_bins, tile)
    carry = torch.cumsum(counts, 0) - counts
    t = torch.arange(x.shape[0]) // tile
    b = x.clamp(0, n_bins - 1)
    valid = (x >= 0) & (x < n_bins)
    return torch.where(valid, start[b] + carry[t, b] + r, 0)


def two_level_rank(keys: torch.Tensor, bin_start: torch.Tensor, n_bins: int,
                   tile: int = LOOKBACK_TILE, tail=None) -> torch.Tensor:
    """K2's wide path in plain torch.  ``tail``: what the digit stream
    holds past the valid keys (the kernel leaves it unwritten)."""
    k = keys.to(torch.int64)
    n = k.shape[0]
    n_hi = wide_hi_bins(n_bins)
    # the prep: the high rows' dense starts and base = bin_start - C
    grid = torch.zeros(n_hi * LO_BINS, dtype=torch.int64)
    grid[:n_bins] = ref.histogram_ref(keys, n_bins)
    grid = grid.view(n_hi, LO_BINS)
    rows = grid.sum(1)
    hi_start = torch.cumsum(rows, 0) - rows
    c_before = (torch.cumsum(grid, 0) - grid).reshape(-1)[:n_bins]
    base = bin_start.to(torch.int64) - c_before
    # level 1: a key is valid on its whole digit, then ranked on its high
    # byte; its slot in the stable high-major stream of the valid keys
    valid = (k >= 0) & (k < n_bins)
    hi = torch.where(valid, k >> WIDE_LO_BITS, -1)
    slot = lookback_rank(hi, hi_start, n_hi, tile)
    stream = torch.full((n,), -1, dtype=torch.int64)
    if tail is not None:
        stream = tail.to(torch.int64).clone()
    stream[slot[valid]] = k[valid]
    # level 2: the low byte over that stream from zero starts, plus the
    # digit's base, at each stream slot
    in_range = (stream >= 0) & (stream < n_bins)
    lo = torch.where(in_range, stream & (LO_BINS - 1), -1)
    within = (lookback_rank(lo, torch.zeros(LO_BINS, dtype=torch.int64),
                            LO_BINS, tile)
              + torch.where(in_range, base[stream.clamp(0, n_bins - 1)], 0))
    # the unstaging: each valid key's rank from its stream slot
    return torch.where(valid, within[slot], 0).to(torch.int32)


def _wide_keys(rng, n: int, n_bins: int, dist: str) -> np.ndarray:
    """Digits uniform, zipf(1.2)-skewed or in one bin, with 2 % -1 pads, 2 %
    keys past n_bins that still have a high byte below the high bins
    (where n_bins is not a multiple of 256) and 1 % keys past every high
    bin."""
    if dist == "uniform":
        d = rng.integers(0, n_bins, n)
    elif dist == "zipf":
        d = np.minimum(rng.zipf(1.2, n) - 1, n_bins - 1)
    else:
        d = np.full(n, rng.integers(0, n_bins))
    d = d.astype(np.int64)
    d[rng.random(n) < 0.02] = -1
    past = LO_BINS * wide_hi_bins(n_bins)
    if past > n_bins:
        d[rng.random(n) < 0.02] = rng.integers(n_bins, past)
    d[rng.random(n) < 0.01] = rng.integers(past, 1 << 17)
    return d.astype(np.int32)


@pytest.mark.parametrize("n_bins", [257, 300, 511, 4096])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "one_bin"])
def test_two_level_rank_matches_plain_and_reference_kernel(n_bins, dist):
    """At the high/low split's edges (2, 2, 2 and 16 high bins), on the
    kernel's 8192-key tile (one tile here) and on a 97-key tile (many
    tiles: the carry between them), with non-dense bin starts."""
    rng = np.random.default_rng([n_bins, len(dist)])
    n = 2999
    keys = _wide_keys(rng, n, n_bins, dist)
    start = rng.integers(0, 1 << 20, n_bins).astype(np.int32)
    tk, ts = torch.from_numpy(keys), torch.from_numpy(start)
    want = ref.rank_ref(tk, ts, n_bins)
    pallas = np.asarray(jax_rank_onehot(jnp.asarray(keys), jnp.asarray(start),
                                        n_bins, block=256))
    np.testing.assert_array_equal(want.numpy(), pallas)
    for tile in (LOOKBACK_TILE, 97):
        np.testing.assert_array_equal(
            two_level_rank(tk, ts, n_bins, tile).numpy(), pallas)


@pytest.mark.parametrize("dist", ["uniform", "zipf", "one_bin"])
def test_two_level_rank_at_2_16_bins(dist):
    """256 high bins, each key nearly alone in its digit; against the
    port's plain version and the reference's plain ``rank_ref`` (its
    one-hot kernel would hold a (block, 2**16) tile).  The reference's
    ``rank_ref`` takes in-range keys only, so it ranks the in-range
    subsequence: an out-of-range key moves no other key's rank."""
    rng = np.random.default_rng([16, len(dist)])
    n_bins = 1 << 16
    keys = _wide_keys(rng, 3000, n_bins, dist)
    start = rng.integers(-(1 << 30), 1 << 30, n_bins).astype(np.int32)
    tk, ts = torch.from_numpy(keys), torch.from_numpy(start)
    valid = (keys >= 0) & (keys < n_bins)
    want = np.zeros_like(keys)
    want[valid] = np.asarray(jref.rank_ref(jnp.asarray(keys[valid]),
                                           jnp.asarray(start), n_bins))
    np.testing.assert_array_equal(ref.rank_ref(tk, ts, n_bins).numpy(), want)
    for tile in (LOOKBACK_TILE, 211):
        np.testing.assert_array_equal(
            two_level_rank(tk, ts, n_bins, tile).numpy(), want)


@pytest.mark.parametrize("n_bins", [300, 1 << 16])
def test_two_level_stream_tail_is_never_read(n_bins):
    """The low-digit stream past the valid keys holds whatever the scratch
    held; level 2 ranks it after every valid slot, so no rank moves."""
    rng = np.random.default_rng(n_bins)
    keys = _wide_keys(rng, 2000, n_bins, "uniform")
    keys[rng.random(2000) < 0.2] = -1
    start = torch.from_numpy(rng.integers(0, 1 << 20, n_bins).astype(np.int32))
    tk = torch.from_numpy(keys)
    tail = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 2000))
    got = two_level_rank(tk, start, n_bins, 64, tail=tail)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.rank_ref(tk, start, n_bins).numpy())


@pytest.mark.parametrize("n_bins", [257, 4096, 1 << 16])
def test_level1_stages_each_tile_in_high_runs(n_bins):
    """Level 1's local sort: in each tile the valid keys' staged positions
    (the tile's first slot of their high bin + their rank in it) are a
    permutation of the tile's valid keys, and the run base of each high bin
    (high start + carry - that first slot) plus a key's staged position is
    its look-back slot, so each high bin leaves the tile as one run and
    the unstaging reads its rank from there."""
    rng = np.random.default_rng(n_bins + 1)
    tile, n = 128, 1500
    k = torch.from_numpy(_wide_keys(rng, n, n_bins, "zipf")).to(torch.int64)
    n_hi = wide_hi_bins(n_bins)
    valid = (k >= 0) & (k < n_bins)
    hi = torch.where(valid, k >> WIDE_LO_BITS, -1)
    rows = torch.bincount(hi[valid], minlength=n_hi)
    hi_start = torch.cumsum(rows, 0) - rows
    r, counts = tile_ranks(hi, n_hi, tile)
    carry = torch.cumsum(counts, 0) - counts
    first = torch.cumsum(counts, 1) - counts  # the tile's first slot a bin
    t = torch.arange(n) // tile
    h = hi.clamp(0, n_hi - 1)
    staged = first[t, h] + r
    for i in range(counts.shape[0]):
        mine = valid & (t == i)
        assert sorted(staged[mine].tolist()) == list(range(int(mine.sum())))
    dst = hi_start[h] + carry[t, h] - first[t, h] + staged
    np.testing.assert_array_equal(
        dst[valid].numpy(), lookback_rank(hi, hi_start, n_hi, tile)[valid])
    assert sorted(dst[valid].tolist()) == list(range(int(valid.sum())))


@pytest.mark.parametrize("n_bins,n_hi", [(257, 2), (300, 2), (511, 2),
                                         (512, 2), (513, 3), (4096, 16),
                                         (4097, 17), (1 << 16, 256)])
def test_wide_split_high_bins(n_bins, n_hi):
    """The high byte's bins: up to 16 (n_bins <= 4096) level 1 counts in
    registers, above it matches by ballots; every valid digit's high byte
    is below them, and so is that of a key in [n_bins, 256 * n_hi)."""
    assert wide_hi_bins(n_bins) == n_hi
    assert (n_bins - 1) >> WIDE_LO_BITS == n_hi - 1
    assert (LO_BINS * n_hi - 1) >> WIDE_LO_BITS == n_hi - 1
    assert n_hi <= LOOKBACK_MAX_BINS and not uses_lookback(n_bins)


@pytest.mark.parametrize("n,n_bins,nbytes", [
    # status words 24 -> 32 and 2056 -> 2064, stream and ranks 16 each,
    # runs 12 -> 16, bases 1028 -> 1040, high starts 16, zero starts 1024
    (1, 257, 32 + 2064 + 16 + 16 + 16 + 1040 + 16 + 1024),
    # two tiles, 16 high bins: each status buffer 8 bytes short of 16
    (LOOKBACK_TILE + 1, 4096, (8 * (2 * 16 + 1) + 8) + (8 * (2 * 256 + 1) + 8)
     + 2 * 4 * (LOOKBACK_TILE + 4) + 144 + 4 * 4096 + 64 + 1024),
    # 2**27 keys: 64 MiB of status words (the old table and its scan were
    # 1 GiB), 1 GiB of stream and ranks, 16 MiB of runs, 256 KiB of bases
    (1 << 27, 1 << 16, 2 * (8 * (16384 * 256 + 1) + 8) + (1 << 30)
     + 4 * 16384 * 257 + (1 << 18) + 1024 + 1024),
])
def test_wide_rank_scratch_bytes(n, n_bins, nbytes):
    assert wide_rank_scratch_bytes(n, n_bins) == nbytes
    assert nbytes % 16 == 0


# --- K1's cluster path above 2**14 bins ---------------------------------------


def cluster_slices(n_bins: int) -> list:
    """The bins each block of a cluster counts, in block order."""
    cluster, bits = cluster_layout(n_bins)
    return [min(1 << bits, n_bins - (r << bits)) for r in range(cluster)]


def thread_streams(n: int, head: int, threads: int) -> list:
    """The key positions each thread of a grid of ``threads`` visits, in
    its order: for_each_key's 16-byte vectors past the ``head`` unaligned
    keys, two a step (the second ``threads`` vectors on), then a head key
    and a tail key."""
    nvec = (n - head) // 4
    tail = head + 4 * nvec
    streams = []
    for t in range(threads):
        mine = []
        for v in range(t, nvec, 2 * threads):
            for u in (v, v + threads):
                if u < nvec:
                    mine += range(head + 4 * u, head + 4 * u + 4)
        if t < head:
            mine.append(t)
        if t < n - tail:
            mine.append(tail + t)
        streams.append(mine)
    return streams


def cluster_histogram(keys: torch.Tensor, n_bins: int, init=None,
                      clusters: int = 3, block_threads: int = 4,
                      head: int = 0) -> tuple:
    """The cluster path in plain torch: the stream dealt to ``clusters``
    units of ``block_threads`` threads as for_each_key deals it; every
    block of a cluster walks each of the unit's thread streams and adds
    the valid keys of its own slice (key >> CLUSTER_SLICE_BITS is its
    rank), equal keys in a row (its other keys between them aside) as one
    run; then each block's non-zero counters are added onto ``init``.
    Returns (counts, shared atomics, device atomics)."""
    cluster, bits = cluster_layout(n_bins)
    k = keys.to(torch.int64).tolist()
    streams = thread_streams(len(k), head, clusters * block_threads)
    slices = torch.zeros((clusters, cluster, 1 << bits), dtype=torch.int64)
    shared = 0
    for t, stream in enumerate(streams):
        unit = t // block_threads
        for rank in range(cluster):
            runs = []
            for key in (k[i] for i in stream):
                if not 0 <= key < n_bins or key >> bits != rank:
                    continue  # ends no run
                if runs and runs[-1][0] == key:
                    runs[-1][1] += 1
                else:
                    runs.append([key, 1])
            for key, run in runs:
                slices[unit, rank, key & ((1 << bits) - 1)] += run
            shared += len(runs)
    out = (torch.zeros(n_bins, dtype=torch.int64) if init is None
           else init.to(torch.int64).clone())
    flat = slices.view(clusters, -1)[:, :n_bins]
    out += flat.sum(0)
    return out.to(torch.int32), shared, int((flat != 0).sum())


def _k1_keys(rng, n: int, n_bins: int, dist: str) -> np.ndarray:
    """Digits uniform, zipf(1.2)-skewed or in one bin, with 2 % -1 pads and
    2 % n_bins pads, and 1 % keys in [n_bins, 2**17)."""
    if dist == "uniform":
        d = rng.integers(0, n_bins, n)
    elif dist == "zipf":
        d = np.minimum(rng.zipf(1.2, n) - 1, n_bins - 1)
    else:
        d = np.full(n, rng.integers(0, n_bins))
    d[rng.random(n) < 0.02] = -1
    d[rng.random(n) < 0.02] = n_bins
    d[rng.random(n) < 0.01] = rng.integers(n_bins, 1 << 17)
    return d.astype(np.int32)


@pytest.mark.parametrize("n_bins", [(1 << 14) + 1, 20_000, 1 << 15])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "one_bin"])
def test_cluster_histogram_matches_plain_and_reference_kernel(n_bins, dist):
    """One block a cluster (a slice of up to 2**15 bins, short below it),
    with and without carried counts, against the plain version and the
    reference's Pallas K1 (interpret mode, block 256)."""
    rng = np.random.default_rng([n_bins, len(dist)])
    keys = _k1_keys(rng, 2999, n_bins, dist)
    init = rng.integers(0, 1000, n_bins).astype(np.int32)
    tk = torch.from_numpy(keys)
    for carried in (None, init):
        pallas = np.asarray(jax_histogram(
            jnp.asarray(keys), n_bins, block=256,
            init=None if carried is None else jnp.asarray(carried)))
        ti = None if carried is None else torch.from_numpy(carried)
        np.testing.assert_array_equal(
            ref.histogram_ref(tk, n_bins, init=ti).numpy(), pallas)
        got, _, _ = cluster_histogram(tk, n_bins, init=ti, head=3)
        np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("n_bins", [3 * (1 << 14) + 3, (1 << 16) - 1,
                                    1 << 16])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "one_bin"])
def test_cluster_histogram_at_2_16_bins(n_bins, dist):
    """Two blocks a cluster (the second slice short below 2**16), against
    the port's plain version and the reference's plain ``histogram_ref``
    (its one-hot kernel would hold a (block, n_bins) tile), which counts
    in-range keys only."""
    rng = np.random.default_rng([n_bins, len(dist), 1])
    keys = _k1_keys(rng, 3000, n_bins, dist)
    init = rng.integers(0, 1000, n_bins).astype(np.int32)
    valid = keys[(keys >= 0) & (keys < n_bins)]
    tk = torch.from_numpy(keys)
    for carried in (None, init):
        want = np.asarray(jref.histogram_ref(jnp.asarray(valid), n_bins))
        if carried is not None:
            want = want + carried
        ti = None if carried is None else torch.from_numpy(carried)
        np.testing.assert_array_equal(
            ref.histogram_ref(tk, n_bins, init=ti).numpy(), want)
        got, _, _ = cluster_histogram(tk, n_bins, init=ti,
                                      head=2 if carried is None else 0)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dist,most", [("uniform", 1.0), ("zipf", 1.0),
                                       ("one_bin", 0.05)])
def test_cluster_runs_and_flush_atomics(dist, most):
    """Runs of equal keys cut a skewed digit's shared atomics (one bin:
    one atomic a thread), and the flush's device atomics (one a non-zero
    counter of a cluster) never outnumber the valid keys."""
    rng = np.random.default_rng(len(dist))
    n_bins = 1 << 16
    keys = _k1_keys(rng, 3000, n_bins, dist)
    valid = int(((keys >= 0) & (keys < n_bins)).sum())
    got, shared, device = cluster_histogram(torch.from_numpy(keys), n_bins,
                                            clusters=2, block_threads=8)
    np.testing.assert_array_equal(
        got.numpy(), ref.histogram_ref(torch.from_numpy(keys), n_bins).numpy())
    assert shared <= most * valid
    assert device <= shared <= valid


def test_thread_streams_visit_every_key_once():
    """for_each_key's order covers the head, the vector body (ragged in
    its last step) and the tail, each key once."""
    for n, head, threads in ((0, 0, 4), (3, 3, 4), (37, 1, 2), (300, 2, 7)):
        streams = thread_streams(n, min(head, n), threads)
        assert sorted(i for s in streams for i in s) == list(range(n))


@pytest.mark.parametrize("n_bins,cluster,slices", [
    ((1 << 14) + 1, 1, [(1 << 14) + 1]),
    (20_000, 1, [20_000]),
    (1 << 15, 1, [1 << 15]),
    (3 * (1 << 14) + 3, 2, [1 << 15, (1 << 14) + 3]),
    ((1 << 16) - 1, 2, [1 << 15, (1 << 15) - 1]),
    (1 << 16, 2, [1 << 15, 1 << 15]),
])
def test_cluster_layout(n_bins, cluster, slices):
    """Blocks a cluster and each block's bins: a 2**15-counter slice a
    block (128 KiB of shared memory: one block an SM beside the
    kernel's 1024 threads), only the last slice short."""
    assert SHARED_MAX_BINS == 1 << 14 and CLUSTER_SLICE_BITS == 15
    assert cluster_layout(n_bins) == (cluster, CLUSTER_SLICE_BITS)
    assert cluster_slices(n_bins) == slices
    assert sum(slices) == n_bins
    assert 4 << CLUSTER_SLICE_BITS == 128 * 1024
    assert ((n_bins - 1) >> CLUSTER_SLICE_BITS) == cluster - 1


@pytest.mark.parametrize("n_bins", [1, 16, 1 << 14, (1 << 16) + 1])
def test_cluster_layout_only_above_the_shared_path(n_bins):
    with pytest.raises(ValueError):
        cluster_layout(n_bins)


PER_CLUSTER = CLUSTER_THREADS * KEYS_PER_THREAD  # 16,384 keys


@pytest.mark.parametrize("n,max_clusters,clusters", [
    (1, 66, 1),
    (PER_CLUSTER, 66, 1),
    (PER_CLUSTER + 1, 66, 2),
    # the device store's partition sorts: 254,200 keys, 16 clusters
    (254_200, 66, 16),
    # the distributed pass: one wave
    (1 << 27, 66, 66),
    (1 << 27, 132, 132),
])
def test_cluster_grid(n, max_clusters, clusters):
    """One wave at most, and at least CLUSTER_THREADS * KEYS_PER_THREAD
    keys a cluster (each of its blocks reads all of them), so a block's
    flush is no more device atomics than its keys."""
    assert cluster_grid(n, max_clusters) == clusters
    assert clusters == 1 or n > (clusters - 1) * PER_CLUSTER


def test_cluster_grid_refuses_a_card_without_room():
    with pytest.raises(RuntimeError):
        cluster_grid(1 << 20, 0)
