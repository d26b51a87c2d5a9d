"""The hand-written CUDA kernels of ``repro_torch`` on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU (a CUDA kernel has no CPU mode; the CPU tests hold the kernels'
plain versions against the JAX reference instead).  The module imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import query as tq
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import (CudaBackend, DigitPass, PlanExecutor,
                              TorchBackend, dispatch, fractal_argsort,
                              fractal_sort, fractal_sort_batched,
                              fractal_sort_pairs, make_sort_plan)
from repro_torch.kernels import fractal_histogram as hist_mod
from repro_torch.kernels import fractal_rank as rank_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.fractal_histogram import (digit_histograms,
                                                   fractal_histogram,
                                                   fractal_histogram_digits,
                                                   sweep_eligible)
from repro_torch.kernels.fractal_rank import (fractal_rank_kernel,
                                              fractal_rank_scatter_kernel)
from repro_torch.kernels.fractal_reconstruct import fractal_reconstruct
from repro_torch.models import layers as L

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _empty_autotune_cache(tmp_path, monkeypatch):
    """All-defaults sorts resolve their plan through the autotune cache:
    an empty one gives the static plans, whatever cache the machine
    holds."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n_bins", [16, 256, 1 << 16])
def test_kernels_match_plain_versions(rng, cuda_device, n_bins):
    """Digits with −1 and n_bins pads mixed in; injected bin starts; a
    carried histogram; reconstruct of the sorted digits."""
    n = 100_003
    d = rng.integers(-1, n_bins + 1, n).astype(np.int32)
    keys = torch.from_numpy(d).to(cuda_device)
    start = torch.from_numpy(rng.integers(0, 1 << 20, n_bins).astype(np.int32)
                             ).to(cuda_device)
    init = torch.from_numpy(rng.integers(0, 9, n_bins).astype(np.int32)
                            ).to(cuda_device)
    assert torch.equal(fractal_histogram(keys, n_bins, init=init),
                       ref.histogram_ref(keys, n_bins, init=init))
    want = ref.rank_ref(keys, start, n_bins)
    assert torch.equal(fractal_rank_kernel(keys, start, n_bins), want)
    assert torch.equal(fractal_rank_scatter_kernel(keys, start, n_bins), want)
    s = torch.sort(keys.clamp(0, n_bins - 1)).values
    counts = ref.histogram_ref(s, n_bins)
    assert torch.equal(
        fractal_reconstruct(counts, torch.zeros_like(s), n_bins, 0), s)


def _digits(rng, n, n_bins, dist):
    """Digit streams: uniform, zipf(1.2)-skewed, all in one bin; 2 % are
    -1 and n_bins pads."""
    if dist == "uniform":
        d = rng.integers(0, n_bins, n)
    elif dist == "zipf":
        d = np.minimum(rng.zipf(1.2, n) - 1, n_bins - 1)
    else:
        d = np.full(n, rng.integers(0, n_bins))
    d = d.astype(np.int32)
    d[rng.random(n) < 0.01] = -1
    d[rng.random(n) < 0.01] = n_bins
    return d


@pytest.mark.parametrize("n_bins", [1, 2, 16, 256, 257])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "one_bin"])
def test_rank_lookback_matches_plain_version(rng, cuda_device, n_bins, dist):
    """Across the look-back tile (8192 keys) boundaries, on skewed keys and
    with pads; 257 bins takes the two-level path."""
    for n in (1, 4095, 8191, 8192, 8193, 3 * 8192 + 5, 100_003):
        keys = torch.from_numpy(_digits(rng, n, n_bins, dist)).to(cuda_device)
        start = torch.from_numpy(
            rng.integers(0, 1 << 20, n_bins).astype(np.int32)).to(cuda_device)
        assert torch.equal(fractal_rank_kernel(keys, start, n_bins),
                           ref.rank_ref(keys, start, n_bins)), n


def test_rank_lookback_unaligned_keys(rng, cuda_device):
    """A digit stream that starts off a 16-byte boundary stages its tiles
    element by element."""
    base = torch.from_numpy(rng.integers(0, 16, 20_001).astype(np.int32)
                            ).to(cuda_device)
    keys = base[1:]
    start = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    assert keys.data_ptr() % 16 != 0
    assert torch.equal(fractal_rank_kernel(keys, start, 16),
                       ref.rank_ref(keys, start, 16))


@pytest.mark.parametrize("n_bins,table", [(16, False), (256, False),
                                          (257, True), (1 << 16, True)])
def test_rank_table_walk_only_above_256_bins(rng, cuda_device, monkeypatch,
                                             n_bins, table):
    """Up to 256 bins K2 is the one look-back launch; above, the one
    two-level entry (prep, two look-back levels, gather): no count walk,
    no per-tile table, and the launch counter adds one either way."""
    lib = rank_mod._lib()
    called = []

    class Recorder:
        def __getattr__(self, name):
            called.append(name)
            return getattr(lib, name)

    monkeypatch.setattr(rank_mod, "_lib", Recorder)
    keys = torch.from_numpy(rng.integers(0, n_bins, 50_000).astype(np.int32)
                            ).to(cuda_device)
    start = torch.zeros(n_bins, dtype=torch.int32, device=cuda_device)
    before = fractal_rank_kernel.launches
    got = fractal_rank_kernel(keys, start, n_bins)
    assert fractal_rank_kernel.launches == before + 1
    assert torch.equal(got, ref.rank_ref(keys, start, n_bins))
    want = ["fs_rank_wide"] if table else ["fs_rank_lookback"]
    assert called == want


def _wide_digits(rng, n, n_bins, dist):
    """``_digits``' streams plus 1 % keys in [n_bins, 256 * n_hi): a high
    byte below the two-level path's high bins but no digit."""
    d = _digits(rng, n, n_bins, dist)
    past = 256 * rank_mod.wide_hi_bins(n_bins)
    if past > n_bins:
        d[rng.random(n) < 0.01] = rng.integers(n_bins, past)
    return d


@pytest.mark.parametrize("n_bins", [257, 300, 511, 4096, 4097, 1 << 16])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "one_bin"])
@pytest.mark.parametrize("given", [False, True])
def test_rank_two_level_matches_plain_version(rng, cuda_device, n_bins, dist,
                                              given):
    """K2 above 256 bins across the 8192-key tile edges, at the high/low
    split's edges (2, 2, 2, 16 and 17 high bins, 256 at 2**16), on skewed
    keys with -1, n_bins and valid-high-byte pads, from non-dense bin
    starts, with the digit's counts given (as a sort passes them) or
    counted by the wrapper."""
    for n in (1, 4095, 8191, 8192, 8193, 3 * 8192 + 5, 100_003):
        keys = torch.from_numpy(_wide_digits(rng, n, n_bins, dist)).to(
            cuda_device)
        start = torch.from_numpy(
            rng.integers(0, 1 << 20, n_bins).astype(np.int32)).to(cuda_device)
        counts = ref.histogram_ref(keys, n_bins) if given else None
        before = fractal_rank_kernel.launches
        got = fractal_rank_kernel(keys, start, n_bins, counts=counts)
        assert fractal_rank_kernel.launches == before + 1
        assert torch.equal(got, ref.rank_ref(keys, start, n_bins)), n


@pytest.mark.parametrize("n_bins,off", [(300, 1), (4096, 2), (1 << 16, 3)])
def test_rank_two_level_unaligned_keys(rng, cuda_device, n_bins, off):
    """A digit stream off a 16-byte boundary: level 1 stages its tiles
    element by element and the gather moves 4 bytes at a time."""
    base = torch.from_numpy(_wide_digits(rng, 50_001 + off, n_bins,
                                         "uniform")).to(cuda_device)
    keys = base[off:]
    start = torch.from_numpy(rng.integers(0, 1 << 20, n_bins).astype(
        np.int32)).to(cuda_device)
    assert keys.data_ptr() % 16 != 0
    assert torch.equal(fractal_rank_kernel(keys, start, n_bins),
                       ref.rank_ref(keys, start, n_bins))


def test_rank_two_level_edge_streams(rng, cuda_device):
    """No keys, only pads (no valid key enters the stream), and a long
    2**16-bin stream of 2**22 keys."""
    n_bins = 1 << 16
    start = torch.from_numpy(rng.integers(0, 1 << 20, n_bins).astype(
        np.int32)).to(cuda_device)
    empty = torch.empty(0, dtype=torch.int32, device=cuda_device)
    assert fractal_rank_kernel(empty, start, n_bins).shape == (0,)
    pads = torch.full((20_000,), -1, dtype=torch.int32, device=cuda_device)
    pads[::3] = n_bins
    assert not bool(fractal_rank_kernel(pads, start, n_bins).any())
    keys = torch.from_numpy(_wide_digits(rng, 1 << 22, n_bins, "zipf")).to(
        cuda_device)
    counts = fractal_histogram(keys, n_bins)
    assert torch.equal(fractal_rank_kernel(keys, start, n_bins, counts=counts),
                       ref.rank_ref(keys, start, n_bins))


def test_sort_entry_points_launch_the_kernels(rng, cuda_device):
    keys = rng.integers(0, 1 << 32, 300_001, dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(keys).to(cuda_device)
    order = np.argsort(keys, kind="stable")
    ops.reset_launch_counts()
    out = fractal_sort(t, 32)
    assert out.dtype == torch.uint32
    np.testing.assert_array_equal(out.cpu().numpy(), np.sort(keys))
    sk, sv = fractal_sort_pairs(
        t, torch.arange(len(keys), dtype=torch.int32, device=cuda_device), 32)
    np.testing.assert_array_equal(sv.cpu().numpy(), order)
    plan = make_sort_plan(len(keys), 32, max_bins_log2=8, engine="scatter")
    perm = fractal_argsort(t, 32, plan=plan)
    np.testing.assert_array_equal(perm.cpu().numpy(), order)
    np.testing.assert_array_equal(
        ops.fractal_sort_kernel(t, 32).cpu().numpy(), np.sort(keys))
    counts = ops.launch_counts()
    assert all(counts[name] > 0 for name in ops.SORT_KERNELS), counts


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    keys = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    start = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        fractal_histogram(keys.to(torch.int64), 16)
    with pytest.raises(ValueError):  # not contiguous
        fractal_histogram(torch.zeros(128, dtype=torch.int32,
                                      device=cuda_device)[::2], 16)
    with pytest.raises(ValueError):  # bin_start of the wrong length
        fractal_rank_kernel(keys, start[:8], 16)
    with pytest.raises(ValueError):  # K3 sorts digits of at most 16 bits
        fractal_rank_scatter_kernel(
            keys, torch.zeros((1 << 16) + 1, dtype=torch.int32,
                              device=cuda_device), (1 << 16) + 1)
    with pytest.raises(ValueError):  # 2 x 2**16 bins do not fit one sweep
        fractal_histogram_digits(keys, (DigitPass(0, 16), DigitPass(16, 16)))
    with pytest.raises(ValueError):  # a CPU operand next to a CUDA one
        fractal_histogram(keys, 16, init=torch.zeros(16, dtype=torch.int32))


@pytest.mark.parametrize("shape", [(2, 100, 2, 32, 100), (1, 70, 3, 64, 129),
                                   (2, 33, 2, 96, 65), (1, 130, 2, 128, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_oracle(rng, cuda_device, shape, dtype,
                                               causal):
    """f32 2e-5 (sums in another order), bf16 2e-2 (the inputs' precision)."""
    B, S, H, hd, Skv = shape
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((B, S, H, hd), (B, Skv, H, hd), (B, Skv, H, hd)))
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(
        q, k, v, causal=causal).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["sq1", "skv_lt_sq", "hd8", "hd80",
                                  "strided_q", "odd_hd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_edge_shapes(rng, cuda_device, case, dtype,
                                            causal):
    """One query row, more queries than keys, hd 8 and 80 (zero-padded to
    the fragment depth), a q that is a strided slice of a wider tensor,
    and an hd that takes the element-wise loads."""
    B, Sq, H, hd, Skv = {"sq1": (2, 1, 3, 64, 70),
                         "skv_lt_sq": (1, 150, 2, 64, 40),
                         "hd8": (2, 77, 2, 8, 77), "hd80": (1, 90, 2, 80, 130),
                         "strided_q": (2, 65, 2, 64, 65),
                         "odd_hd": (1, 33, 2, 20, 47)}[case]

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(cuda_device, dtype)

    if case == "strided_q":  # q is heads [1:3] of a 4-head tensor, hd [0:64)
        q = rand(B, Sq, H + 2, hd + 16)[:, :, 1:1 + H, :hd]
        assert not q.is_contiguous()
    else:
        q = rand(B, Sq, H, hd)
    k, v = rand(B, Skv, H, hd), rand(B, Skv, H, hd)
    got = flash_attention_kernel(q, k, v, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(
        q, k, v, causal=causal).float(), rtol=tol, atol=tol)


def test_flash_attention_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    q = torch.zeros(1, 8, 2, 16, device=cuda_device)
    with pytest.raises(ValueError):  # a CPU operand next to CUDA ones
        flash_attention_kernel(q, q.cpu(), q)
    wide = torch.zeros(1, 8, 2, 192, device=cuda_device)
    with pytest.raises(ValueError):  # hd > 128
        flash_attention_kernel(wide, wide, wide)
    ints = torch.zeros(1, 8, 2, 16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention_kernel(ints, ints, ints)
    with pytest.raises(TypeError):  # k in another dtype than q
        flash_attention_kernel(q, q.bfloat16(), q)


def test_attn_apply_launches_the_kernel(cuda_device):
    cfg = dataclasses.replace(smoke_config(get_config("llama3.2-1b")),
                              n_kv_heads=2, use_pallas_attention=True)
    attn = L.Attention(cfg, torch.float32, cuda_device)
    attn.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    x = torch.randn(2, 40, cfg.d_model, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(1))
    before = flash_attention_kernel.launches
    got, _ = L.attn_apply(attn, cfg, x)
    assert flash_attention_kernel.launches == before + 1
    plain, _ = L.attn_apply(attn, dataclasses.replace(
        cfg, use_pallas_attention=False), x)
    assert flash_attention_kernel.launches == before + 1
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)


# --- K1: the vector-load histogram and the one-sweep digit histograms ----------


@pytest.mark.parametrize("n_bins", [1, 2, 15, 16, 17, 32, 33, 256, 1 << 14,
                                    (1 << 14) + 1, 20_000, 3 * (1 << 14) + 3,
                                    (1 << 16) - 1, 1 << 16])
def test_histogram_unaligned_ragged_streams(rng, cuda_device, n_bins):
    """Register counters (<= 16 bins), shared sub-histograms (<= 2**14) and
    a cluster's slices (above; the last slice short where n_bins is not a
    multiple of 2**14), on streams that start 0-3 elements off a 16-byte
    boundary and end ragged, with -1 and n_bins pads and carried counts."""
    for n in (1, 31, 4095, 4097, (1 << 20) + 37):
        for off in (0, 1, 2, 3):
            base = torch.from_numpy(_digits(rng, n + off, n_bins, "uniform")
                                    ).to(cuda_device)
            keys = base[off:]
            assert keys.data_ptr() % 16 == 4 * off % 16
            init = torch.from_numpy(rng.integers(0, 1000, n_bins).astype(
                np.int32)).to(cuda_device)
            assert torch.equal(fractal_histogram(keys, n_bins),
                               ref.histogram_ref(keys, n_bins)), (n, off)
            assert torch.equal(fractal_histogram(keys, n_bins, init=init),
                               ref.histogram_ref(keys, n_bins, init=init)), (
                n, off)


def test_histogram_skewed_streams(rng, cuda_device):
    """All keys in one bin, and zipf(1.2): every lane of a warp on one
    counter."""
    for n_bins in (16, 256, 1 << 14, 20_000, 3 * (1 << 14) + 3,
                   (1 << 16) - 1, 1 << 16):
        for dist in ("zipf", "one_bin"):
            keys = torch.from_numpy(_digits(rng, (1 << 20) + 5, n_bins, dist)
                                    ).to(cuda_device)
            assert torch.equal(fractal_histogram(keys, n_bins),
                               ref.histogram_ref(keys, n_bins)), (n_bins, dist)


@pytest.mark.parametrize("n_bins,cluster", [(1 << 14, False),
                                            ((1 << 14) + 1, True),
                                            (1 << 16, True)])
def test_histogram_cluster_entry_only_above_2_14_bins(rng, cuda_device,
                                                      monkeypatch, n_bins,
                                                      cluster):
    """Up to 2**14 bins K1 is the one ``fs_histogram`` launch; above, the
    cluster entry alone (its capacity query aside): no kernel that adds a
    key at a time into device memory.  Both launch counters agree."""
    lib = hist_mod._lib()
    called = []

    class Recorder:
        def __getattr__(self, name):
            called.append(name)
            return getattr(lib, name)

    monkeypatch.setattr(hist_mod, "_lib", Recorder)
    hist_mod._max_clusters.cache_clear()
    keys = torch.from_numpy(_digits(rng, 300_001, n_bins, "uniform")
                            ).to(cuda_device)
    before = (fractal_histogram.launches,
              hist_mod.fractal_histogram_cluster.launches)
    got = fractal_histogram(keys, n_bins)
    assert torch.equal(got, ref.histogram_ref(keys, n_bins))
    assert (fractal_histogram.launches,
            hist_mod.fractal_histogram_cluster.launches) == (
        before[0] + 1, before[1] + cluster)
    launches = [c for c in called if c != "fs_histogram_cluster_capacity"]
    assert launches == (["fs_histogram_cluster"] if cluster
                        else ["fs_histogram"])


_SWEEP_PLANS = {
    "p32": lambda n: make_sort_plan(n, 32).passes,
    "p16": lambda n: make_sort_plan(n, 16).passes,
    "p7": lambda n: make_sort_plan(n, 7).passes,
    "8bit": lambda n: make_sort_plan(n, 32, max_bins_log2=8,
                                     engine="scatter").passes,
    "p24_6bit": lambda n: make_sort_plan(n, 24, max_bins_log2=6).passes,
    "14bit": lambda n: (DigitPass(0, 13), DigitPass(13, 12)),
}


@pytest.mark.parametrize("plan", sorted(_SWEEP_PLANS))
def test_digit_histograms_one_sweep(rng, cuda_device, plan):
    """One launch counts every digit, against per-digit plain histograms,
    on aligned and unaligned streams and with carried counts."""
    for n in (1, 4097, (1 << 20) + 37):
        passes = _SWEEP_PLANS[plan](n)
        assert sweep_eligible(passes)
        raw = rng.integers(0, 1 << 32, n + 3, dtype=np.uint64).astype(np.uint32)
        for off in (0, 3):
            keys = torch.from_numpy(raw).to(cuda_device)[off:off + n]
            init = tuple(torch.from_numpy(rng.integers(
                0, 100, dp.n_bins).astype(np.int32)).to(cuda_device)
                for dp in passes)
            for carried in (None, init):
                before = (fractal_histogram.launches,
                          fractal_histogram_digits.launches)
                got = digit_histograms(keys, passes, init=carried)
                assert (fractal_histogram.launches,
                        fractal_histogram_digits.launches) == (
                    before[0] + 1, before[1] + 1)
                want = ref.digit_histograms_ref(keys, passes, init=carried)
                assert len(got) == len(want) == len(passes)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (plan, n, off)


def test_digit_histograms_wide_plan_one_launch_per_digit(rng, cuda_device):
    """The 16b+16b plan (2 x 2**16 bins) does not fit the sweep: one
    single-digit launch per digit."""
    n = 100_003
    passes = make_sort_plan(n, 32, max_bins_log2=16).passes
    assert not sweep_eligible(passes)
    keys = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                            .astype(np.uint32)).to(cuda_device)
    before = (fractal_histogram.launches, fractal_histogram_digits.launches)
    got = digit_histograms(keys, passes)
    assert (fractal_histogram.launches, fractal_histogram_digits.launches) == (
        before[0] + len(passes), before[1])
    for g, w in zip(got, ref.digit_histograms_ref(keys, passes)):
        assert torch.equal(g, w)


def test_warm_sort_launches_k1_once(rng, cuda_device):
    """A p = 32 sort takes all 8 passes' counts from one K1 sweep."""
    keys = torch.from_numpy(rng.integers(0, 1 << 32, 300_001, dtype=np.uint64)
                            .astype(np.uint32)).to(cuda_device)
    fractal_sort(keys, 32)  # warm
    ops.reset_launch_counts()
    out = fractal_sort(keys, 32)
    counts = ops.launch_counts()
    assert counts["fractal_histogram"] == 1, counts
    assert counts["fractal_histogram_digits"] == 1, counts
    assert counts["fractal_rank_kernel"] == len(make_sort_plan(
        keys.shape[0], 32).passes), counts
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  np.sort(keys.cpu().numpy()))


# --- K3: the redesigned sorted-composite rank ---------------------------------------


@pytest.mark.parametrize("n_bins", [1, 2, 16, 256, 257, 4096, 1 << 16])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "one_bin"])
def test_rank_scatter_matches_plain_version(rng, cuda_device, n_bins, dist):
    """Across K3's 8192-key tile edges, on skewed keys and with pads; up
    to 256 bins the look-back launch, above it the table path."""
    for n in (1, 1000, 4095, 8191, 8192, 8193, 3 * 8192 + 5, 100_003):
        keys = torch.from_numpy(_digits(rng, n, n_bins, dist)).to(cuda_device)
        start = torch.from_numpy(
            rng.integers(0, 1 << 20, n_bins).astype(np.int32)).to(cuda_device)
        assert torch.equal(fractal_rank_scatter_kernel(keys, start, n_bins),
                           ref.rank_ref(keys, start, n_bins)), n


@pytest.mark.parametrize("n_bins", [16, 256, 257])
def test_rank_scatter_unaligned_keys(rng, cuda_device, n_bins):
    base = torch.from_numpy(_digits(rng, 50_001, n_bins, "uniform")
                            ).to(cuda_device)
    keys = base[1:]
    start = torch.zeros(n_bins, dtype=torch.int32, device=cuda_device)
    assert keys.data_ptr() % 16 != 0
    assert torch.equal(fractal_rank_scatter_kernel(keys, start, n_bins),
                       ref.rank_ref(keys, start, n_bins))


def test_rank_scatter_wide_digits_long_stream(rng, cuda_device):
    """2**16 bins at n = 2**22, the widest table the reference's block
    admitted."""
    n, n_bins = 1 << 22, 1 << 16
    keys = torch.from_numpy(_digits(rng, n, n_bins, "uniform")).to(cuda_device)
    start = torch.from_numpy(rng.integers(0, 1 << 20, n_bins).astype(np.int32)
                             ).to(cuda_device)
    assert torch.equal(fractal_rank_scatter_kernel(keys, start, n_bins),
                       ref.rank_ref(keys, start, n_bins))


@pytest.mark.parametrize("n_bins,table", [(16, False), (256, False),
                                          (257, True), (1 << 16, True)])
def test_rank_scatter_table_only_above_256_bins(rng, cuda_device, monkeypatch,
                                                n_bins, table):
    """Up to 256 bins K3 is the one look-back launch: no table."""
    lib = rank_mod._lib()
    called = []

    class Recorder:
        def __getattr__(self, name):
            called.append(name)
            return getattr(lib, name)

    monkeypatch.setattr(rank_mod, "_lib", Recorder)
    keys = torch.from_numpy(rng.integers(0, n_bins, 50_000).astype(np.int32)
                            ).to(cuda_device)
    start = torch.zeros(n_bins, dtype=torch.int32, device=cuda_device)
    before = fractal_rank_scatter_kernel.launches
    got = fractal_rank_scatter_kernel(keys, start, n_bins)
    assert fractal_rank_scatter_kernel.launches == before + 1
    assert torch.equal(got, ref.rank_ref(keys, start, n_bins))
    want = (["fs_rank_scatter_counts", "fs_rank_scatter"] if table
            else ["fs_rank_scatter_lookback"])
    assert called == want


# --- the query layer on the card ------------------------------------------------


def _query_cols(rng, n):
    return {"k": rng.integers(0, n // 4, n).astype(np.int32),
            "g": rng.integers(0, 50, n).astype(np.int32),
            "u": rng.integers(0, 200, n).astype(np.uint8),
            "f": rng.standard_normal(n).astype(np.float32),
            "d": rng.standard_normal(n) * 1e6,
            "row": np.arange(n, dtype=np.int32)}


_QUERY_OPS = {
    "order_by": lambda t: tq.order_by(t, [("k", "asc"), ("f", "desc")]),
    "order_by_float64_desc": lambda t: tq.order_by(t, [("d", "desc"), "k"]),
    "group_by": lambda t: tq.group_by(t, ["g", "u"], {
        "s": ("k", "sum"), "c": (None, "count"), "lo": ("f", "min"),
        "hi": ("d", "max"), "d_sum": ("d", "sum")}),
    "distinct": lambda t: tq.distinct(t, ["u"]),
    "top_k": lambda t: tq.top_k(t, [("d", "desc"), "k"], 100),
    "join": lambda t: tq.sort_merge_join(t.select(["k", "f"]),
                                         t.select(["k", "row"]), "k"),
    "join_two_words": lambda t: tq.sort_merge_join(
        t.select(["k", "g", "f"]), t.select(["k", "g", "row"]), ["k", "g"]),
}


@pytest.mark.parametrize("op", sorted(_QUERY_OPS))
def test_query_operator_on_card_matches_cpu(rng, cuda_device, op):
    """Each operator at n = 2**16 on the card (CudaBackend: K1 and K2 on
    every sort) against the same operator on the CPU port: bit-exact
    (float64 sums within 1e-12: atomics add in another order)."""
    cols = _query_cols(rng, 1 << 16)
    on_cpu = _QUERY_OPS[op](tq.Table(cols, device="cpu")).to_numpy()
    ops.reset_launch_counts()
    on_card = _QUERY_OPS[op](tq.Table(cols, device=cuda_device)).to_numpy()
    launched = ops.launch_counts()
    assert launched["fractal_histogram"] > 0, launched
    assert launched["fractal_rank_kernel"] > 0, launched
    assert list(on_card) == list(on_cpu)
    for name, want in on_cpu.items():
        got = on_card[name]
        assert got.dtype == want.dtype, name
        if name == "d_sum":
            np.testing.assert_allclose(got, want, rtol=1e-12)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_sort_rowids_batched_on_card_matches_cpu(rng, cuda_device):
    words = rng.integers(0, 1 << 32, (1 << 16, 2),
                         dtype=np.uint64).astype(np.uint32)
    want_w, want_rid = tq.operators.sort_rowids_batched(
        torch.from_numpy(words), 64, 12)
    w, rid = tq.operators.sort_rowids_batched(
        torch.from_numpy(words).to(cuda_device), 64, 12)
    assert torch.equal(w.cpu(), want_w) and torch.equal(rid.cpu(), want_rid)


def test_warm_order_by_is_one_probe_plus_one_chain_on_card(rng, cuda_device):
    t = tq.Table(_query_cols(rng, 1 << 16), device=cuda_device)
    by = [("k", "asc"), ("f", "desc")]
    tq.order_by(t, by)
    with dispatch.track() as seen:
        tq.order_by(t, by)
    assert {k: v for k, v in seen.items() if k.startswith("query.")} == {
        "query.probe": 1, "query.chain": 1}


# --- the executor's streaming and segmented modes on the card -------------------


@pytest.mark.parametrize("p,num_batches,max_bins_log2", [
    (16, 2, None), (24, 3, None), (32, 4, 16)])
def test_fractal_sort_batched_on_card_matches_cpu(rng, cuda_device, p,
                                                  num_batches, max_bins_log2):
    """The streaming sort on the card carries each slice's counts into the
    next rank kernel's bin starts: bit-exact with the CPU port, and it
    launches K1 and a rank kernel."""
    keys = rng.integers(0, 1 << p, 1 << 16, dtype=np.uint64).astype(np.uint32)
    tkeys = torch.from_numpy(keys if p == 32 else keys.astype(np.int32))
    want, want_h = fractal_sort_batched(tkeys, p, num_batches,
                                        max_bins_log2=max_bins_log2,
                                        device="cpu")
    ops.reset_launch_counts()
    got, got_h = fractal_sort_batched(tkeys, p, num_batches,
                                      max_bins_log2=max_bins_log2,
                                      device=cuda_device)
    launched = ops.launch_counts()
    assert launched["fractal_histogram"] > 0, launched
    assert (launched["fractal_rank_kernel"]
            + launched["fractal_rank_scatter_kernel"]) > 0, launched
    assert torch.equal(got.cpu(), want)
    for gh, wh in zip(got_h, want_h):
        assert torch.equal(gh.leaf_counts.cpu(), wh.leaf_counts)


def test_wide_segment_table_on_card_matches_cpu(rng, cuda_device):
    """A (segment, digit) table wider than one K1 histogram (512 segments
    x 256 bins) is counted by K1 in 2^16-cell slices, one K1 launch a
    slice and none inside the rank."""
    n = 1 << 17
    keys = torch.from_numpy(rng.integers(0, 256, n).astype(np.int32))
    plan = make_sort_plan(n, 8, l_n=8)  # one 8-bit pass
    want = PlanExecutor(TorchBackend()).run_segmented_argsort(keys, plan, 8)
    ops.reset_launch_counts()
    got = PlanExecutor(CudaBackend()).run_segmented_argsort(
        keys.to(cuda_device), plan, 8)
    assert ops.launch_counts()["fractal_histogram"] == 2
    assert torch.equal(got.cpu(), want)


# --- the out-of-core stream on the card ------------------------------------------


def _stream_keys(rng, n, p):
    return rng.integers(0, 1 << p, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("p", [16, 32])
def test_external_sort_and_argsort_on_card_match_torch_sort(rng, cuda_device,
                                                            p):
    from repro_torch import stream as ts
    from repro_torch.stream.external import row_cost_bytes

    keys = _stream_keys(rng, 200_000, p)
    if p < 32:
        keys = keys.astype(np.int32)
    want = torch.sort(torch.from_numpy(keys.astype(np.int64)), stable=True)
    budget = ts.MemoryBudget(256 * 1024)  # the keys are 3x the budget
    rows = budget.rows(row_cost_bytes(1))
    ops.reset_launch_counts()
    got = torch.cat(list(ts.external_sort(ts.ArraySource(keys, rows), p,
                                          budget)))
    assert got.device.type == "cpu"
    assert got.dtype == (torch.uint32 if p == 32 else torch.int32)
    assert torch.equal(torch.from_numpy(got.numpy().astype(np.int64)),
                       want.values)
    pieces = list(ts.external_argsort(ts.ArraySource(keys, rows), p, budget))
    assert torch.equal(torch.cat([i for _, i in pieces]), want.indices)
    counts = ops.launch_counts()
    assert counts["fractal_histogram"] > 0 and counts["fractal_rank_kernel"] > 0
    assert budget.peak_bytes <= budget.limit_bytes


@pytest.mark.parametrize("num_partitions", [100, 300])
def test_distribute_split_on_card_matches_plain_rank(rng, cuda_device,
                                                     num_partitions):
    """The store's device split (K1 counts, K2 rank, one scatter) on both
    sides of K2's 256-bin switch equals the CPU's plain split, sliced or
    not."""
    from repro_torch.stream.chunks import PlacementStore

    n = 50_001
    words = torch.from_numpy(rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    pay = (torch.arange(n, dtype=torch.int64),
           torch.from_numpy(rng.standard_normal(n)))
    pid = torch.from_numpy(rng.integers(-1, num_partitions, n)
                           .astype(np.int32))
    want = PlacementStore._split(words, pay, pid, num_partitions, "torch")
    for slice_rows in (None, 7_000):
        ops.reset_launch_counts()
        got = PlacementStore._split(
            words.to(cuda_device), tuple(p.to(cuda_device) for p in pay),
            pid.to(cuda_device), num_partitions, None, slice_rows)
        assert ops.launch_counts()["fractal_rank_kernel"] > 0
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("bits,sort_bits,num_words,payload", [
    (32, 32, 1, 0), (32, 24, 1, 0), (32, 24, 1, 8), (64, 56, 2, 20)])
def test_row_cost_model_covers_the_measured_partition_sort(
        rng, cuda_device, bits, sort_bits, num_words, payload):
    """One partition sort at the most rows the model admits, padded to
    nearly twice that: the card's measured allocation peak during the
    sort stays within the model's bytes (host and device together), and
    the whole working set within the budget."""
    from repro_torch.stream import MemoryBudget, RunStore
    from repro_torch.stream.chunks import partition_sort_bytes
    from repro_torch.stream.external import row_cost_bytes

    budget = MemoryBudget(64 << 20)
    m = budget.rows(row_cost_bytes(num_words, payload))
    L = 1 << (m - 1).bit_length()
    words = rng.integers(0, 1 << 32, (m, num_words), dtype=np.uint64) \
        .astype(np.uint32)
    words[:, 0] &= np.uint32((1 << (32 - (bits - sort_bits))) - 1)
    pays = ((rng.integers(0, 1 << 62, m, dtype=np.int64),) if payload == 8
            else (rng.standard_normal(m), rng.integers(0, 9, m)
                  .astype(np.int32), rng.integers(0, 9, m).astype(np.int64))
            if payload else ())
    assert sum(p.dtype.itemsize for p in pays) == payload
    store = RunStore()
    store.sort_rows(words, pays, bits, sort_bits, budget, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, gathered = store.sort_rows(words, pays, bits, sort_bits, budget,
                                    device=cuda_device)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    model = partition_sort_bytes(L, m, num_words, payload)
    assert measured <= model, (measured, model)
    assert model <= budget.limit_bytes
    order = np.lexsort(tuple(words[:, j] for j in
                             range(num_words - 1, -1, -1)))
    np.testing.assert_array_equal(got, words[order])
    for g, p in zip(gathered, pays):
        np.testing.assert_array_equal(g, p[order])
    store.close()


def test_stream_table_operators_on_card_match_in_memory(rng, cuda_device):
    from repro_torch import stream as ts

    n = 60_000
    cols = {"k": rng.integers(-500, 500, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32),
            "f": rng.standard_normal(n)}
    host = tq.Table(cols, device="cpu")
    card = tq.Table(cols, device=cuda_device)
    st = ts.StreamTable.from_table(host, ts.MemoryBudget(128 * 1024))
    ops.reset_launch_counts()
    got = tq.order_by(st, [("k", "asc"), ("v", "desc")]).to_table()
    want = tq.order_by(card, [("k", "asc"), ("v", "desc")])
    for name in cols:
        np.testing.assert_array_equal(got.to_numpy()[name],
                                      want.to_numpy()[name])
    aggs = {"s": ("v", "sum"), "c": (None, "count"), "fs": ("f", "sum"),
            "mx": ("v", "max")}
    g, w = tq.group_by(st, "k", aggs).to_numpy(), \
        tq.group_by(card, "k", aggs).to_numpy()
    for name in ("k", "s", "c", "mx"):
        np.testing.assert_array_equal(g[name], w[name])
    np.testing.assert_allclose(g["fs"], w["fs"], rtol=1e-12)
    by = [("f", "desc"), ("k", "asc")]
    top = tq.top_k(st, by, 10).to_numpy()
    want_top = tq.top_k(card, by, 10).to_numpy()
    for name in cols:
        np.testing.assert_array_equal(top[name], want_top[name])
    counts = ops.launch_counts()
    assert counts["fractal_histogram"] > 0 and counts["fractal_rank_kernel"] > 0
    assert st.budget.peak_bytes <= st.budget.limit_bytes


def test_stream_on_card_never_falls_back_to_torch_backend(rng, cuda_device,
                                                          monkeypatch):
    """With the card present, the histogram, the distribute and the
    partition sorts all run on CudaBackend: TorchBackend's rank raising
    changes nothing, and the results are those of the CPU."""
    from repro_torch import stream as ts

    def refuse(*a, **kw):
        raise AssertionError("TorchBackend used on the card")

    monkeypatch.setattr(TorchBackend, "rank", refuse)
    monkeypatch.setattr(TorchBackend, "histogram", refuse)
    keys = _stream_keys(rng, 100_000, 32)
    budget = ts.MemoryBudget(128 * 1024)
    got = torch.cat(list(ts.external_sort(ts.ArraySource(keys, 4096), 32,
                                          budget)))
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))
    t = tq.Table({"k": keys.view(np.int32)}, device="cpu")
    st = ts.StreamTable.from_table(t, budget)
    assert st.to_table().num_rows == keys.shape[0]
    out = tq.order_by(st, "k").to_table().to_numpy()["k"]
    np.testing.assert_array_equal(out, np.sort(keys.view(np.int32)))


def test_external_argsort_on_card_worker_count_invariant(rng, cuda_device,
                                                         monkeypatch):
    from repro_torch import stream as ts

    keys = _stream_keys(rng, 300_000, 32)

    def run(workers):
        monkeypatch.setenv("REPRO_STREAM_WORKERS", str(workers))
        budget = ts.MemoryBudget(256 * 1024)
        parts = list(ts.external_argsort(ts.ArraySource(keys, 8192), 32,
                                         budget))
        return torch.cat([i for _, i in parts])

    one, two = run(1), run(2)
    assert torch.equal(one, two)
    assert torch.equal(one, torch.from_numpy(np.argsort(keys,
                                                        kind="stable")))


# --- the distributed backend and the device store on one NCCL rank ------------


@pytest.fixture
def nccl_group(cuda_device, tmp_path):
    """A one-rank NCCL group in this process (the card's machine has one
    card, and NCCL refuses two ranks on one device)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method="file://" + str(
        tmp_path / "nccl"), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_distributed_sort_on_one_nccl_rank_matches_in_memory(rng, cuda_device,
                                                             nccl_group):
    from repro_torch.core import (distributed_fractal_argsort,
                                  distributed_fractal_sort,
                                  make_distributed_sort_pairs)

    n = 1 << 20
    keys = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                            .astype(np.uint32)).to(cuda_device)
    ops.reset_launch_counts()
    got, ov = distributed_fractal_sort(keys, None, 32)
    counts = ops.launch_counts()
    assert not bool(ov)
    assert torch.equal(got.view(torch.int32),
                       fractal_sort(keys, 32).view(torch.int32))
    assert counts["fractal_histogram"] > 0 and counts["fractal_rank_kernel"] > 0
    perm, ov = distributed_fractal_argsort(keys, None, 32)
    assert not bool(ov) and torch.equal(perm, fractal_argsort(keys, 32))
    pay = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(
        cuda_device)
    sk, sv, ov = make_distributed_sort_pairs(None, 32)(keys, pay)
    assert not bool(ov)
    assert torch.equal(sk.view(torch.int32), got.view(torch.int32))
    assert torch.equal(sv, pay[perm.long()])
    with pytest.raises(ValueError, match="a cpu tensor"):
        distributed_fractal_sort(keys.cpu(), None, 32)


@pytest.mark.parametrize("n,engine", [((1 << 25), "scatter"),
                                      ((1 << 25) + 1, "onehot")])
def test_engine_rule_at_2_16_bins_across_the_table_cap(rng, cuda_device, n,
                                                       engine):
    """A "scatter" hint at 2**16 bins runs K3 while its count table fits
    TABLE_CAP (n <= 2**25) and K2 above; the ranks are the same."""
    n_bins = 1 << 16
    assert rank_mod.scatter_table_fits(n, n_bins) == (engine == "scatter")
    d = torch.from_numpy(rng.integers(0, n_bins, n).astype(np.int32)).to(
        cuda_device)
    start = torch.from_numpy(rng.integers(0, 1 << 20, n_bins).astype(
        np.int32)).to(cuda_device)
    ops.reset_launch_counts()
    rank, _, _ = CudaBackend().rank(d, n_bins, bin_start=start,
                                    engine="scatter")
    counts = ops.launch_counts()
    want = {"scatter": "fractal_rank_scatter_kernel",
            "onehot": "fractal_rank_kernel"}[engine]
    other = ({"fractal_rank_scatter_kernel", "fractal_rank_kernel"}
             - {want}).pop()
    assert counts[want] == 1 and counts[other] == 0, counts
    assert torch.equal(rank, ref.rank_ref(d, start, n_bins))
    assert torch.equal(rank, fractal_rank_kernel(d, start, n_bins))


@pytest.mark.parametrize("bits,sort_bits,num_words,payload", [
    (32, 32, 1, 0), (32, 24, 1, 8), (64, 56, 2, 20)])
def test_device_store_row_cost_covers_the_measured_partition_sort(
        rng, cuda_device, nccl_group, bits, sort_bits, num_words, payload):
    """One DeviceShardStore partition sort at the most rows its row cost
    admits, padded to nearly twice that: the card's allocation peak stays
    within the store's model, and the model within the budget."""
    from repro_torch.stream import DeviceShardStore, MemoryBudget
    from repro_torch.stream.device_store import shard_sort_bytes

    budget = MemoryBudget(64 << 20)
    store = DeviceShardStore()
    m = budget.rows(store.row_cost_bytes(num_words, payload))
    L = 1 << (m - 1).bit_length()
    words = rng.integers(0, 1 << 32, (m, num_words), dtype=np.uint64) \
        .astype(np.uint32)
    words[:, 0] &= np.uint32((1 << (32 - (bits - sort_bits))) - 1)
    pays = ((rng.integers(0, 1 << 62, m, dtype=np.int64),) if payload == 8
            else (rng.standard_normal(m), rng.integers(0, 9, m)
                  .astype(np.int32), rng.integers(0, 9, m).astype(np.int64))
            if payload else ())
    store.sort_rows(words, pays, bits, sort_bits, budget)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, gathered = store.sort_rows(words, pays, bits, sort_bits, budget)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    model = shard_sort_bytes(L, m, num_words, payload)
    assert measured <= model, (measured, model)
    assert model <= budget.limit_bytes and budget.peak_bytes <= model
    order = np.lexsort(tuple(words[:, j] for j in
                             range(num_words - 1, -1, -1)))
    np.testing.assert_array_equal(got, words[order])
    for g, p in zip(gathered, pays):
        np.testing.assert_array_equal(g, p[order])


def test_external_sort_through_the_device_store_on_card(rng, cuda_device,
                                                        nccl_group):
    from repro_torch import stream as ts

    keys = _stream_keys(rng, 300_000, 32)
    budget = ts.MemoryBudget(1 << 20)
    store = ts.DeviceShardStore()
    ops.reset_launch_counts()
    got = torch.cat(list(ts.external_sort(
        ts.ArraySource(keys, budget.rows(store.row_cost_bytes(1))), 32,
        budget, store=store)))
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))
    counts = ops.launch_counts()
    assert counts["fractal_histogram"] > 0 and counts["fractal_rank_kernel"] > 0
    assert store.device_log and budget.peak_bytes <= budget.limit_bytes


# --- the baselines and the autotuner on the card ----------------------------------


@pytest.mark.parametrize("p,radix_bits", [(16, 8), (32, 8), (32, 16)])
def test_lsd_radix_sort_on_card_matches_torch_sort(rng, cuda_device, p,
                                                   radix_bits):
    """Each pass ranks through CudaBackend.rank: K1's counts and K2 (its
    two-level path at 2**16 bins)."""
    from repro_torch.core import lsd_radix_sort

    raw = rng.integers(0, 1 << p, 100_003, dtype=np.uint64).astype(np.uint32)
    keys = torch.from_numpy(raw if p == 32 else raw.astype(np.int32))
    ops.reset_launch_counts()
    got = lsd_radix_sort(keys.to(cuda_device), p, radix_bits)
    counts = ops.launch_counts()
    assert got.dtype == keys.dtype and got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), np.sort(keys.numpy()))
    passes = -(-p // radix_bits)
    assert counts["fractal_histogram"] == passes
    assert counts["fractal_rank_kernel"] == passes
    assert counts["fractal_rank_scatter_kernel"] == 0


@pytest.mark.parametrize("p", [16, 32])
def test_bitonic_and_torch_sort_on_card_match_cpu(rng, cuda_device, p):
    from repro_torch.core import bitonic_sort, torch_sort

    raw = rng.integers(0, 1 << p, 1 << 16, dtype=np.uint64).astype(np.uint32)
    keys = torch.from_numpy(raw if p == 32 else raw.astype(np.int32))
    on_card = keys.to(cuda_device)
    for ascending in (True, False):
        got = bitonic_sort(on_card, ascending=ascending)
        assert got.dtype == keys.dtype and got.is_cuda
        on_cpu = bitonic_sort(keys, ascending=ascending, device="cpu")
        assert torch.equal(got.cpu(), on_cpu)
    want = np.sort(raw if p == 32 else raw.astype(np.int32))
    np.testing.assert_array_equal(torch_sort(on_card).cpu().numpy(), want)


def test_cuda_sweep_measures_on_card_then_hits(cuda_device, tmp_path):
    """A "cuda" sweep at 2**12 keys: every grid point measured on the
    card (K2 or K3 launched), the key names the card, a second call
    measures nothing and tuned_plan resolves the winner."""
    from repro_torch.core import autotune as at

    path = str(tmp_path / "tune.json")
    ops.reset_launch_counts()
    won = at.autotune_plan(1 << 12, 16, backend="cuda", cache_path=path,
                           widths=(4, 8))
    counts = ops.launch_counts()
    assert counts["fractal_rank_kernel"] > 0
    assert counts["fractal_rank_scatter_kernel"] > 0
    key = at.cache_key("cuda", 16, None, 12)
    assert torch.cuda.get_device_name() in key
    entry = at._load(path)[key]
    assert len(entry["sweep"]) == 4 and entry["n_measured"] == 1 << 12
    assert all(s["wall_s"] > 0 for s in entry["sweep"])
    ops.reset_launch_counts()
    assert at.autotune_plan(1 << 12, 16, backend="cuda", cache_path=path,
                            widths=(4, 8)) == won
    assert not any(ops.launch_counts().values()), "a hit measures nothing"
    assert at.tuned_plan(4000, 16, backend="cuda", cache_path=path) == \
        make_sort_plan(4000, 16, max_bins_log2=entry["max_bins_log2"],
                       engine=entry["engine"])


# --- MoE: fractal dispatch on K1 and K2 ------------------------------------------


@pytest.mark.parametrize("T,E", [(1, 128), (32, 128), (4096, 128),
                                 (32768, 128), (1 << 16, 128), (1 << 16, 8),
                                 (4, 16), (8, 16), (128, 16), (8192, 16),
                                 (128, 8)])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "one_expert"])
def test_moe_dispatch_matches_plain_version(rng, cuda_device, T, E, dist):
    """perm, rank and counts bit for bit against the argsort dispatch,
    from one K1 and one K2 launch."""
    if dist == "uniform":
        ids = rng.integers(0, E, T)
    elif dist == "zipf":
        ids = np.minimum(rng.zipf(1.2, T) - 1, E - 1)
    else:
        ids = np.full(T, rng.integers(0, E))
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
    ops.reset_launch_counts()
    got = ops.moe_dispatch(ids, E)
    counts = ops.launch_counts()
    assert counts["fractal_histogram"] == 1
    assert counts["fractal_rank_kernel"] == 1
    for g, w in zip(got, ref.moe_dispatch_ref(ids, E)):
        assert g.dtype == torch.int32
        assert torch.equal(g, w)


def test_moe_apply_on_card_sorts_only_on_k1_k2(cuda_device, monkeypatch):
    """The MoE layer on the card launches K1 and K2 once each, calls no
    torch sort, and equals the same layer on the argsort dispatch bit for
    bit (only integer metadata differs between the two)."""
    from repro_torch.models import moe as M

    cfg = smoke_config(get_config("qwen3-moe-30b-a3b"))
    layer = M.MoE(cfg, torch.float32, cuda_device)
    layer.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    x = torch.randn(2, 64, cfg.d_model, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(1))
    want = M.moe_apply(layer, cfg, x, dispatch=ref.moe_ranks_ref)

    def refuse(*args, **kwargs):
        raise AssertionError("a torch sort on the MoE path")

    monkeypatch.setattr(torch, "sort", refuse)
    monkeypatch.setattr(torch, "argsort", refuse)
    ops.reset_launch_counts()
    out, aux = M.moe_apply(layer, cfg, x)
    counts = ops.launch_counts()
    monkeypatch.undo()
    assert counts["fractal_histogram"] == 1
    assert counts["fractal_rank_kernel"] == 1
    assert torch.equal(out, want[0]) and torch.equal(aux, want[1])


@pytest.mark.parametrize("Sq", [1500, 448])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_whisper_shapes(rng, cuda_device, Sq,
                                                  dtype):
    """whisper-small's encoder over its 1500 audio frames (no tile divides
    1500) and its decoder's 448 text positions attending to them, both
    without a mask: f32 1e-4 (1500-term sums in another order), bf16
    2e-2."""
    B, H, hd, Skv = 2, 12, 64, 1500
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((B, Sq, H, hd), (B, Skv, H, hd), (B, Skv, H, hd)))
    got = flash_attention_kernel(q, k, v, causal=False)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(
        q, k, v, causal=False).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("mixer", ["mamba_apply", "mlstm_apply_chunked",
                                   "slstm_apply"])
def test_recurrent_mixers_on_card_match_cpu(rng, cuda_device, monkeypatch,
                                            mixer):
    """The mamba, chunked mLSTM and sLSTM prefills (plain torch ops, no
    kernel of the repo) on the card against the same functions on the
    CPU, smoke sizes, S = 37 (a ragged last chunk), fp32 within 2e-4."""
    from repro_torch.models import ssm as S
    from repro_torch.models import xlstm as X

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    arch = "jamba-v0.1-52b" if mixer == "mamba_apply" else "xlstm-125m"
    cfg = smoke_config(get_config(arch))
    module, fn = {
        "mamba_apply": (S.Mamba, S.mamba_apply),
        "mlstm_apply_chunked": (X.MLSTM, lambda p, c, x: X.mlstm_apply_chunked(
            p, c, x, 16)),
        "slstm_apply": (X.SLSTM, X.slstm_apply)}[mixer]
    on_cpu = module(cfg, torch.float32, "cpu")
    on_cpu.init_params(torch.Generator().manual_seed(0))
    on_card = module(cfg, torch.float32, cuda_device)
    on_card.load_state_dict(on_cpu.state_dict())
    x = torch.from_numpy((rng.standard_normal((2, 37, cfg.d_model)) * 0.5)
                         .astype(np.float32))
    want = fn(on_cpu, cfg, x)
    got = fn(on_card, cfg, x.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-30b-a3b",
                                  "xlstm-125m"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    """One train step at smoke size from the same weights and batch, with
    no warmup (lr 3e-4, so each parameter moves by about that): loss and
    clipped gradients (``mu / (1 - b1)``) within rtol 1e-4 + atol 1e-5;
    the updated parameters too, except where a side's gradient lies in
    (0, 10 eps): the step divides it by about eps there, so those elements
    (at most 1 %) are held within 2 lr.  The MoE config's dispatch
    launches K1 and K2 (forward and the remat's recompute)."""
    import copy

    from repro_torch import optim as O
    from repro_torch import train_lib as TL
    from repro_torch.data import DataConfig, SyntheticLM, put_batch
    from repro_torch.models import transformer as T

    cfg = smoke_config(get_config(arch))
    on_cpu = T.Transformer(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    before = {k: p.detach().clone() for k, p in on_cpu.named_parameters()}
    on_card = copy.deepcopy(on_cpu).to(cuda_device)
    batch = SyntheticLM(DataConfig(cfg.vocab, 32, 2), device="cpu").batch(0)
    oc = O.OptimizerConfig(warmup_steps=0)
    losses, opts = [], []
    ops.reset_launch_counts()
    for model in (on_cpu, on_card):
        opt, m = TL.make_train_step(cfg, oc)(
            model, O.init_opt_state(model.named_parameters(), oc),
            put_batch(batch, model.device))
        losses.append(float(m["loss"]))
        opts.append(opt)
    lr = float(m["lr"])
    assert losses[1] == pytest.approx(losses[0], rel=1e-4, abs=1e-5)
    n_loose = n_all = 0
    for (name, p), q in zip(on_cpu.named_parameters(), on_card.parameters()):
        g, h = (o["mu"][name].cpu() / (1 - oc.b1) for o in opts)
        torch.testing.assert_close(h, g, rtol=1e-4, atol=1e-5, msg=name)
        p, q = p.detach(), q.detach().cpu()
        assert (q - before[name]).abs().max() > lr / 2, name
        loose = ((torch.minimum(g.abs(), h.abs()) < 10 * oc.eps)
                 & ((g != 0) | (h != 0)))
        torch.testing.assert_close(q[~loose], p[~loose], rtol=1e-4,
                                   atol=1e-5, msg=name)
        assert torch.where(loose, q - p, 0).abs().max() <= 2 * lr + 1e-5, \
            name
        n_loose += int(loose.sum())
        n_all += p.numel()
    assert n_loose <= n_all // 100, (n_loose, n_all)
    if cfg.moe is not None:
        got = ops.launch_counts()
        assert got["fractal_histogram"] >= 2 * cfg.n_layers
        assert got["fractal_rank_kernel"] >= 2 * cfg.n_layers


def test_checkpoint_moves_between_card_and_cpu(cuda_device, tmp_path):
    from repro_torch import checkpoint as CK

    tree = {"w": torch.randn(5, 3, device=cuda_device),
            "h": torch.randn(4, device=cuda_device).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32, device=cuda_device)}
    CK.save(str(tmp_path), 1, tree)
    host = CK.restore(str(tmp_path), 1, tree, device="cpu")
    back = CK.restore(str(tmp_path), 1, host, device=cuda_device)
    for k, t in tree.items():
        assert host[k].device.type == "cpu" and back[k].device == t.device
        assert torch.equal(host[k], t.cpu()) and torch.equal(back[k], t)
    assert CK.restore(str(tmp_path), 1, tree)["w"].device == tree["w"].device


def test_k5_refuses_inputs_that_require_grad_on_card(cuda_device):
    q = torch.randn((1, 8, 2, 16), device=cuda_device)
    k = q.clone().requires_grad_()
    with torch.no_grad():
        flash_attention_kernel(q, k, q)  # no grad asked: runs
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_kernel(q, k, q)


def test_length_bucketed_order_on_card(rng, cuda_device):
    from repro_torch.data import length_bucketed_order

    lengths = torch.from_numpy(rng.integers(0, 1 << 17, 100_003).astype(
        np.int32)).to(cuda_device)
    ops.reset_launch_counts()
    perm = length_bucketed_order(lengths, device=cuda_device)
    got = ops.launch_counts()
    assert got["fractal_histogram"] > 0 and got["fractal_rank_kernel"] > 0
    want = torch.argsort(torch.clamp(lengths, 0, (1 << 16) - 1), stable=True)
    assert torch.equal(perm.long(), want)


def test_synthetic_batches_reach_the_card(cuda_device):
    import functools

    from repro_torch.data import (DataConfig, Prefetcher, SyntheticLM,
                                  put_batch)

    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=4, seed=2)
    host = SyntheticLM(cfg, device="cpu")
    pf = Prefetcher(host, functools.partial(put_batch, device=cuda_device))
    on_card = SyntheticLM(cfg, device=cuda_device)
    for s in (0, 1, 3):
        got = pf.get(s)
        assert got["tokens"].device.type == "cuda"
        assert got["tokens"].dtype == torch.int32
        assert torch.equal(got["tokens"].cpu(), host.batch(s)["tokens"])
        assert torch.equal(on_card.batch(s)["labels"], got["labels"])
