"""The port's distributed sort (``repro_torch.core.distributed``) against
the JAX reference (``repro.core.distributed``) on the CPU.

For each group size D in {2, 4, 8} the same numpy inputs, made from a
seed in this process, go through both packages:

* the reference in one subprocess with D forced host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=D``,
  ``JAX_PLATFORMS=cpu``), each entry point jitted once per shape;
* the port in one spawned gloo group of D ranks (a ``FileStore`` in a
  temporary directory), every rank calling each entry point on its equal
  shard, the results all-gathered; each case runs on both local pass
  backends, ``TorchBackend`` and ``CudaBackend`` (whose kernel wrappers
  compute their plain versions on CPU tensors).

Sorted keys, permutations, payloads, the fragment placer's landed words
and tags and the overflow flags must be bit-exact (tolerance 0), the
dropped slots of an overflowing ``capacity_factor=0.5`` sort included.
The reference runs with x64 off, so its int64 and float64 payloads are
the gathers of its own permutation, as its device store mirrors them.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_SIZES = (2, 4, 8)
BACKENDS = ("torch", "cuda")
DISTS = ("uniform", "zipf", "equal", "sorted")


def _inputs(D: int) -> dict:
    """Every case's global input arrays for group size ``D``."""
    rng = np.random.default_rng(1)
    n = 1 << 13
    inp = {
        "uniform": rng.integers(0, 1 << 16, n).astype(np.int32),
        "zipf": np.clip(rng.zipf(1.3, n), 0, 65535).astype(np.int32),
        "equal": np.full(n, 9, np.int32),
        "sorted": np.sort(rng.integers(0, 65536, n)).astype(np.int32),
        "k32": rng.integers(0, 1 << 32, 1 << 12, dtype=np.uint64)
        .astype(np.uint32),
        "wide": np.random.default_rng(3).integers(
            0, 1 << 32, 1 << 12, dtype=np.uint64).astype(np.uint32),
        "dup": np.random.default_rng(3).choice(
            [7, 9, 1 << 20], 1 << 12).astype(np.uint32),
        "pay32": rng.integers(-(1 << 31), 1 << 31, 1 << 12).astype(np.int32),
        "pay64": rng.integers(-(1 << 62), 1 << 62, 1 << 12).astype(np.int64),
        "payf64": rng.standard_normal(1 << 12),
        "words": rng.integers(0, 1 << 32, (1 << 10, 2), dtype=np.uint64)
        .astype(np.uint32),
        "dest": rng.integers(-1, D, 1 << 10).astype(np.int32),
    }
    inp["pairs_keys"] = np.clip(rng.zipf(1.2, 1 << 12), 0,
                                (1 << 32) - 1).astype(np.uint32)
    return inp


# the reference: every entry point jitted once per shape (a shard_map
# program traced eagerly compiles op by op, which takes minutes at D = 8)
_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    D, out_dir = int(sys.argv[1]), sys.argv[2]
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={D}"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import make_mesh
    from repro.core import distributed as rd
    assert len(jax.devices()) == D
    mesh = make_mesh((D,), ("d",))
    inp = dict(np.load(os.path.join(out_dir, "in.npz")))
    sh = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("d")))
    out = {}
    f16 = jax.jit(rd.make_distributed_sort(mesh, "d", 16))
    for name in ("uniform", "zipf", "equal", "sorted"):
        got, ov = f16(sh(inp[name]))
        out[f"sort16/{name}"], out[f"sort16/{name}/ov"] = np.asarray(got), \\
            np.asarray(ov)
    got, ov = jax.jit(rd.make_distributed_sort(mesh, "d", 16,
                                               taper_wire=False))(
        sh(inp["uniform"]))
    out["untapered"], out["untapered/ov"] = np.asarray(got), np.asarray(ov)
    f32 = jax.jit(rd.make_distributed_sort(mesh, "d", 32, max_bins_log2=16))
    for name in ("k32", "wide"):
        got, ov = f32(sh(inp[name]))
        out[f"sort32/{name}"], out[f"sort32/{name}/ov"] = np.asarray(got), \\
            np.asarray(ov)
    a32 = jax.jit(rd.make_distributed_argsort(mesh, "d", 32,
                                              max_bins_log2=16))
    for name in ("dup", "wide"):
        got, ov = a32(sh(inp[name]))
        out[f"argsort/{name}"], out[f"argsort/{name}/ov"] = \\
            np.asarray(got), np.asarray(ov)
    keys = inp["pairs_keys"]
    idx = np.arange(keys.shape[0], dtype=np.int32)
    sk, p32, perm, ov = jax.jit(rd.make_distributed_sort_pairs(
        mesh, "d", 32, num_payloads=2))(sh(keys), sh(inp["pay32"]), sh(idx))
    perm = np.asarray(perm)
    out["pairs/keys"], out["pairs/pay32"] = np.asarray(sk), np.asarray(p32)
    out["pairs/pay64"] = inp["pay64"][perm]
    out["pairs/payf64"] = inp["payf64"][perm]
    out["pairs/ov"] = np.asarray(ov)
    over = jax.jit(rd.make_distributed_sort_pairs(
        mesh, "d", 16, num_payloads=1, capacity_factor=0.5))
    for name in ("zipf", "uniform"):
        sk, pv, ov = over(sh(inp[name]),
                          sh(np.arange(inp[name].shape[0], dtype=np.int32)))
        out[f"over/{name}/keys"], out[f"over/{name}/pay"] = np.asarray(sk), \\
            np.asarray(pv)
        out[f"over/{name}/ov"] = np.asarray(ov)
    words, dest = inp["words"], inp["dest"]
    lw, lt = jax.jit(rd.make_fragment_placer(mesh, "d", words.shape[1]))(
        sh(words), sh(dest), sh(np.arange(dest.shape[0], dtype=np.int32)))
    out["placer/words"], out["placer/tags"] = np.asarray(lw), np.asarray(lt)
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
""")


def _port_cases(rank: int, D: int, inp: dict) -> dict:
    """Every case through the port on this rank's shards; outputs
    all-gathered (``name/ov``: this rank's overflow flag)."""
    from repro_torch.core import distributed as td

    def shard(a):
        s = a.shape[0] // D
        t = torch.from_numpy(np.ascontiguousarray(a[rank * s:(rank + 1) * s]))
        return t

    def full(t):
        # gloo gathers no uint32: move its bits as int32
        bits = t.view(torch.int32) if t.dtype == torch.uint32 else t
        every = [torch.empty_like(bits) for _ in range(D)]
        dist.all_gather(every, bits)
        a = torch.cat(every).numpy()
        return a.view(np.uint32) if t.dtype == torch.uint32 else a

    out = {}
    for be in BACKENDS:
        f16 = td.make_distributed_sort(None, 16, backend=be)
        for name in DISTS:
            got, ov = f16(shard(inp[name]))
            out[f"{be}/sort16/{name}"] = full(got)
            out[f"{be}/sort16/{name}/ov"] = np.asarray(bool(ov))
        got, ov = td.distributed_fractal_sort(shard(inp["uniform"]), None, 16,
                                              taper_wire=False, backend=be)
        out[f"{be}/untapered"], out[f"{be}/untapered/ov"] = full(got), \
            np.asarray(bool(ov))
        f32 = td.make_distributed_sort(None, 32, max_bins_log2=16, backend=be)
        for name in ("k32", "wide"):
            got, ov = f32(shard(inp[name]))
            out[f"{be}/sort32/{name}"] = full(got)
            out[f"{be}/sort32/{name}/ov"] = np.asarray(bool(ov))
        for name in ("dup", "wide"):
            got, ov = td.distributed_fractal_argsort(
                shard(inp[name]), None, 32, max_bins_log2=16, backend=be)
            out[f"{be}/argsort/{name}"] = full(got)
            out[f"{be}/argsort/{name}/ov"] = np.asarray(bool(ov))
        sk, p32, p64, pf, ov = td.make_distributed_sort_pairs(
            None, 32, num_payloads=3, backend=be)(
            shard(inp["pairs_keys"]), shard(inp["pay32"]),
            shard(inp["pay64"]), shard(inp["payf64"]))
        out[f"{be}/pairs/keys"], out[f"{be}/pairs/pay32"] = full(sk), full(p32)
        out[f"{be}/pairs/pay64"], out[f"{be}/pairs/payf64"] = full(p64), \
            full(pf)
        out[f"{be}/pairs/ov"] = np.asarray(bool(ov))
        over = td.make_distributed_sort_pairs(None, 16, num_payloads=1,
                                              capacity_factor=0.5, backend=be)
        for name in ("zipf", "uniform"):
            keys = inp[name]
            sk, pv, ov = over(shard(keys), shard(
                np.arange(keys.shape[0], dtype=np.int32)))
            out[f"{be}/over/{name}/keys"] = full(sk)
            out[f"{be}/over/{name}/pay"] = full(pv)
            out[f"{be}/over/{name}/ov"] = np.asarray(bool(ov))
        words, dest = inp["words"], inp["dest"]
        lw, lt = td.make_fragment_placer(None, words.shape[1], backend=be)(
            shard(words.view(np.int32)), shard(dest),
            shard(np.arange(dest.shape[0], dtype=np.int32)))
        out[f"{be}/placer/words"] = full(lw).view(np.uint32)
        out[f"{be}/placer/tags"] = full(lt)
    # rank 0 one row short: the entry point's shard check raises on every
    # rank before any pass runs
    short = shard(inp["uniform"])[:-1 if rank == 0 else None]
    try:
        td.distributed_fractal_sort(short, None, 16)
        out["unequal/raised"] = np.asarray(False)
    except ValueError:
        out["unequal/raised"] = np.asarray(True)
    return out


def _port_worker(rank: int, D: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "store"),
        rank=rank, world_size=D)
    try:
        inp = dict(np.load(os.path.join(out_dir, "in.npz")))
        out = _port_cases(rank, D, inp)
        np.savez(os.path.join(out_dir, f"port{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{D: (inputs, reference outputs, each rank's port outputs)}``: the
    reference subprocesses run while the port's groups run."""
    base = tmp_path_factory.mktemp("distributed")
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env.update(PYTHONPATH="src", JAX_PLATFORMS="cpu")
    procs, dirs = {}, {}
    for D in WORLD_SIZES:
        dirs[D] = str(base / f"d{D}")
        os.makedirs(dirs[D])
        np.savez(os.path.join(dirs[D], "in.npz"), **_inputs(D))
        # JAX_PLATFORMS=cpu: the image ships libtpu; without the pin jax
        # probes for a TPU and hangs the child
        procs[D] = subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT, str(D), dirs[D]],
            cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    try:
        for D in WORLD_SIZES:
            mp.spawn(_port_worker, args=(D, dirs[D]), nprocs=D, join=True)
    finally:
        logs = {D: p.communicate(timeout=600) for D, p in procs.items()}
    for D, p in procs.items():
        assert p.returncode == 0, f"reference D={D}:\n{logs[D][1][-4000:]}"
    return {D: (_inputs(D), dict(np.load(os.path.join(dirs[D], "ref.npz"))),
                [dict(np.load(os.path.join(dirs[D], f"port{r}.npz")))
                 for r in range(D)])
            for D in WORLD_SIZES}


def _same(got, want, what):
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert np.array_equal(got, want), f"{what}: differs from the reference"


def _check(runs, D, be, *names):
    _, ref, port = runs[D]
    for name in names:
        _same(port[0][f"{be}/{name}"], ref[name], f"D={D} {be} {name}")


@pytest.mark.parametrize("be", BACKENDS)
@pytest.mark.parametrize("D", WORLD_SIZES)
def test_sort_distributions_match_the_reference(runs, D, be):
    inp, ref, _ = runs[D]
    for name in DISTS:
        _check(runs, D, be, f"sort16/{name}", f"sort16/{name}/ov")
        assert not ref[f"sort16/{name}/ov"]
        assert np.array_equal(ref[f"sort16/{name}"], np.sort(inp[name]))


@pytest.mark.parametrize("be", BACKENDS)
@pytest.mark.parametrize("D", WORLD_SIZES)
def test_two_pass_p32_matches_the_reference(runs, D, be):
    inp, ref, _ = runs[D]
    _check(runs, D, be, "sort32/k32", "sort32/k32/ov")
    assert np.array_equal(ref["sort32/k32"], np.sort(inp["k32"]))


@pytest.mark.parametrize("be", BACKENDS)
@pytest.mark.parametrize("D", WORLD_SIZES)
def test_wide_field_sort_and_duplicate_argsort(runs, D, be):
    """The 16-bit fields' local rank on the scatter engine; the argsort of
    three repeated values keeps (rank, arrival) order."""
    inp, ref, _ = runs[D]
    _check(runs, D, be, "sort32/wide", "sort32/wide/ov", "argsort/dup",
           "argsort/dup/ov", "argsort/wide", "argsort/wide/ov")
    assert np.array_equal(ref["argsort/dup"],
                          np.argsort(inp["dup"], kind="stable"))


@pytest.mark.parametrize("be", BACKENDS)
@pytest.mark.parametrize("D", WORLD_SIZES)
def test_pairs_carry_int32_int64_and_float64_payloads(runs, D, be):
    inp, ref, _ = runs[D]
    _check(runs, D, be, "pairs/keys", "pairs/pay32", "pairs/pay64",
           "pairs/payf64", "pairs/ov")
    perm = np.argsort(inp["pairs_keys"], kind="stable")
    assert np.array_equal(ref["pairs/pay32"], inp["pay32"][perm])


@pytest.mark.parametrize("be", BACKENDS)
@pytest.mark.parametrize("D", WORLD_SIZES)
def test_taper_wire_on_and_off(runs, D, be):
    """Shards of < 2**16 keys gather their counts as uint16 bytes; the
    untapered int32 wire gives the same sort."""
    _, ref, port = runs[D]
    _check(runs, D, be, "untapered", "untapered/ov", "sort16/uniform")
    _same(port[0][f"{be}/untapered"], port[0][f"{be}/sort16/uniform"],
          "tapered and untapered")


@pytest.mark.parametrize("be", BACKENDS)
@pytest.mark.parametrize("D", WORLD_SIZES)
def test_capacity_overflow_drops_like_the_reference(runs, D, be):
    """At capacity_factor=0.5 the buckets overflow: the flag and every
    output slot, the dropped ones (0) included, equal the reference's."""
    _, ref, port = runs[D]
    for name in ("zipf", "uniform"):
        _check(runs, D, be, f"over/{name}/keys", f"over/{name}/pay",
               f"over/{name}/ov")
    assert ref["over/zipf/ov"], "duplicate-heavy keys must overflow"
    keys = port[0][f"{be}/over/zipf/keys"]
    assert (keys == 0).sum() > (runs[D][0]["zipf"] == 0).sum(), \
        "overflow left no dropped slot"


@pytest.mark.parametrize("be", BACKENDS)
@pytest.mark.parametrize("D", WORLD_SIZES)
def test_fragment_placer_matches_the_reference(runs, D, be):
    """Rows with dest < 0 drop on the wire; landed words and tags, empty
    slots included, equal the reference's."""
    inp, ref, _ = runs[D]
    _check(runs, D, be, "placer/words", "placer/tags")
    tags, t = ref["placer/tags"], inp["dest"].shape[0]
    for d in range(D):
        mine = tags[d * t:(d + 1) * t]
        assert np.array_equal(mine[mine >= 0],
                              np.flatnonzero(inp["dest"] == d))


@pytest.mark.parametrize("D", WORLD_SIZES)
def test_unequal_shards_raise_on_every_rank(runs, D):
    _, _, port = runs[D]
    assert all(bool(port[r]["unequal/raised"]) for r in range(D))


@pytest.mark.parametrize("D", WORLD_SIZES)
def test_every_rank_returns_the_same_overflow_flag(runs, D):
    _, _, port = runs[D]
    flags = [k for k in port[0] if k.endswith("/ov")]
    assert any(port[0][k] for k in flags) and not all(
        port[0][k] for k in flags)
    for r in range(1, D):
        for k in flags:
            assert port[r][k] == port[0][k], f"rank {r} {k}"
