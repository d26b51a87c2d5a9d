"""Disk ≡ device placement parity for the port: the external sort's
partition loop speaks only the PlacementStore protocol, so swapping the
disk ``RunStore`` for a ``DeviceShardStore`` (fragments routed over a
gloo group, partition sorts through the distributed backend) must give
the same output bit for bit, and the reference's own ``DeviceShardStore``
output, at group sizes 1, 2 and 4.

For each group size D the same numpy inputs, made from a seed here, go
through the reference's device and disk stores in one subprocess with D
forced host devices, and through the port's in one spawned gloo group of
D ranks (every rank runs the same external loop; each rank's outputs are
saved and must be equal).  Sizes are the reference's own placement tests
(``tests/test_placement.py``).  Float64 group sums add in another order
than the reference's and are held within 1e-12, as in
``tests/test_torch_stream.py``; everything else is bit-exact.
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
WORLD_SIZES = (1, 2, 4)
F64_RTOL = 1e-12


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    inp = {"keys": np.concatenate([
        rng.integers(0, 1 << 32, 40000, dtype=np.uint64).astype(np.uint32),
        np.full(8000, 123456789, np.uint32)])}        # duplicate block
    rng = np.random.default_rng(3)
    n = 30000
    inp.update(k=rng.integers(0, 400, n).astype(np.int32),
               v=rng.standard_normal(n),
               s=rng.integers(0, 1 << 31, n).astype(np.int32))
    rng = np.random.default_rng(11)
    # two key values: the histogram yields few non-empty partitions
    inp["idle"] = rng.choice(np.asarray([5, 900000], np.uint32), 20000)
    rng = np.random.default_rng(13)
    inp["skew"] = np.concatenate([
        np.full(60000, 777777, np.uint32),
        rng.integers(0, 1 << 32, 12000, dtype=np.uint64).astype(np.uint32)])
    rng = np.random.default_rng(17)
    inp["topk_k"] = rng.integers(0, 1 << 30, 30000).astype(np.int32)
    inp["topk_v"] = rng.integers(0, 10, 30000).astype(np.int32)
    return inp


_BUDGET = {"sort": 1 << 19, "table": 1 << 18, "idle": 1 << 18,
           "skew": 1 << 18, "topk": 1 << 16}
_AGGS = {"v": ("v", "sum"), "n": (None, "count")}

# the reference's device store and disk store on the same inputs (its
# tests' bodies, the results saved)
_REF_SCRIPT = f"B = {_BUDGET!r}\nAGGS = {_AGGS!r}\n" + textwrap.dedent("""
    import os, sys
    D, out_dir = int(sys.argv[1]), sys.argv[2]
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={D}"
    import numpy as np, jax
    from repro.stream import (ArraySource, DeviceShardStore, MemoryBudget,
                              StreamTable, external_argsort, external_sort)
    from repro.query import Table, group_by, order_by, top_k
    assert len(jax.devices()) == D
    inp = dict(np.load(os.path.join(out_dir, "in.npz")))
    out = {}
    keys = inp["keys"]
    src = ArraySource(keys, MemoryBudget(B["sort"]).rows(12))
    for where, store in (("disk", lambda: None),
                         ("device", DeviceShardStore)):
        out[f"sort/{where}"] = np.concatenate(list(external_sort(
            src, 32, MemoryBudget(B["sort"]), store=store())))
        parts = list(external_argsort(src, 32, MemoryBudget(B["sort"]),
                                      store=store()))
        out[f"argsort/{where}/keys"] = np.concatenate([p[0] for p in parts])
        out[f"argsort/{where}/ids"] = np.concatenate([p[1] for p in parts])
    if D > 1:
        t = Table({c: inp[c] for c in ("k", "v", "s")})
        stream = lambda: StreamTable.from_table(t, MemoryBudget(B["table"]))
        for where, store in (("disk", lambda: None),
                             ("device", DeviceShardStore)):
            res = order_by(stream(), ["k", "s"],
                           placement=store()).to_table()
            for c in res.column_names:
                out[f"order_by/{where}/{c}"] = np.asarray(res.column(c))
            res = group_by(stream(), "k", AGGS, placement=store())
            for c in res.column_names:
                out[f"group_by/{where}/{c}"] = np.asarray(res.column(c))
            res = top_k(stream(), ["k", "s"], 200, placement=store())
            for c in res.column_names:
                out[f"top_k/{where}/{c}"] = np.asarray(res.column(c))
    if D == 4:
        for name in ("idle", "skew"):
            src = ArraySource(inp[name], MemoryBudget(B[name]).rows(12))
            parts = list(external_argsort(src, 32, MemoryBudget(B[name]),
                                          store=DeviceShardStore()))
            out[f"{name}/ids"] = np.concatenate([p[1] for p in parts])
        from repro.stream import stream_top_k
        t = Table({"k": inp["topk_k"], "v": inp["topk_v"]})
        res = stream_top_k(StreamTable.from_table(t, MemoryBudget(B["topk"])),
                           "k", 50, store=DeviceShardStore())
        for c in res.column_names:
            out[f"prune/{c}"] = np.asarray(res.column(c))
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
""")


def _table_cols(table) -> dict:
    return {c: table.column(c).numpy() for c in table.column_names}


def _port_cases(D: int, inp: dict) -> dict:
    """Every case through the port's RunStore (disk) and DeviceShardStore
    on this rank; ``log/...``: the device logs' (fragment, rank) pairs."""
    from repro_torch import query as tq
    from repro_torch import stream as ts

    def device_store():
        return ts.DeviceShardStore(device="cpu")

    out = {}
    keys = inp["keys"]
    src = ts.ArraySource(keys, ts.MemoryBudget(_BUDGET["sort"]).rows(12))
    for where, store in (("disk", lambda: None), ("device", device_store)):
        st = store()
        out[f"sort/{where}"] = np.concatenate([k.numpy() for k in (
            ts.external_sort(src, 32, ts.MemoryBudget(_BUDGET["sort"]),
                             store=st, device="cpu"))])
        if st is not None:
            out["sort/log"] = np.asarray(st.device_log, np.int64)
        parts = list(ts.external_argsort(
            src, 32, ts.MemoryBudget(_BUDGET["sort"]), store=store(),
            device="cpu"))
        out[f"argsort/{where}/keys"] = np.concatenate(
            [p[0].numpy() for p in parts])
        out[f"argsort/{where}/ids"] = np.concatenate(
            [p[1].numpy() for p in parts])
    if D > 1:
        t = tq.Table({c: inp[c] for c in ("k", "v", "s")}, device="cpu")

        def stream():
            return ts.StreamTable.from_table(
                t, ts.MemoryBudget(_BUDGET["table"]), device="cpu")

        for where, store in (("disk", lambda: None),
                             ("device", device_store)):
            res = tq.order_by(stream(), ["k", "s"],
                              placement=store()).to_table()
            out.update({f"order_by/{where}/{c}": a
                        for c, a in _table_cols(res).items()})
            res = tq.group_by(stream(), "k", _AGGS, placement=store())
            out.update({f"group_by/{where}/{c}": a
                        for c, a in _table_cols(res).items()})
            res = tq.top_k(stream(), ["k", "s"], 200, placement=store())
            out.update({f"top_k/{where}/{c}": a
                        for c, a in _table_cols(res).items()})
    if D == 4:
        for name in ("idle", "skew"):
            budget = ts.MemoryBudget(_BUDGET[name])
            st = device_store()
            parts = list(ts.external_argsort(
                ts.ArraySource(inp[name], budget.rows(12)), 32, budget,
                store=st, device="cpu"))
            out[f"{name}/ids"] = np.concatenate([p[1].numpy() for p in parts])
            out[f"{name}/log"] = np.asarray(st.device_log, np.int64)
        t = tq.Table({"k": inp["topk_k"], "v": inp["topk_v"]}, device="cpu")
        st = device_store()
        res = ts.stream_top_k(ts.StreamTable.from_table(
            t, ts.MemoryBudget(_BUDGET["topk"]), device="cpu"), "k", 50,
            store=st)
        out.update({f"prune/{c}": a for c, a in _table_cols(res).items()})
        out["prune/log"] = np.asarray(st.device_log, np.int64)
    st = device_store()
    out["owners"] = np.asarray([st.owner(i, P) for P in (1, 2, 3, 4, 7, 16,
                                                          100)
                                for i in range(P)], np.int64)
    return out


def _port_worker(rank: int, D: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "store"),
        rank=rank, world_size=D)
    try:
        inp = dict(np.load(os.path.join(out_dir, "in.npz")))
        np.savez(os.path.join(out_dir, f"port{rank}.npz"),
                 **_port_cases(D, inp))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{D: (reference outputs, each rank's port outputs)}``: the
    reference subprocesses run while the port's groups run."""
    base = tmp_path_factory.mktemp("placement")
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env.update(PYTHONPATH="src", JAX_PLATFORMS="cpu",
               REPRO_AUTOTUNE_CACHE=str(base / "tune.json"))
    procs, dirs = {}, {}
    for D in WORLD_SIZES:
        dirs[D] = str(base / f"d{D}")
        os.makedirs(dirs[D])
        np.savez(os.path.join(dirs[D], "in.npz"), **_inputs())
        # JAX_PLATFORMS=cpu: the image ships libtpu; without the pin jax
        # probes for a TPU and hangs the child
        procs[D] = subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT, str(D), dirs[D]],
            cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    try:
        # the port's ranks inherit this process's environment: an empty
        # autotune cache gives them the static plans
        with pytest.MonkeyPatch.context() as mpatch:
            mpatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                          str(base / "tune_torch.json"))
            for D in WORLD_SIZES:
                mp.spawn(_port_worker, args=(D, dirs[D]), nprocs=D,
                         join=True)
    finally:
        logs = {D: p.communicate(timeout=900) for D, p in procs.items()}
    for D, p in procs.items():
        assert p.returncode == 0, f"reference D={D}:\n{logs[D][1][-4000:]}"
    return {D: (dict(np.load(os.path.join(dirs[D], "ref.npz"))),
                [dict(np.load(os.path.join(dirs[D], f"port{r}.npz")))
                 for r in range(D)])
            for D in WORLD_SIZES}


def _same(got, want, what, rtol=None):
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=what)
    else:
        assert np.array_equal(got, want), f"{what}: differs"


@pytest.mark.parametrize("D", [2, 4])
def test_every_rank_holds_the_same_outputs(runs, D):
    """SPMD: every rank runs the same loop; fragments, device logs and
    outputs agree on every rank."""
    _, port = runs[D]
    for r in range(1, D):
        assert set(port[r]) == set(port[0])
        for k in port[0]:
            _same(port[r][k], port[0][k], f"rank {r} {k}")


@pytest.mark.parametrize("D", WORLD_SIZES)
def test_disk_device_parity_external_sorts(runs, D):
    ref, port = runs[D]
    got = port[0]
    keys = _inputs()["keys"]
    for name in ("sort/{}", "argsort/{}/keys", "argsort/{}/ids"):
        want = ref[name.format("device")]
        _same(want, ref[name.format("disk")], f"reference {name}")
        for where in ("device", "disk"):
            _same(got[name.format(where)], want, f"D={D} port {where} {name}")
    _same(got["sort/device"], np.sort(keys), "sorted")
    ids = got["argsort/device/ids"]
    # stability across shard boundaries: THE stable permutation, the
    # duplicate block in arrival order
    _same(ids, np.argsort(keys, kind="stable").astype(np.int64), "perm")
    assert len(got["sort/log"]) > 0, "the device store saw no fragments"
    used = set(got["sort/log"][:, 1].tolist())
    assert used == set(range(D)), f"ranks that received fragments: {used}"


@pytest.mark.parametrize("D", [2, 4])
def test_disk_device_parity_stream_table_ops(runs, D):
    ref, port = runs[D]
    got = port[0]
    for op in ("order_by", "group_by", "top_k"):
        cols = sorted(k.split("/")[2] for k in ref if
                      k.startswith(f"{op}/device/"))
        assert cols, op
        for c in cols:
            rtol = F64_RTOL if op == "group_by" and c == "v" else None
            want = ref[f"{op}/device/{c}"]
            _same(got[f"{op}/device/{c}"], want, f"D={D} {op} {c}", rtol)
            _same(got[f"{op}/device/{c}"], got[f"{op}/disk/{c}"],
                  f"D={D} {op} {c} device != disk")


def test_device_owner_map_is_contiguous_and_order_preserving(runs):
    for D in WORLD_SIZES:
        owners = runs[D][1][0]["owners"].tolist()
        at = 0
        for P in (1, 2, 3, 4, 7, 16, 100):
            o = owners[at:at + P]
            at += P
            assert o == sorted(o), (D, P, o)
            assert o[0] == 0 and all(0 <= x < D for x in o)
            assert o == [i * D // P for i in range(P)]
            if P >= D:
                assert o[-1] == D - 1


def test_top_k_prune_is_a_device_prune(runs):
    """The histogram's top-k prune keeps a partition prefix; with the
    order-preserving owner map that is a rank prefix — pruned ranks
    receive zero fragments, counted on the device log."""
    ref, port = runs[4]
    got = port[0]
    for c in ("k", "v"):
        _same(got[f"prune/{c}"], ref[f"prune/{c}"], f"top_k {c}")
    inp = _inputs()
    order = np.argsort(inp["topk_k"], kind="stable")[:50]
    _same(got["prune/k"], inp["topk_k"][order], "top_k against numpy")
    used = sorted(set(got["prune/log"][:, 1].tolist()))
    assert used, "top-k placed nothing"
    assert max(used) < 3, f"tail ranks received fragments: {used}"
    assert used == list(range(len(used))), used


def test_mesh_larger_than_nonempty_partitions(runs):
    """Fewer non-empty partitions than ranks: the idle ranks receive no
    fragment and the output stays exact."""
    ref, port = runs[4]
    got = port[0]
    keys = _inputs()["idle"]
    _same(got["idle/ids"], ref["idle/ids"], "argsort")
    _same(got["idle/ids"], np.argsort(keys, kind="stable").astype(np.int64),
          "argsort against numpy")
    used = set(got["idle/log"][:, 1].tolist())
    assert used and len(used) < 4, f"expected idle ranks, used {used}"


def test_skew_bin_recursion_under_device_store(runs):
    """One value dominating the stream forces the oversized-bin recursion
    while fragments live on the group; the recursion re-enters the same
    store and stability survives."""
    ref, port = runs[4]
    got = port[0]
    keys = _inputs()["skew"]
    _same(got["skew/ids"], ref["skew/ids"], "argsort")
    _same(got["skew/ids"], np.argsort(keys, kind="stable").astype(np.int64),
          "argsort against numpy")
    assert len(got["skew/log"]) > 0
