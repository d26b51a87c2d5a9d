"""The port's training substrates against the JAX reference on the CPU:
the data pipeline (``repro_torch.data``), the fault-tolerance runtime
(``repro_torch.runtime``), checkpointing (``repro_torch.checkpoint``) and
the training driver that wires them (``repro_torch.launch.train``).

Inputs come from a numpy seed and go through both packages: the
synthetic token batches and the length-bucketed order must be bit-exact
(tolerance 0); the runtime's journal, straggler flags and restart
schedule must equal the reference's on the same inputs.  Checkpoints
are the port's own format (it does not read the reference's files):
round trip, keep-K, atomicity, async snapshots, bf16 leaves and restore
onto another device are checked on the port alone.  The driver runs in a
child process on the CPU, as ``tests/test_system.py`` runs the
reference's: an induced failure and restart, and a resume.
"""

import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as JRT
from repro.data import DataConfig as JDataConfig
from repro.data import Prefetcher as JPrefetcher
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import length_bucketed_order as jlength_bucketed_order
from repro_torch import checkpoint as CK
from repro_torch import runtime as RT
from repro_torch.data import (DataConfig, Prefetcher, SyntheticLM,
                              length_bucketed_order, put_batch)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _empty_autotune_caches(tmp_path, monkeypatch):
    """All-defaults sorts resolve their plan through the autotune cache:
    empty ones give both packages the static plans, whatever caches the
    machine holds."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))


# --- data pipeline ------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq_len,batch,seed", [
    (256, 16, 2, 0), (128256, 32, 4, 3), (151936, 8, 3, 11)])
def test_synthetic_lm_tokens_equal_the_reference(vocab, seq_len, batch, seed):
    got = SyntheticLM(DataConfig(vocab, seq_len, batch, seed), device="cpu")
    want = JSyntheticLM(JDataConfig(vocab, seq_len, batch, seed))
    for step in (0, 1, 17, 10_000):
        g, w = got.batch(step), want.batch(step)
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int32
            assert g[k].shape == (batch, seq_len)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_synthetic_lm_is_pure_and_restart_safe():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=4, seed=3)
    a, b = SyntheticLM(cfg, device="cpu"), SyntheticLM(cfg, device="cpu")
    for s in (0, 5, 5, 17):  # restarts replay identical batches
        assert torch.equal(a.batch(s)["tokens"], b.batch(s)["tokens"])
    c = SyntheticLM(DataConfig(100, 8, 4, seed=4), device="cpu")
    assert not torch.equal(a.batch(0)["tokens"], c.batch(0)["tokens"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is reachable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticLM(DataConfig(100, 8, 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        length_bucketed_order(np.arange(8))


@pytest.mark.parametrize("n,high,bits", [
    (512, 2000, 16), (4096, 70_000, 16), (3000, 40, 6), (1, 5, 16),
    (20_000, 1 << 20, 12)])
def test_length_bucketed_order_equals_the_reference(n, high, bits):
    """Lengths with many ties (and some past the key width, clipped)."""
    lengths = np.random.default_rng(n).integers(0, high, n).astype(np.int32)
    got = length_bucketed_order(torch.from_numpy(lengths), bits,
                                device="cpu")
    want = np.asarray(jlength_bucketed_order(jnp.asarray(lengths), bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    keys = np.clip(lengths, 0, (1 << bits) - 1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(keys, kind="stable"))


def test_prefetcher_buffers_as_the_reference_does():
    """Same batches and the same buffered steps after each get, over a
    skip forward and a restart back."""
    cfg = (50, 4, 2)
    src = SyntheticLM(DataConfig(*cfg), device="cpu")
    pf = Prefetcher(src, functools.partial(put_batch, device="cpu"), depth=3)
    ref = JPrefetcher(JSyntheticLM(JDataConfig(*cfg)), lambda b: b, depth=3)
    for s in (0, 1, 2, 5, 6, 2):
        got, want = pf.get(s), ref.get(s)
        assert torch.equal(got["tokens"], src.batch(s)["tokens"])
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))
        assert sorted(pf._buf) == sorted(ref._buf)
        assert min(pf._buf) == s + 1


def test_put_batch_keeps_host_tensors_on_the_cpu():
    b = {"tokens": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    assert put_batch(b, "cpu")["tokens"] is b["tokens"]


# --- runtime fault tolerance ---------------------------------------------------


def test_straggler_monitor_flags_what_the_reference_flags():
    times = np.random.default_rng(0).lognormal(0.0, 0.8, 200).tolist()
    times[50] = times[120] = 40.0
    for threshold in (2.0, 3.0):
        got = RT.StragglerMonitor(threshold=threshold)
        want = JRT.StragglerMonitor(threshold=threshold)
        assert ([got.observe(t) for t in times]
                == [want.observe(t) for t in times])
        assert got.flagged == want.flagged > 0
        assert got.ewma == want.ewma


def test_straggler_monitor_flags_outliers():
    m = RT.StragglerMonitor(threshold=2.0)
    for _ in range(5):
        assert not m.observe(1.0)
    assert m.observe(5.0)  # 5x the EWMA
    assert m.flagged == 1
    assert not m.observe(1.0)  # recovery


@pytest.mark.parametrize("fail_at,fails,restore_to", [
    (3, 2, 2), (0, 1, 0), (5, 3, 4)])
def test_run_with_restarts_follows_the_reference(fail_at, fails, restore_to):
    def schedule(rt):
        calls, left, restarts = [], {"n": fails}, []

        def step(s):
            if s == fail_at and left["n"] > 0:
                left["n"] -= 1
                raise RuntimeError("boom")
            calls.append(s)

        end = rt.run_with_restarts(
            step, 0, 6, lambda: restore_to, max_restarts=3,
            on_restart=lambda s, e: restarts.append((s, str(e))))
        return end, calls, restarts

    got = schedule(RT)
    assert got == schedule(JRT)
    assert got[0] == 6 and got[1][-1] == 5
    assert len(got[2]) == fails


def test_run_with_restarts_crash_loop_raises():
    def step(s):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError, match="always"):
        RT.run_with_restarts(step, 0, 3, lambda: 0, max_restarts=2)


def test_step_journal(tmp_path):
    j = RT.StepJournal(str(tmp_path / "sub" / "j.jsonl"))
    assert j.last_step() is None
    j.append(1, loss=2.0)
    j.append(2, loss=1.5, straggler=False)
    assert j.last_step() == 2
    recs = [json.loads(line) for line in open(tmp_path / "sub" / "j.jsonl")]
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[1]["loss"] == 1.5 and recs[1]["straggler"] is False
    assert all("time" in r for r in recs)


# --- checkpointing --------------------------------------------------------------


def _tree():
    return {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "blocks.0.scale": torch.tensor([0.5, -1.25],
                                                      dtype=torch.bfloat16)},
            "opt": {"mu": {"w": torch.full((2, 3), 0.25)},
                    "step": torch.tensor(7, dtype=torch.int32)},
            "ids": torch.tensor([1, 2, 3])}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _same(a, b):
    la, lb = CK.flatten(a), CK.flatten(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    path = CK.save(str(tmp_path), 7, t)
    assert path.endswith("step_000000007")
    assert CK.latest_step(str(tmp_path)) == 7
    _same(CK.restore(str(tmp_path), 7, t), t)
    meta = json.load(open(os.path.join(path, "treedef.json")))
    assert meta["step"] == 7 and meta["n_leaves"] == 5
    assert [m["name"] for m in meta["leaves"]] == [
        n for n, _ in CK.flatten(t)]


def test_checkpoint_stores_bf16_as_its_bits(tmp_path):
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 5)).astype(np.float32)).to(torch.bfloat16)
    path = CK.save(str(tmp_path), 1, {"w": w})
    meta = json.load(open(os.path.join(path, "treedef.json")))
    assert meta["leaves"] == [{"name": "w", "dtype": "bfloat16",
                               "shape": [4, 5]}]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert z["leaf_0"].dtype == np.uint16
        np.testing.assert_array_equal(
            z["leaf_0"], w.view(torch.int16).numpy().view(np.uint16))
    back = CK.restore(str(tmp_path), 1, {"w": torch.zeros_like(w)})["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, w)


def test_checkpoint_keep_k_and_atomicity(tmp_path):
    t = _tree()
    for s in range(5):
        CK.save(str(tmp_path), s, t, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000003", "step_000000004"]
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    # a save killed before its commit leaves a .tmp that is not "latest"
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert CK.latest_step(str(tmp_path)) == 4
    CK.save(str(tmp_path), 9, t, keep=2)  # the stale staging is replaced
    assert CK.latest_step(str(tmp_path)) == 9
    assert not (tmp_path / "step_000000009.tmp").exists()


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    ck = CK.AsyncCheckpointer(str(tmp_path), keep=3)
    t = _tree()
    want = _clone(t)
    ck.save_async(1, t)
    with torch.no_grad():  # the train loop updates in place meanwhile
        t["params"]["w"].add_(100.0)
        t["opt"]["step"].fill_(8)
    ck.wait()
    assert CK.latest_step(str(tmp_path)) == 1
    _same(CK.restore(str(tmp_path), 1, t), want)


def test_checkpoint_async_surfaces_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = CK.AsyncCheckpointer(str(blocker / "ckpt"))
    ck.save_async(1, _tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # raised once


def test_checkpoint_restores_onto_another_device(tmp_path):
    """Placement follows ``device``, else ``like``: a model laid out on
    the meta device (nothing allocated) restores onto the CPU, and a CPU
    state onto the meta device."""
    t = _tree()
    CK.save(str(tmp_path), 2, t)
    on_meta = CK.restore(str(tmp_path), 2, t, device="meta")
    assert all(x.device.type == "meta" for _, x in CK.flatten(on_meta))
    _same(CK.restore(str(tmp_path), 2, on_meta, device="cpu"), t)
    assert all(x.device.type == "meta" for _, x in CK.flatten(
        CK.restore(str(tmp_path), 2, on_meta)))


def test_checkpoint_refuses_another_tree(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 3, t)
    with pytest.raises(ValueError, match="differ"):
        CK.restore(str(tmp_path), 3, {"params": t["params"]})
    bad = _tree()
    bad["params"]["w"] = torch.zeros((3, 2))
    with pytest.raises(ValueError, match="params/w"):
        CK.restore(str(tmp_path), 3, bad)
    with pytest.raises(ValueError, match="strings without"):
        CK.save(str(tmp_path), 4, {"a/b": torch.zeros(1)})


# --- the training driver ---------------------------------------------------------


def _train(args, timeout=300):
    """``python -m repro_torch.launch.train ... --device cpu`` in a child
    (the port imports no JAX, so the child needs no JAX_PLATFORMS pin)."""
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR")
           if k in os.environ}
    # one thread: the smoke model's tensors are tiny, and the test
    # workers beside the child already hold the cores
    env.update(PYTHONPATH="src", OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--device", "cpu"], capture_output=True, text=True,
        timeout=timeout, cwd=REPO_ROOT, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


def test_train_driver_with_induced_failure(tmp_path):
    out = _train(["--arch", "llama3.2-1b", "--smoke", "--steps", "25",
                  "--global-batch", "4", "--seq-len", "32",
                  "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
                  "--induce-failure", "15"])
    assert "[train] step 15 failed: induced failure at step 15; " \
           "restoring" in out
    assert "[train] restarted from step 10" in out
    assert "[train] done; straggler count:" in out
    # the journal shows the replayed region
    steps = [json.loads(line)["step"]
             for line in open(tmp_path / "journal.jsonl")]
    assert steps.count(12) == 2  # once before the crash, once after restore
    assert max(steps) == 24
    assert CK.latest_step(str(tmp_path)) == 20


def test_train_driver_resume_from_checkpoint(tmp_path):
    args = ["--arch", "xlstm-125m", "--smoke", "--global-batch", "2",
            "--seq-len", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5"]
    _train(args + ["--steps", "12"])
    out = _train(args + ["--steps", "14"])
    assert "[train] resumed from step 10" in out
    steps = [json.loads(line)["step"]
             for line in open(tmp_path / "journal.jsonl")]
    assert steps == list(range(12)) + [10, 11, 12, 13]


def test_train_driver_refuses_a_mesh(monkeypatch):
    """A mesh runs under torch.distributed.run, whose world size must be
    data x model (the sharded driver itself: tests/test_torch_sharded.py)."""
    from repro_torch.launch.train import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="the world size is unset"):
        main(["--smoke", "--data-mesh", "2", "--device", "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="runs 4 ranks"):
        main(["--smoke", "--data-mesh", "2", "--model-mesh", "2",
              "--device", "cpu"])
