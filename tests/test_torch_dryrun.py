"""The port's dry-run (``repro_torch.launch.dryrun``) and its recorder
(``repro_torch.launch.comm_stats``) against the reference's
``repro.launch.hlo_stats`` and against arithmetic.

* ``_wire_bytes`` and ``summarize`` equal the reference's on the same
  collectives (``repro.launch.hlo_stats`` imports no jax);
* in one subprocess (the fake process group stays in a process's
  ``torch.distributed`` state, so no test worker holds it), smoke
  llama3.2-1b at 16 heads (KV heads 4: the KV-gather path, as the full
  config's 8 on 16) and two layers on a fake 16 x 16 group:
  - prefill: attention, MLP and head FLOPs of rank 0 are the one-rank
    program's / (data * model), exactly; ``argument_bytes`` is the sum of
    the local shards of ``param_specs`` and of the batch shard; the
    collectives by kind are the analytic count per layer;
  - train (``train_4k`` at the same sizes): the loss's FLOPs (the head's
    product in ``chunked_ce``) of rank 0 are the one-rank loss's /
    (data * model), exactly;
  - decode (the serving policy: weights over `model` only): the
    collectives by kind per layer;
* the full-size llama3.2-1b ``train_4k`` cell completes with the
  reference's result keys.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.launch import hlo_stats as H
from repro_torch import sharding as SH
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import comm_stats as C
from repro_torch.launch import dryrun as D
from repro_torch.models import transformer as T

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "llama3.2-1b"
LAYERS = 2
MESH = {"data": 16, "model": 16}
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _overrides() -> dict:
    """Smoke llama3.2-1b's fields, at 16 heads of which 4 KV heads and
    ``LAYERS`` layers, attention in one chunk (its FLOPs do not depend on
    the chunks; their number is the run's op count)."""
    full, small = get_config(ARCH), smoke_config(get_config(ARCH))
    over = {f.name: getattr(small, f.name) for f in dataclasses.fields(full)
            if f.name != "name" and getattr(small, f.name) != getattr(
                full, f.name)}
    over.update(n_layers=LAYERS, n_heads=16, n_kv_heads=4,
                attn_chunk_q=1 << 15, attn_chunk_kv=1 << 15)
    return over


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_match_reference(kind):
    for rb, d in ((4096, 1), (4096, 2), (12345, 16), (1 << 20, 512)):
        assert C._wire_bytes(kind, rb, d) == H._wire_bytes(kind, rb, d)


def test_summarize_matches_reference():
    rng = np.random.default_rng(25)
    rows = [(KINDS[int(rng.integers(len(KINDS)))], int(rng.integers(1, 1 << 20)),
             int(rng.choice([2, 16, 256])), int(rng.integers(1, 8)))
            for _ in range(40)]
    ours = [C.CollectiveOp(k, rb, d, C._wire_bytes(k, rb, d) * m, m)
            for k, rb, d, m in rows]
    ref = [H.CollectiveOp(k, rb, d, H._wire_bytes(k, rb, d) * m, m)
           for k, rb, d, m in rows]
    assert C.summarize(ours) == H.summarize(ref)


_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    sys.path.insert(0, "tests")
    from test_torch_dryrun import ARCH, _overrides
    from repro_torch import train_lib as TL
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.comm_stats import CommStats
    from repro_torch.models import layers as L, transformer as T
    import dataclasses
    from repro_torch.configs import get_config

    flops = {}

    def scoped(module, name):
        fn = getattr(module, name)

        def run(*a, **kw):
            inner = CommStats()
            with inner:
                out = fn(*a, **kw)
            flops[name] = flops.get(name, 0) + inner.flops
            return out
        setattr(module, name, run)

    for module, name in ((L, "attn_apply"), (L, "mlp_apply"),
                         (T, "head_logits"), (TL, "chunked_ce")):
        scoped(module, name)
    over = _overrides()
    out = {"prefill": D.dry_run_cell(ARCH, "prefill_32k", False,
                                     overrides=over)}
    out["tp_flops"] = dict(flops)
    flops.clear()
    out["train"] = D.dry_run_cell(ARCH, "train_4k", False, overrides=over)
    out["tp_flops"]["chunked_ce"] = flops.pop("chunked_ce")
    flops.clear()
    cfg = dataclasses.replace(get_config(ARCH), **over)
    model = T.Transformer(cfg, device="meta", dtype=D.PARAM_DTYPE)
    with torch.inference_mode():
        T.forward(model, cfg, D.input_specs(ARCH, "prefill_32k",
                                            cfg)["tokens"])
        out["one_flops"] = dict(flops)
        flops.clear()
        TL.loss_fn(model, cfg, D.input_specs(ARCH, "train_4k", cfg))
    out["one_flops"]["chunked_ce"] = flops.pop("chunked_ce")
    out["decode"] = D.dry_run_cell(ARCH, "decode_32k", False, overrides=over)
    out["train_full"] = D.dry_run_cell(ARCH, "train_4k", False)
    json.dump(out, sys.stdout)
""")


@pytest.fixture(scope="module")
def cells():
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env.update(PYTHONPATH="src", OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout[run.stdout.index("{"):])


def test_dense_flops_split_over_data_and_model(cells):
    """Rank 0's attention and MLP FLOPs are the one-rank program's over
    data * model = 256, exactly: q, k, v, o and the MLP products and the
    attention itself all split."""
    for name in ("attn_apply", "mlp_apply"):
        assert cells["one_flops"][name] > 0
        assert cells["tp_flops"][name] * 256 == cells["one_flops"][name], name


def test_head_and_loss_flops_split_over_data_and_model(cells):
    """Rank 0's head FLOPs (prefill: the logits) and loss FLOPs (train:
    ``chunked_ce``'s forward, the tied head's product a chunk) are the
    one-rank program's over data * model = 256, exactly: the tokens split
    over `data`, the vocab over `model` (the head no longer whole on every
    `model` rank)."""
    for name in ("head_logits", "chunked_ce"):
        assert cells["one_flops"][name] > 0
        assert cells["tp_flops"][name] * 256 == cells["one_flops"][name], name


def test_argument_bytes_are_the_local_shards(cells):
    cfg = dataclasses.replace(get_config(ARCH), **_overrides())
    meta = T.Transformer(cfg, device="meta", dtype=D.PARAM_DTYPE)
    specs = SH.param_specs(meta, cfg, MESH)
    want = sum(p.numel() * p.element_size() // math.prod(
        MESH[a] for ax in specs[n] for a in SH.entry_axes(ax))
        for n, p in meta.named_parameters())
    tokens = D.input_specs(ARCH, "prefill_32k", cfg)["tokens"]
    want += tokens.numel() * tokens.element_size() // MESH["data"]
    assert cells["prefill"]["memory"]["argument_bytes"] == want


def _counts(res) -> dict:
    return {k: v["count"] for k, v in res["collectives"]["by_kind"].items()}


def test_prefill_collectives_per_layer(cells):
    """Per layer: wq, wk, wv, wo, wi, wg, wd gathered over `data` (7),
    k and v over `model` (4 KV heads on 16 ranks: 2); one all-reduce
    over `model` after wo and one after wd.  The tied embedding keeps its
    vocab split over `model`: gathered over `data` only for the lookup
    (1), whose masked rows are summed over `model` (1 all-reduce), and
    again for the head (1), which gives this rank's vocab columns."""
    assert _counts(cells["prefill"]) == {"all-gather": 9 * LAYERS + 2,
                                         "all-reduce": 2 * LAYERS + 1}


def test_decode_collectives_per_layer(cells):
    """The serving policy stores the weights over `model` only: per layer
    the new token's q, k, v gathered over `model` (3), split-KV's MAX and
    two SUMs over `model` (3), the sums after wo and wd (2).  The tied
    embedding keeps its vocab split and needs no gather: the lookup's
    masked rows summed over `model` (1 all-reduce); the head gives this
    rank's vocab columns, whose (max, argmax) pairs are gathered over
    `model` for the next token (1 all-gather)."""
    assert _counts(cells["decode"]) == {"all-gather": 3 * LAYERS + 1,
                                        "all-reduce": 5 * LAYERS + 1}


def test_full_size_train_cell_completes(cells):
    res = cells["train_full"]
    assert set(res) == {
        "arch", "shape", "mesh", "n_devices", "kind", "trace_seconds",
        "flops_per_device", "bytes_read_per_device",
        "bytes_written_per_device", "collectives", "memory", "params_total",
        "params_active"}
    assert (res["mesh"], res["n_devices"], res["kind"]) == ("16x16", 256,
                                                            "train")
    assert res["flops_per_device"] > 0 and res["collectives"]["count"] > 0
    assert set(res["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes", "code_bytes"}
    # the parameters' and moments' shards: 1.24 B params, bf16 + 2 fp32
    assert 0 < res["memory"]["argument_bytes"] < 1.24e9 * 10 / 256 * 2
