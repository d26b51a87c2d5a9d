"""The PyTorch port's serving path against the JAX reference.

The fractal-sort scheduler must admit requests in the reference's order,
and the port's ``serve()`` loop must generate, request for request, the
tokens of the reference's loop (``repro.launch.serve.main``'s body, driven
here with the reference's jitted ``make_decode_step`` and scheduler) on
weights carried over by ``params_from_jax``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import train_lib as JTL
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as S
from repro_torch.models.convert import params_from_jax


@pytest.fixture(autouse=True)
def _empty_autotune_cache(tmp_path, monkeypatch):
    """All-defaults sorts resolve their plan through the autotune cache:
    an empty one gives the static plans, whatever cache the machine
    holds."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "tune_torch.json"))


def _reference_serve(params, cfg, requests, batch_slots, max_len):
    """The decode loop of ``repro.launch.serve.main``, as written there."""
    decode = jax.jit(JTL.make_decode_step(cfg))
    sched = jserve.FractalScheduler()
    for r in requests:
        sched.add(r)
    B = batch_slots
    cache = JT.init_cache(cfg, B, max_len, jnp.float32)
    slots = [None] * B
    pos = np.zeros(B, np.int64)
    done = steps = 0

    def refill():
        for b in range(B):
            if slots[b] is None:
                nxt = sched.take(1)
                if nxt:
                    slots[b] = nxt[0]
                    pos[b] = 0

    refill()
    while done < len(requests) and steps < 10_000:
        steps += 1
        feed = np.zeros((B, 1), np.int32)
        for b, r in enumerate(slots):
            if r is None:
                continue
            if pos[b] < len(r.prompt):
                feed[b, 0] = r.prompt[pos[b]]
            else:
                feed[b, 0] = r.out[-1] if r.out else 0
        nxt, cache = decode(params, cache, jnp.asarray(feed),
                            jnp.asarray(int(pos.max())))
        nxt = np.asarray(nxt)
        for b, r in enumerate(slots):
            if r is None:
                continue
            pos[b] += 1
            if pos[b] >= len(r.prompt):
                r.out.append(int(nxt[b, 0]))
            if len(r.out) >= r.max_new or pos[b] >= max_len - 1:
                slots[b] = None
                done += 1
        refill()
    return requests


@pytest.mark.parametrize("lengths", [
    [(5, 7), (14, 4), (4, 11), (9, 9), (12, 6), (5, 7), (15, 11), (4, 4)],
    [(8, 8)] * 6,  # all tied: arrival order
    [(60000, 9000), (3, 4), (70000, 1), (3, 4)],  # keys clamp at 2**16 - 1
])
@pytest.mark.parametrize("take", [1, 3])
def test_scheduler_order_matches_reference(lengths, take):
    sched, jsched = S.FractalScheduler(device="cpu"), jserve.FractalScheduler()
    for rid, (plen, max_new) in enumerate(lengths):
        prompt = np.zeros(plen, np.int32)
        sched.add(S.Request(rid, prompt, max_new))
        jsched.add(jserve.Request(rid, prompt, max_new))
    got, want = [], []
    while sched.queue or jsched.queue:
        got.append([r.rid for r in sched.take(take)])
        want.append([r.rid for r in jsched.take(take)])
    assert got == want
    assert sched.take(take) == []


def _serve_both(arch, num_requests, batch_slots, seed=0):
    """The port's serve() and the reference's loop on the smoke config of
    ``arch``, one weight set, the same requests."""
    cfg = smoke_config(get_config(arch))
    jcfg = jsmoke_config(jget_config(arch))
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    requests = S.make_requests(num_requests, cfg.vocab,
                               np.random.default_rng(seed))
    jrequests = [jserve.Request(r.rid, r.prompt, r.max_new)
                 for r in copy.deepcopy(requests)]
    got = S.serve(model, requests, batch_slots=batch_slots, max_len=96)
    want = _reference_serve(jparams, jcfg, jrequests, batch_slots, 96)
    assert [r.rid for r in got] == [r.rid for r in want]
    for r, w in zip(got, want):
        assert len(r.out) == r.max_new, r
        assert r.out == w.out, r.rid
    return got


def test_serve_matches_reference_loop(capsys):
    _serve_both("llama3.2-1b", 6, 3)
    printed = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[serve] rid=") for line in printed) == 6
    assert printed[-1].startswith("[serve] 6/6 requests")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_serve_recurrent_families_match_reference_loop(arch, capsys):
    """Mamba and xLSTM states through the loop, token for token with the
    reference, whose faults the port keeps: one decode position for every
    slot, and a refilled slot inherits its predecessor's recurrent state."""
    _serve_both(arch, 6, 3, seed=1)
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "[serve] 6/6 requests")
