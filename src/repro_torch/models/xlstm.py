"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory with
exponential gating and a stabilizer state), per arXiv:2405.04517 (port of
``repro.models.xlstm``).

sLSTM's gates read h_{t-1}, so its prefill is a token loop (its input
projections are taken for the whole sequence first); the mLSTM runs
chunkwise-parallel (``cfg.mlstm_chunk``) or as a token loop.  Decode is
the same cell applied once.  All state is O(1) in sequence length.  The
math runs on plain torch ops: there is no TPU kernel on this path.

Under a mesh (:mod:`.act_sharding`), for a model stored by spec, both run
on this rank's `model` slice, as the reference's specs split them:

* mLSTM: ``wq``, ``wk``, ``wv`` column-parallel and ``wo`` row-parallel
  on this rank's n_heads / m heads; the gates ``wi``, ``wf`` (unsplit
  over `model`) give this rank's heads' columns.  Where `model` does not
  divide n_heads (xlstm-125m's 4 on 16) the mixer runs whole, as
  attention does.  Decode gathers the token's q, k and v whole over
  `model`, steps every head's (whole) state and runs ``wo`` on its rows;
* sLSTM: ``s?`` and ``r?`` column-parallel on this rank's D / m units.
  Each token's gates read the whole h_{t-1}: this rank's h_t is gathered
  over `model` once a token (backward: reduce-scattered, summed: each
  rank's ``r?`` product gives a part of its gradient), and the layer's
  output, the stacked local h's, once over `model` with a slice-keeping
  backward (what follows is replicated).  Decode steps this rank's units
  and gathers the new state back whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.act_sharding import (fsdp_gather, gather_model,
                                             get_mesh, mesh_sizes,
                                             model_rank, model_size,
                                             tp_copy, tp_names, tp_sum)

__all__ = ["MLSTM", "mlstm_cell", "mlstm_decode", "mlstm_init_state",
           "mlstm_apply_recurrent", "mlstm_apply_chunked", "mlstm_apply",
           "SLSTM", "slstm_cell", "slstm_init_state", "slstm_apply"]


def _head_dims(cfg: ModelConfig):
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    return nh, dh


# ---------------------------------------------------------------------------
# mLSTM: per-head matrix memory C (dh x dh), normalizer n, stabilizer m
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """wq, wk, wv, wo (D, D); per-head gates wi, wf (D, nh); f_bias (nh,)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        nh, _ = _head_dims(cfg)
        self.n_heads = nh
        D = cfg.d_model
        for name, shape in (("wq", (D, D)), ("wk", (D, D)), ("wv", (D, D)),
                            ("wi", (D, nh)), ("wf", (D, nh)), ("wo", (D, D)),
                            ("f_bias", (nh,))):
            setattr(self, name, L.empty_param(shape, dtype, device))

    def init_params(self, generator: torch.Generator) -> None:
        """Dense weights normal / sqrt(D); forget bias 3 (forget-dominant)."""
        for name in ("wq", "wk", "wv", "wi", "wf", "wo"):
            L.dense_init(getattr(self, name), generator)
        self.f_bias.fill_(3.0)

    def tp_weights(self) -> tuple:
        """The weights kept split over `model` (this rank's heads) while
        the mixer runs: wq, wk, wv and wo under a mesh whose `model` size
        divides n_heads, for a model stored by spec with their heads split
        over `model`; none otherwise (gathered whole, compute replicated).
        The gates stay unsplit, as the reference's specs keep them."""
        if (get_mesh() is None
                or not SH.splits_heads(self.n_heads, mesh_sizes())
                or not all(SH.names_model(getattr(w, "shard_spec", None), d)
                           for w, d in ((self.wq, -1), (self.wo, 0)))):
            return ()
        return ("wq", "wk", "wv", "wo")


def _mlstm_inputs(p: MLSTM, cfg: ModelConfig, x, whole: bool = False):
    """q, k (scaled by 1/sqrt(dh)) and v (..., H, dh) in x's dtype and the
    log gates log_i, log_f (..., H) fp32 of x (..., D): every head; on the
    `model` slice this rank's n_heads / m heads, or with ``whole`` every
    head, q, k and v gathered over `model` (decode)."""
    nh, dh = _head_dims(cfg)
    wi, wf, f_bias = p.wi, p.wf, p.f_bias
    if tp_names(p):
        x = tp_copy(x)
        q, k, v = (x @ fsdp_gather(w, -1) for w in (p.wq, p.wk, p.wv))
        if whole:
            q, k, v = (gather_model(t, -1) for t in (q, k, v))
        else:  # this rank's heads' gates: each rank's give a part of the
            # gates' gradients
            hl = nh // model_size()
            lo = model_rank() * hl
            wi, wf = (tp_copy(w)[:, lo:lo + hl] for w in (wi, wf))
            f_bias = tp_copy(f_bias)[lo:lo + hl]
    else:
        q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    heads = x.shape[:-1] + (-1, dh)
    q = q.reshape(heads) / math.sqrt(dh)
    k = k.reshape(heads) / math.sqrt(dh)
    v = v.reshape(heads)
    log_i = (x @ wi).float()
    log_f = F.logsigmoid((x @ wf + f_bias).float())
    return q, k, v, log_i, log_f


def _mlstm_out(p: MLSTM, h):
    """The output projection of h (..., H * dh): on the `model` slice
    row-parallel, summed over `model`."""
    out = h @ fsdp_gather(p.wo, 0)
    return tp_sum(out) if tp_names(p) else out


def _mlstm_step(q, k, v, log_i, log_f, state: dict):
    """One step of the recurrence on the heads given: q, k, v (B, H, dh),
    log_i, log_f (B, H) fp32.  Returns (h (B, H * dh), new state)."""
    B = q.shape[0]
    m_new = torch.maximum(log_f + state["m"], log_i)
    # the gates go back to the model's dtype before they are used
    i_g = torch.exp(log_i - m_new).to(v.dtype)
    f_g = torch.exp(log_f + state["m"] - m_new).to(v.dtype)
    C = f_g[..., None, None] * state["C"] + i_g[..., None, None] * (
        v[..., :, None] * k[..., None, :])  # (B, H, dh_v, dh_k)
    n = f_g[..., None] * state["n"] + i_g[..., None] * k
    h_num = torch.einsum("bhvk,bhk->bhv", C, q)
    h_den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)),
                        min=1.0)
    h = (h_num / h_den[..., None]).reshape(B, -1)
    return h, {"C": C, "n": n, "m": m_new}


def mlstm_cell(p: MLSTM, cfg: ModelConfig, x_t, state: dict):
    """One step.  x_t: (B, D); state: C (B, H, dh, dh), n (B, H, dh) in
    the model's dtype, m (B, H) fp32, over every head, or on the `model`
    slice this rank's.  Returns (out (B, D), new state)."""
    h, state = _mlstm_step(*_mlstm_inputs(p, cfg, x_t), state)
    return _mlstm_out(p, h), state


def mlstm_decode(p: MLSTM, cfg: ModelConfig, x_t, state: dict):
    """:func:`mlstm_cell` on the state of every head (the decode cache,
    whole over `model`): on the `model` slice the token's q, k and v are
    gathered whole, every rank steps every head, and ``wo`` runs on this
    rank's heads' rows."""
    h, state = _mlstm_step(*_mlstm_inputs(p, cfg, x_t, whole=True), state)
    if tp_names(p):
        width = h.shape[-1] // model_size()
        h = h.narrow(-1, model_rank() * width, width)
    return _mlstm_out(p, h), state


def _mlstm_state(B: int, nh: int, dh: int, dtype, device) -> dict:
    return {
        "C": torch.zeros((B, nh, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((B, nh, dh), dtype=dtype, device=device),
        "m": torch.zeros((B, nh), dtype=torch.float32, device=device),
    }


def mlstm_init_state(cfg: ModelConfig, B: int, dtype, device) -> dict:
    return _mlstm_state(B, *_head_dims(cfg), dtype, device)


def mlstm_apply_recurrent(p: MLSTM, cfg: ModelConfig, x):
    """x: (B, S, D), a token loop (the reference; S sequential steps)."""
    B, S, _ = x.shape
    nh, dh = _head_dims(cfg)
    if tp_names(p):
        nh //= model_size()
    state = _mlstm_state(B, nh, dh, x.dtype, x.device)
    ys = []
    for t in range(S):
        out, state = mlstm_cell(p, cfg, x[:, t], state)
        ys.append(out)
    return torch.stack(ys, dim=1)


def mlstm_apply_chunked(p: MLSTM, cfg: ModelConfig, x, chunk: int):
    """Chunkwise-parallel mLSTM.

    Within a chunk of L tokens the recurrence unrolls to an
    attention-like quadratic form; across chunks only the (B, nh, dh, dh)
    matrix state and the (B, nh, dh) normalizer are carried, in fp32.
    All gate math is fp32 with the max-stabilizer."""
    B, S, D = x.shape
    L_ = min(chunk, S)
    pad = (-S) % L_
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    nc = xp.shape[1] // L_

    q, k, v, log_i, log_f = _mlstm_inputs(p, cfg, xp)
    nh, dh = q.shape[-2:]  # this rank's heads on the `model` slice
    q, k, v = (t.reshape(B, nc, L_, nh, dh) for t in (q, k, v))
    log_i, log_f = (t.reshape(B, nc, L_, nh) for t in (log_i, log_f))
    causal = torch.tril(torch.ones((L_, L_), dtype=torch.bool,
                                   device=x.device))

    C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
    m = torch.zeros((B, nh), dtype=torch.float32, device=x.device)
    hs = []
    for c in range(nc):
        qc, kc, vc = (t[:, c].float() for t in (q, k, v))  # (B, L, nh, dh)
        li, lf = log_i[:, c], log_f[:, c]  # (B, L, nh)
        F_ = torch.cumsum(lf, dim=1)  # inclusive log-forget products
        # stabilizer: max of the carry seen through t forgets (m + F_t) and
        # the intra-chunk max over s <= t of (F_t - F_s + li_s)
        run_max = torch.cummax(li - F_, dim=1).values
        m_new = torch.maximum(m[:, None] + F_, F_ + run_max)  # (B, L, nh)
        # inter-chunk term: exp(m + F_t - m_t) * (q_t . C)
        inter_scale = torch.exp(m[:, None] + F_ - m_new)
        qC = torch.einsum("blhk,bhvk->blhv", qc, C)
        nq = torch.einsum("blhk,bhk->blh", qc, n)
        # intra-chunk weights w[t, s] = exp(F_t - F_s + li_s - m_t), s <= t
        logw = (F_[:, :, None] - F_[:, None, :] + li[:, None, :]
                - m_new[:, :, None])  # (B, L_t, L_s, nh)
        w = torch.where(causal[None, :, :, None], torch.exp(logw), 0.0)
        scores = torch.einsum("bthk,bshk->btsh", qc, kc)
        wa = w * scores
        intra = torch.einsum("btsh,bshv->bthv", wa, vc)
        n_intra = wa.sum(dim=2)  # (B, L, nh)
        h_num = intra + inter_scale[..., None] * qC
        n_tot = n_intra + inter_scale * nq
        hs.append(h_num / torch.clamp(torch.abs(n_tot), min=1.0)[..., None])
        # end-of-chunk state, stabilized at m_last
        m_last = m_new[:, -1]  # (B, nh)
        F_L = F_[:, -1]
        c_decay = torch.exp(m + F_L - m_last)
        # the reference subtracts m_new[:, -1:][:, :1] * 0, a zero term,
        # kept for its rounding (xlstm.py:156)
        s_scale = torch.exp(F_L[:, None] - F_ + li - m_new[:, -1:][:, :1] * 0
                            - m_last[:, None])  # (B, L, nh)
        C = c_decay[..., None, None] * C + torch.einsum(
            "blhv,blhk->bhvk", vc * s_scale[..., None], kc)
        n = c_decay[..., None] * n + (kc * s_scale[..., None]).sum(dim=1)
        m = m_last
    h = torch.stack(hs, dim=1).reshape(B, nc * L_, nh * dh)[:, :S]
    return _mlstm_out(p, h.to(x.dtype))


def mlstm_apply(p: MLSTM, cfg: ModelConfig, x):
    chunk = getattr(cfg, "mlstm_chunk", 0)
    if chunk:
        return mlstm_apply_chunked(p, cfg, x, chunk)
    return mlstm_apply_recurrent(p, cfg, x)


# ---------------------------------------------------------------------------
# sLSTM: scalar memory per unit, recurrent gates, stabilizer
# ---------------------------------------------------------------------------

_GATES = ("z", "i", "f", "o")


class SLSTM(nn.Module):
    """Input weights sz, si, sf, so and recurrent weights rz, ri, rf, ro
    (D, D); f_bias (D,)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        for g in _GATES:
            setattr(self, f"s{g}", L.empty_param((D, D), dtype, device))
            setattr(self, f"r{g}", L.empty_param((D, D), dtype, device))
        self.f_bias = L.empty_param((D,), dtype, device)

    def init_params(self, generator: torch.Generator) -> None:
        """Input weights normal / sqrt(D), recurrent ones normal /
        (4 sqrt(D)); forget bias 3."""
        D = self.f_bias.shape[0]
        for g in _GATES:
            L.dense_init(getattr(self, f"s{g}"), generator)
            L.dense_init(getattr(self, f"r{g}"), generator,
                         1.0 / math.sqrt(D) / 4)
        self.f_bias.fill_(3.0)

    def tp_weights(self) -> tuple:
        """The weights kept split over `model` (this rank's D / m units)
        while the mixer runs: the input and recurrent weights under a
        mesh, for a model stored by spec with their columns split over
        `model`; none otherwise (gathered whole, compute replicated)."""
        names = tuple(f"{k}{g}" for k in "sr" for g in _GATES)
        if get_mesh() is None or not all(SH.names_model(getattr(
                getattr(self, n), "shard_spec", None), -1) for n in names):
            return ()
        return names


def _slstm_weights(p: SLSTM):
    """(the recurrent weights (rz, ri, rf, ro), f_bias, this rank's first
    unit or None) as the cell uses them: whole, or on the `model` slice
    this rank's units' columns (gathered over the batch axes only) and
    f_bias's slice."""
    r = tuple(fsdp_gather(getattr(p, f"r{g}"), -1) for g in _GATES)
    if not tp_names(p):
        return r, p.f_bias, None
    d = r[0].shape[-1]
    lo = model_rank() * d
    return r, tp_copy(p.f_bias).narrow(0, lo, d), lo


def _slstm_inputs(p: SLSTM, x):
    """The input projections (x @ sz, x @ si, x @ sf, x @ so), on the
    `model` slice this rank's units' columns."""
    if tp_names(p):
        x = tp_copy(x)
    return tuple(x @ fsdp_gather(getattr(p, f"s{g}"), -1) for g in _GATES)


def _slstm_step(r: tuple, f_bias, xs: tuple, state: dict):
    """The cell on precomputed input projections ``xs`` = (x @ sz, x @ si,
    x @ sf, x @ so) of one token, each (B, d), and the recurrent weights
    ``r`` = (rz, ri, rf, ro) (D, d) of the units given: c, n, m (B, d) of
    those units, h (B, D) the whole h_{t-1}.  Returns (h_t (B, d), the
    new state with it as h)."""
    xz, xi, xf, xo = xs
    rz, ri, rf, ro = r
    h_prev = state["h"]
    z = torch.tanh(xz + h_prev @ rz)
    o = torch.sigmoid(xo + h_prev @ ro)
    log_i = (xi + h_prev @ ri).float()
    log_f = F.logsigmoid((xf + h_prev @ rf + f_bias).float())
    m_new = torch.maximum(log_f + state["m"], log_i)
    # the gates go back to the model's dtype before they are used
    i_g = torch.exp(log_i - m_new).to(xz.dtype)
    f_g = torch.exp(log_f + state["m"] - m_new).to(xz.dtype)
    c = f_g * state["c"] + i_g * z
    n = f_g * state["n"] + i_g
    h = o * c / torch.clamp(n, min=1.0)
    return h, {"c": c, "n": n, "h": h, "m": m_new}


def slstm_cell(p: SLSTM, cfg: ModelConfig, x_t, state: dict):
    """state: c, n, h (B, D) in the model's dtype, m (B, D) fp32.
    Returns (h, new state).  On the `model` slice the step runs on this
    rank's units of the (whole) state, gathered back whole over
    `model`."""
    r, f_bias, lo = _slstm_weights(p)
    xs = _slstm_inputs(p, x_t)
    if lo is None:
        return _slstm_step(r, f_bias, xs, state)
    d = xs[0].shape[-1]
    local = {k: v if k == "h" else v.narrow(-1, lo, d)
             for k, v in state.items()}
    _, new = _slstm_step(r, f_bias, xs, local)
    c, n, h = gather_model(torch.stack([new["c"], new["n"], new["h"]]), -1)
    return h, {"c": c, "n": n, "h": h, "m": gather_model(new["m"], -1)}


def slstm_init_state(cfg: ModelConfig, B: int, dtype, device) -> dict:
    D = cfg.d_model
    return {
        "c": torch.zeros((B, D), dtype=dtype, device=device),
        "n": torch.zeros((B, D), dtype=dtype, device=device),
        "h": torch.zeros((B, D), dtype=dtype, device=device),
        "m": torch.zeros((B, D), dtype=torch.float32, device=device),
    }


def slstm_apply(p: SLSTM, cfg: ModelConfig, x):
    """x: (B, S, D), a token loop; the input projections of every token
    are taken before it.  On the `model` slice each token's h is
    gathered over `model` for the next token's gates, and the output
    once at the end."""
    B, S, _ = x.shape
    r, f_bias, lo = _slstm_weights(p)
    xs = _slstm_inputs(p, x)
    state = slstm_init_state(cfg, B, x.dtype, x.device)
    if lo is not None:
        d = xs[0].shape[-1]
        state = {k: v if k == "h" else v.narrow(-1, lo, d)
                 for k, v in state.items()}
    ys = []
    for t in range(S):
        h, state = _slstm_step(r, f_bias, tuple(a[:, t] for a in xs), state)
        ys.append(h)
        if lo is not None and t + 1 < S:
            state["h"] = gather_model(h, -1)
    out = torch.stack(ys, dim=1)
    return out if lo is None else gather_model(out, -1, replicated=True)
