"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory with
exponential gating and a stabilizer state), per arXiv:2405.04517 (port of
``repro.models.xlstm``).

sLSTM's gates read h_{t-1}, so its prefill is a token loop (its input
projections are taken for the whole sequence first); the mLSTM runs
chunkwise-parallel (``cfg.mlstm_chunk``) or as a token loop.  Decode is
the same cell applied once.  All state is O(1) in sequence length.  The
math runs on plain torch ops: there is no TPU kernel on this path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

__all__ = ["MLSTM", "mlstm_cell", "mlstm_init_state", "mlstm_apply_recurrent",
           "mlstm_apply_chunked", "mlstm_apply", "SLSTM", "slstm_cell",
           "slstm_init_state", "slstm_apply"]


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


def mlstm_cell(p: MLSTM, cfg: ModelConfig, x_t, state: dict):
    """One step.  x_t: (B, D); state: C (B, nh, dh, dh), n (B, nh, dh) in
    the model's dtype, m (B, nh) fp32.  Returns (out (B, D), new state)."""
    nh, dh = _head_dims(cfg)
    B, D = x_t.shape
    q = (x_t @ p.wq).reshape(B, nh, dh) / math.sqrt(dh)
    k = (x_t @ p.wk).reshape(B, nh, dh) / math.sqrt(dh)
    v = (x_t @ p.wv).reshape(B, nh, dh)
    log_i = (x_t @ p.wi).float()  # (B, nh)
    log_f = F.logsigmoid((x_t @ p.wf + p.f_bias).float())
    m_new = torch.maximum(log_f + state["m"], log_i)
    # the gates go back to the model's dtype before they are used
    i_g = torch.exp(log_i - m_new).to(x_t.dtype)
    f_g = torch.exp(log_f + state["m"] - m_new).to(x_t.dtype)
    C = f_g[..., None, None] * state["C"] + i_g[..., None, None] * (
        v[..., :, None] * k[..., None, :])  # (B, nh, dh_v, dh_k)
    n = f_g[..., None] * state["n"] + i_g[..., None] * k
    h_num = torch.einsum("bhvk,bhk->bhv", C, q)
    h_den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)),
                        min=1.0)
    h = (h_num / h_den[..., None]).reshape(B, D)
    return h @ p.wo, {"C": C, "n": n, "m": m_new}


def mlstm_init_state(cfg: ModelConfig, B: int, dtype, device) -> dict:
    nh, dh = _head_dims(cfg)
    return {
        "C": torch.zeros((B, nh, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((B, nh, dh), dtype=dtype, device=device),
        "m": torch.zeros((B, nh), dtype=torch.float32, device=device),
    }


def mlstm_apply_recurrent(p: MLSTM, cfg: ModelConfig, x):
    """x: (B, S, D), a token loop (the reference; S sequential steps)."""
    B, S, _ = x.shape
    state = mlstm_init_state(cfg, B, x.dtype, x.device)
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
    nh, dh = _head_dims(cfg)
    B, S, D = x.shape
    L_ = min(chunk, S)
    pad = (-S) % L_
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    nc = xp.shape[1] // L_

    q = (xp @ p.wq).reshape(B, nc, L_, nh, dh) / math.sqrt(dh)
    k = (xp @ p.wk).reshape(B, nc, L_, nh, dh) / math.sqrt(dh)
    v = (xp @ p.wv).reshape(B, nc, L_, nh, dh)
    log_i = (xp @ p.wi).float().reshape(B, nc, L_, nh)
    log_f = F.logsigmoid((xp @ p.wf + p.f_bias).float()).reshape(
        B, nc, L_, nh)
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
    return h.to(x.dtype) @ p.wo


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


def _slstm_step(p: SLSTM, xs: tuple, state: dict):
    """The cell on precomputed input projections ``xs`` = (x @ sz, x @ si,
    x @ sf, x @ so) of one token, each (B, D)."""
    xz, xi, xf, xo = xs
    h_prev = state["h"]
    z = torch.tanh(xz + h_prev @ p.rz)
    o = torch.sigmoid(xo + h_prev @ p.ro)
    log_i = (xi + h_prev @ p.ri).float()
    log_f = F.logsigmoid((xf + h_prev @ p.rf + p.f_bias).float())
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
    Returns (h, new state)."""
    return _slstm_step(p, tuple(x_t @ getattr(p, f"s{g}") for g in _GATES),
                       state)


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
    are taken before it."""
    B, S, _ = x.shape
    xs = tuple(x @ getattr(p, f"s{g}") for g in _GATES)
    state = slstm_init_state(cfg, B, x.dtype, x.device)
    ys = []
    for t in range(S):
        h, state = _slstm_step(p, tuple(a[:, t] for a in xs), state)
        ys.append(h)
    return torch.stack(ys, dim=1)
