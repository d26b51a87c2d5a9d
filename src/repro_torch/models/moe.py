"""FractalMoE: top-k mixture of experts with fractal-sort token dispatch
(port of ``repro.models.moe``, one rank).

Routing T tokens to E experts is a ``ceil(log2 E)``-bit key sort; the
fractal pipeline (:func:`~repro_torch.kernels.moe_dispatch.moe_dispatch`,
kernels K1 and K2 on the card; the layer reads its ``moe_ranks`` half)
gives, one read of the ids each:

* ``counts``: each expert's load (the histogram, which is also the
  load-balancing loss's statistic);
* ``rank``: each assignment's slot in expert-grouped order (stable);

and :func:`_dispatch_and_scatter` places the kept assignments into the
capacity-bounded (E, C, D) expert buffer.  The expert products are
batched matrix products, as the reference's einsums are.

The reference's expert-parallel branch (``shard_map`` over a mesh) is
not ported yet: :func:`moe_apply` refuses a mesh.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_dispatch import moe_ranks
from repro_torch.models import layers as L

__all__ = ["MoE", "route", "moe_apply"]


class MoE(nn.Module):
    """router (D, E), fp32 whatever the model's dtype; wi, wg (E, D, F);
    wd (E, F, D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        m = cfg.moe
        E, D, F_ = m.num_experts, cfg.d_model, m.d_ff
        self.router = L.empty_param((D, E), torch.float32, device)
        self.wi = L.empty_param((E, D, F_), dtype, device)
        self.wg = L.empty_param((E, D, F_), dtype, device)
        self.wd = L.empty_param((E, F_, D), dtype, device)

    def init_params(self, generator: torch.Generator) -> None:
        """Normal weights drawn in fp32 and cast, one tensor at a time:
        the router and wi, wg scaled by 1/sqrt(D), wd by 1/sqrt(F)."""
        D, F_ = self.wi.shape[1], self.wi.shape[2]
        L.dense_init(self.router, generator)
        L.dense_init(self.wi, generator, 1.0 / math.sqrt(D))
        L.dense_init(self.wg, generator, 1.0 / math.sqrt(D))
        L.dense_init(self.wd, generator, 1.0 / math.sqrt(F_))


def route(router: torch.Tensor, xf: torch.Tensor, k: int) -> tuple:
    """fp32 routing of tokens ``xf`` (T, D).  Returns (probs (T, E), ids
    (T*k,) int32, w (T*k,) fp32): each token's top-k experts, the larger
    probability first and, among equal ones, the lower expert first (the
    order of ``jax.lax.top_k``), with weights renormalised over the k."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    E = probs.shape[-1]
    # probabilities are >= 0, so their bit patterns order as their values;
    # the low digit breaks ties toward the lower expert, leaving none
    lower_first = E - 1 - torch.arange(E, device=probs.device)
    key = probs.view(torch.int32).to(torch.int64) * E + lower_first
    top_e = torch.topk(key, k, dim=-1).indices
    top_p = probs.gather(-1, top_e)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, top_e.reshape(-1).to(torch.int32), top_p.reshape(-1)


def _dispatch_and_scatter(xf, ids, E: int, C: int, dispatch=moe_ranks):
    """Fractal dispatch and capacity scatter.

    ``xf``: (T, D) tokens repeated over k; ``ids``: (T,) int32 expert
    assignments.  Returns (buf (E, C, D), slot, keep, counts): everything
    the combine gather needs.  An assignment past its expert's C slots is
    dropped: it goes to a sentinel row past the buffer, cut off after the
    scatter (the reference's ``mode="drop"``)."""
    rank, counts, start = dispatch(ids, E)
    ids64 = ids.long()
    slot = rank - start[ids64]  # place in its expert
    keep = slot < C
    flat = torch.where(keep, ids64 * C + slot, E * C)
    buf = xf.new_zeros((E * C + 1, xf.shape[-1]))
    buf[flat] = xf
    return buf[:E * C].view(E, C, xf.shape[-1]), slot, keep, counts


def moe_apply(p: MoE, cfg: ModelConfig, x, *, dispatch=moe_ranks,
              mesh: Optional[object] = None):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux_loss fp32 scalar).

    ``dispatch`` is the (rank, counts, start) function of the ids: the
    fractal kernels by default; ``ref.moe_ranks_ref`` gives the same
    layer on the argsort dispatch, for comparison.  The capacity C is
    taken from this call's token count, so a decode step drops what its
    own few tokens overflow.  A ``mesh`` (expert-parallel sharding) is
    not ported yet and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_apply under a mesh is not ported yet (ROADMAP queue 1, "
            "item 3: the LM's sharding)")
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    T = B * S
    xf = x.reshape(T, D)
    probs, ids, w = route(p.router, xf, k)
    C = max(k, math.ceil(m.capacity_factor * T * k / E))
    xrep = xf.repeat_interleave(k, dim=0)  # row i is token i // k
    buf, slot, keep, counts = _dispatch_and_scatter(xrep, ids, E, C,
                                                    dispatch)
    h = torch.bmm(buf, p.wi)
    g = torch.bmm(buf, p.wg)
    y = torch.bmm(F.silu(g) * h, p.wd)
    # dropped rows gather row (0, 0) and weigh it by 0, as the reference
    # does (a non-finite y[0, 0] poisons them alike)
    rows = torch.where(keep, ids.long() * C + slot, 0)
    ww = torch.where(keep, w, torch.zeros_like(w))
    out = y.reshape(E * C, D)[rows] * ww[:, None].to(y.dtype)
    out = out.reshape(T, k, D).sum(dim=1).reshape(B, S, D)
    # Switch-style load-balancing loss; counts come free with the dispatch
    frac_tokens = counts.float() / max(T * k, 1)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return out.to(x.dtype), aux
