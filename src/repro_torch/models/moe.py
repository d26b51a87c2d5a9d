"""FractalMoE: top-k mixture of experts with fractal-sort token dispatch
(port of ``repro.models.moe``).

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

Under a mesh (:mod:`.act_sharding`: a mesh and batch axes set, as the
sharded train step sets them) :func:`moe_apply` takes the expert-parallel
branch, the reference's ``shard_map`` body run by each rank
(:func:`_moe_ffn_local`): routing and the fractal dispatch of the rank's
own tokens, its `model` rank's experts (or F slice), one sum over
`model`, and the experts' global load summed over the batch axes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_dispatch import moe_ranks
from repro_torch.models import act_sharding as AS
from repro_torch.models import layers as L

__all__ = ["MoE", "route", "moe_apply"]


class MoE(nn.Module):
    """router (D, E), fp32 whatever the model's dtype; wi, wg (E, D, F);
    wd (E, F, D)."""

    # under a mesh the expert-parallel branch gathers these itself, over
    # `data` only; the sharded step's block gather leaves them sharded
    gathers_own_weights = True

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


def _branch_weight(p: MoE, name: str, cfg: ModelConfig, axes: tuple):
    """``p``'s weight ``name`` gathered over the batch axes only: the
    router whole, the experts' `model` split kept (the reference's
    ``shard_map`` in_specs).  The `model` split must be the one the
    branch computes on: the experts (or F) over `model`."""
    w = getattr(p, name)
    spec = getattr(w, "shard_spec", None)
    want = (None, None) if name == "router" else SH._MOE_RULES[
        cfg.moe.shard_axis][name]
    if spec is None or tuple(
            "model" in SH.entry_axes(a) for a in spec) != tuple(
            a == "model" for a in want):
        raise ValueError(f"moe_apply under a mesh: {name} has spec {spec}; "
                         f"the branch needs the sharded model's (the "
                         f"`model` axis where {want} has it)")
    return AS.gather_param(w, spec, axes)


def _moe_ffn_local(p: MoE, cfg: ModelConfig, xf, mesh, axes: tuple,
                   dispatch) -> tuple:
    """The whole MoE FFN of one (data, model) rank: the reference's
    ``shard_map`` body.

    xf: (Tl, D) this rank's tokens (the same on every `model` rank).
    Routing (softmax, top-k) and the fractal dispatch run on the local
    tokens; the capacity is per shard, ``C = max(k, ceil(cf * Tl * k /
    E))``; the rank computes its E / tp experts (``shard_axis ==
    "experts"``) or its F / tp slice of all of them (``"mlp"``), with the
    expert weights gathered over `data` on their D axis.  Scatter and
    gather on flat rows, as the reference does.  Returns (out (Tl, D)
    summed over `model`, counts (E,) and the routing probabilities' sum
    (E,), both summed over the batch axes).

    Gradients: ``out``'s sum over `model` passes its gradient through
    (the `model` ranks continue one replicated computation); the tokens
    and routing weights that enter the expert products have their
    gradients summed over `model` (each rank's experts give a part); the
    probabilities' sum over the batch axes sums its gradient over them
    too, because every data rank's loss reads the global statistic and
    the weights' gradients are averaged over `data` later."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    Tl, D = xf.shape
    sizes = SH.axis_sizes(mesh)
    C = max(k, math.ceil(m.capacity_factor * Tl * k / E))
    router, wi, wg, wd = (_branch_weight(p, n, cfg, axes)
                          for n in ("router", "wi", "wg", "wd"))
    probs, ids, w = route(router, xf, k)
    rank, counts, start = dispatch(ids, E)
    ids64 = ids.long()
    slot = rank - start[ids64]
    if m.shard_axis == "experts":
        e_local = E // sizes["model"]
        lo = mesh.get_local_rank("model") * e_local
        mine = (ids64 >= lo) & (ids64 < lo + e_local) & (slot < C)
        ids_l = ids64 - lo
    else:  # grok-style tensor-parallel experts: all experts, F sliced
        e_local = E
        mine = slot < C
        ids_l = ids64
    rows = torch.where(mine, ids_l * C + slot, 0)
    xe = AS.grad_sum_over(xf, ("model",)).repeat_interleave(k, dim=0)
    we = AS.grad_sum_over(w, ("model",))
    buf = xe.new_zeros((e_local * C + 1, D))
    buf[torch.where(mine, rows, e_local * C)] = xe
    buf = buf[:e_local * C].view(e_local, C, D)
    h = torch.bmm(buf, wi)
    g = torch.bmm(buf, wg)
    y = torch.bmm(F.silu(g) * h, wd)
    ww = torch.where(mine, we, torch.zeros_like(we))
    out = y.reshape(e_local * C, D)[rows] * ww[:, None].to(y.dtype)
    out = AS.sum_over(out.reshape(Tl, k, D).sum(dim=1), ("model",))
    counts = counts.clone()
    for a in axes:
        torch.distributed.all_reduce(counts, group=mesh.get_group(a))
    probs_sum = AS.sum_over(probs.sum(dim=0), axes, grad_sum=True)
    return out, counts, probs_sum


def moe_apply(p: MoE, cfg: ModelConfig, x, *, dispatch=moe_ranks):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux_loss fp32 scalar).

    ``dispatch`` is the (rank, counts, start) function of the ids: the
    fractal kernels by default; ``ref.moe_ranks_ref`` gives the same
    layer on the argsort dispatch, for comparison.  The capacity C is
    taken from this call's token count, so a decode step drops what its
    own few tokens overflow.  Under a mesh (set via :mod:`.act_sharding`)
    ``x`` is this rank's batch shard and the expert-parallel branch
    (:func:`_moe_ffn_local`) runs; the aux loss is then the global one,
    from the load and probabilities summed over the batch axes."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    T = B * S
    xf = x.reshape(T, D)
    mesh, axes = AS.get_mesh(), AS.get_batch_axes()
    if mesh is not None and axes is not None:
        out, counts, probs_sum = _moe_ffn_local(p, cfg, xf, mesh, axes,
                                                dispatch)
        T *= SH.dp_size(mesh)  # the global token count
        frac_tokens = counts.float() / max(T * k, 1)
        aux = E * torch.sum(frac_tokens * (probs_sum / max(T, 1)))
        return out.reshape(B, S, D).to(x.dtype), aux
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
