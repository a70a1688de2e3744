"""Mixture-of-Experts: top-k router and sort-based capacity dispatch.

The reference's GShard/Switch-style layer (``repro/models/moe.py``): tokens
are grouped by batch row, sorted by their assigned expert, scattered into a
fixed ``(E, C)`` slot buffer per group (capacity ``C = ceil(S·k/E · cf)``,
at least 8, a multiple of 8; a token past its expert's capacity drops to
the residual path), run through the experts as batched matmuls over the
expert axis, and combined back with the router weights.  The expert
products are plain ``torch.bmm``, as the reference leaves its ``einsum``s
to XLA outside any Pallas kernel.

Three properties the port keeps on purpose:

* the sort is stable (``torch.argsort(..., stable=True)``, as
  ``jnp.argsort``), so token order within an expert, each token's rank and
  so which tokens drop at capacity are the reference's;
* the combine adds each token's ``k`` contributions one after another in
  the order the reference's ``segment_sum`` meets them (ascending expert),
  in the activations' dtype, with no atomics: a token's output does not
  depend on the run; the dispatch's gradient does the same
  (:class:`_GatherTokens`: autograd's own backward of that gather is a
  ``scatter_add`` whose ``k`` colliding rows a token are atomic adds on
  the card, in an order that changes from run to run);
* every shape is fixed by ``(B, S, E, C)``, and counts are taken with
  ``scatter_add_`` rather than ``bincount``, so a decode step on the card
  makes no host sync in an MoE layer.

On a device mesh (a DTensor ``x`` or DTensor parameters: a step placed by
``launch.steps.place``), :func:`moe_apply` runs on each rank's shards
(:func:`_moe_on_shards`), expert-parallel as the reference's rules place the
weights: the experts on ``model`` (``Shard(0)``), their FFN width
(``expert_mlp``) on ``data``, the batch rows on ``data`` too.

* Routing runs on the rank's own batch rows, exactly as on one card: the
  capacity is per row, so a row's ranks, drops and sorted order do not
  depend on the other rows.  The router (``d × E``) is gathered whole.
* The aux loss's statistics (first-choice counts, summed router
  probabilities, the token count) are local sums, all-reduced over the
  batch's mesh dims before they are divided: ``2E + 1`` values a layer.
* Each rank runs only the experts it holds (``E / model``); its slot buffer
  holds only their rows.  Of the two things that sit on ``data``, the op
  gathers the weights, never the tokens: each rank all-gathers its experts'
  ``expert_mlp`` slices over ``data`` (FSDP's gather), receiving ``3 · (E /
  model) · d · F · (data - 1) / data`` values a layer, and runs its own rows
  through them whole.  The weights are never gathered over ``model``.
* The combine is exact: the expert outputs ``(E / model, B_local · C, d)``
  are all-gathered over ``model`` (``E · B_local · C · d · (model - 1) /
  model`` values a layer received), and every rank adds each token's ``k``
  contributions in ascending-expert order, as on one card.
* Backward: the all-gather's gradient is each rank's own block (no
  collective); the tokens' gradient through the experts is all-reduced over
  ``model`` (``B_local · S · d``); the weights' gradients come back at
  ``Partial`` over the batch's dims, which the trainer reduces to their
  placements.  :class:`_GatherTokens`' ordered backward runs on the local
  shards.
* A placement it cannot run on its shards (a mesh dim that splits both the
  batch rows and the experts: that needs an all-to-all of tokens) raises
  and names it; nothing falls back to the whole layer.

On a one-rank mesh every op is the plain path's, bit for bit.

:func:`moe_apply_dense` is the validation path: every expert computes every
token, combined by the router weights; with ample capacity the sparse path
equals it.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from ..launch.dtensors import (
    as_dtensor,
    axes_on,
    from_shard,
    grad_placements,
    grad_sum_over,
    is_dtensor,
    local_shard,
    mesh_of,
    redistribute_to,
    sum_over,
)
from .act_sharding import constrain
from .layers import ffn_apply, ffn_defs
from .params import ParamDef

__all__ = ["moe_defs", "moe_apply", "moe_apply_dense", "router_topk", "capacity", "gather_tokens"]


def moe_defs(cfg: ModelConfig, moe: MoEConfig) -> Dict[str, ParamDef]:
    d = {
        "router": ParamDef((cfg.d_model, moe.n_experts), ("embed", None), scale=0.02),
        "wi_gate": ParamDef((moe.n_experts, cfg.d_model, moe.expert_d_ff), ("experts", None, "expert_mlp")),
        "wi_up": ParamDef((moe.n_experts, cfg.d_model, moe.expert_d_ff), ("experts", None, "expert_mlp")),
        "wo": ParamDef((moe.n_experts, moe.expert_d_ff, cfg.d_model), ("experts", "expert_mlp", None), init="out_proj"),
    }
    if moe.n_shared > 0:
        d["shared"] = ffn_defs(cfg.d_model, moe.n_shared * moe.shared_d_ff)
    return d


def router_topk(params, x: torch.Tensor, moe: MoEConfig, *, mesh=None,
                batch_axes: Sequence[int] = ()) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits in fp32 → ``(weights (..., k) in x's dtype, expert
    indices (..., k), the Switch load-balance aux loss E · Σ_e f_e · p_e)``,
    with ``f_e`` the share of tokens whose first choice is ``e`` and ``p_e``
    the mean router probability.  Both are sums over the tokens divided by
    their count; with ``batch_axes`` (``x`` a rank's rows of a batch split
    over those dims of ``mesh``) the sums and the count are all-reduced over
    them first, so the aux loss is the whole batch's."""
    logits = x.float() @ params["router"].float()
    probs = torch.sigmoid(logits) if moe.router == "sigmoid" else torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, moe.top_k, dim=-1)
    if moe.router_scale:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    E = moe.n_experts
    first = idx[..., 0].reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, first, torch.ones_like(first, dtype=torch.float32))
    tokens = torch.full((1,), first.numel(), dtype=torch.float32, device=x.device)
    stats = torch.cat([counts, probs.reshape(-1, E).sum(0), tokens])
    if batch_axes:
        stats = sum_over(stats, mesh, batch_axes)
    me, pe = stats[:E] / stats[2 * E:], stats[E:2 * E] / stats[2 * E:]
    aux = E * (me * pe).sum()
    return w.to(x.dtype), idx, aux


def capacity(n_tokens: int, moe: MoEConfig) -> int:
    """Slots per expert for a group of ``n_tokens``: ``ceil(n·k/E · cf)``,
    at least 8 and padded to a multiple of 8."""
    c = int(math.ceil(n_tokens * moe.top_k / moe.n_experts * moe.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def _sum_in_order(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` (B, T, k, d) summed over k one term after another, in order."""
    out = rows[:, :, 0]
    for j in range(1, rows.shape[2]):
        out = out + rows[:, :, j]
    return out


class _GatherTokens(torch.autograd.Function):
    """``x.gather(1, token_of[..., None].expand(B, T·k, d))``: each token's
    row once for each of its ``k`` expert entries, in sorted-expert order.
    Its gradient adds each token's ``k`` rows in a fixed order (the entries'
    ascending expert, through the permutation ``by_token`` that groups them
    by token, as the forward combine does) rather than by autograd's
    ``scatter_add``, whose colliding rows are atomic adds on the card."""

    @staticmethod
    def forward(ctx, x, token_of, by_token, k):
        B, T, d = x.shape
        ctx.save_for_backward(by_token)
        ctx.k = k
        return x.gather(1, token_of[..., None].expand(B, token_of.shape[1], d))

    @staticmethod
    def backward(ctx, grad):
        (by_token,) = ctx.saved_tensors
        B, Tk, d = grad.shape
        rows = grad.gather(1, by_token[..., None].expand(B, Tk, d))
        return _sum_in_order(rows.view(B, Tk // ctx.k, ctx.k, d)), None, None, None


class _Uses(torch.autograd.Function):
    """``n`` uses of one tensor whose gradients add in the order of the
    uses, whatever order autograd's backward reaches them in: the plain
    layer and the one on a mesh (whose uses reach it through other nodes)
    then sum them alike."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.set_materialize_grads(False)  # an unused one's gradient stays None (not a plain zero beside DTensors)
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                total = g if total is None else total + g
        return total, None


def gather_tokens(x: torch.Tensor, token_of: torch.Tensor, by_token: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's row of ``x`` (B, T, d) at every entry of ``token_of``
    (B, T·k: the token of each sorted entry, each token ``k`` times), with a
    gradient that sums a token's ``k`` rows in order (:class:`_GatherTokens`;
    ``by_token`` is ``argsort(token_of, stable=True)``)."""
    return _GatherTokens.apply(x, token_of, by_token, k)


def _dispatch_combine(params, x, w, idx, cfg: ModelConfig, moe: MoEConfig, C: int, first: int = 0,
                      all_experts: Callable[[torch.Tensor], torch.Tensor] = lambda y: y) -> torch.Tensor:
    """Sort-based dispatch and combine, each batch row one group with its own
    capacity ``C``.  ``x`` (B, T, d), ``w``/``idx`` (B, T, k) → (B, T, d).
    ``params`` holds the experts ``[first, first + E_l)`` (all ``E`` on one
    card); the slot buffer takes only their entries, and ``all_experts``
    turns their outputs ``(E_l, B·C, d)`` into every expert's ``(E, B·C,
    d)`` (on a mesh, the all-gather over the experts' dims)."""
    B, T, d = x.shape
    k, E = moe.top_k, moe.n_experts
    El = params["wi_gate"].shape[0]
    dev = x.device
    flat_e = idx.reshape(B, T * k)
    order = torch.argsort(flat_e, dim=1, stable=True)  # token order preserved within an expert
    sorted_e = flat_e.gather(1, order)
    token_of = order // k
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(1, sorted_e, torch.ones_like(sorted_e))
    starts = counts.cumsum(1) - counts
    rank = torch.arange(T * k, device=dev) - starts.gather(1, sorted_e)
    keep = rank < C
    # the slot buffer is (E_l, B, C, d), so that each expert's rows of every group are one bmm operand;
    # a dropped entry, or one of another rank's expert, lands on one extra row, which nothing reads
    rows = torch.arange(B, device=dev)[:, None]
    local_e = sorted_e - first
    mine = keep & (local_e >= 0) & (local_e < El)
    slot = torch.where(mine, (local_e * B + rows) * C + rank, El * B * C)
    by_token = torch.argsort(token_of, dim=1, stable=True)  # each token's k entries together, in sorted order
    src = gather_tokens(x, token_of, by_token, k)
    buf = torch.zeros((El * B * C + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_copy(0, slot.reshape(-1), src.reshape(-1, d))[:-1].view(El, B * C, d)

    dtype = x.dtype
    g = torch.bmm(buf, params["wi_gate"].to(dtype))
    u = torch.bmm(buf, params["wi_up"].to(dtype))
    y = all_experts(torch.bmm(_act(g, cfg.hidden_act) * u, params["wo"].to(dtype))).reshape(E * B * C, d)

    slot = (sorted_e * B + rows) * C + rank  # each entry's row among every expert's
    back = torch.where(keep[..., None], y[torch.where(keep, slot, 0)], 0.0)
    contrib = back * w.reshape(B, T * k).gather(1, order)[..., None]
    # each token's k contributions in the sorted (ascending expert) order, added one after another
    contrib = contrib.gather(1, by_token[..., None].expand(B, T * k, d)).view(B, T, k, d)
    return _sum_in_order(contrib)


def _all_experts(y: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """Every expert's outputs ``shape`` (E, B·C, d) on each rank, from this
    rank's ``y`` (its experts' rows at ``placements``: ``Shard(0)`` over the
    experts' mesh dims): all-gathered over those dims, exactly.  The
    gradient is each rank's own block of the whole one, which every rank
    holds alike (the combine runs alike on every rank): no collective."""
    from torch.distributed.tensor import Replicate, Shard

    whole = [p if isinstance(p, Shard) and p.dim != 0 else Replicate() for p in placements]
    return redistribute_to(from_shard(y, mesh, placements, shape), whole).to_local(grad_placements=whole)


def _moe_on_shards(params, x_router, x_experts, cfg: ModelConfig, moe: MoEConfig, C: int):
    """:func:`moe_apply`'s routed experts on each rank's shards (see the
    module's docstring), the router reading ``x_router`` and the experts
    ``x_experts`` (one ``x``) → ``(output DTensor at x's batch placements,
    aux loss: a plain fp32 tensor, alike on every rank)``."""
    from torch.distributed.tensor import Replicate, Shard

    names = ("router", "wi_gate", "wi_up", "wo")
    mesh = mesh_of(x_router, *(params[n] for n in names))

    def rows(t):  # the batch rows where they are; each row's sequence and width whole on its ranks
        t = as_dtensor(t, mesh)
        return redistribute_to(t, [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in t.placements])

    x, x_experts = rows(x_router), rows(x_experts)
    B, S, d = x.shape
    batch_axes = axes_on(x.placements, 0)
    weights = {n: as_dtensor(params[n], mesh) for n in names}
    expert_axes = axes_on(weights["wi_gate"].placements, 0)
    for n in ("wi_up", "wo"):
        if axes_on(weights[n].placements, 0) != expert_axes:
            raise NotImplementedError(f"moe_apply on shards: the experts of {n} ({weights[n].placements}) lie on "
                                      f"other mesh dims than wi_gate's ({weights['wi_gate'].placements})")
    if set(batch_axes) & set(expert_axes):
        raise NotImplementedError(
            f"moe_apply on shards: mesh dims {sorted(set(batch_axes) & set(expert_axes))} split both the batch rows "
            f"({x.placements}) and the experts ({weights['wi_gate'].placements}); that needs an all-to-all of "
            "tokens, which is not written")
    # the experts' weights: E split as placed, every other dim whole (gathered over the dims that split expert_mlp)
    at = [Shard(0) if i in expert_axes else Replicate() for i in range(mesh.ndim)]
    whole = [Replicate()] * mesh.ndim
    local = {n: local_shard(redistribute_to(weights[n], at), grad_placements(x, at)) for n in names[1:]}
    local["router"] = local_shard(redistribute_to(weights["router"], whole), grad_placements(x, whole))
    x_router = local_shard(x)
    # every rank holds its rows whole; each one's gradient through the experts is its own experts' part
    x_experts = grad_sum_over(local_shard(x_experts), mesh, expert_axes)
    Bl = x_router.shape[0]
    w, idx, aux = router_topk(local, x_router.reshape(-1, d), moe, mesh=mesh, batch_axes=batch_axes)
    first = 0
    for i in expert_axes:  # the first expert this rank holds (Shard(0) nests mesh dims in order)
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    El = local["wi_gate"].shape[0]
    y_place = [Shard(0) if i in expert_axes else Shard(1) if i in batch_axes else Replicate()
               for i in range(mesh.ndim)]
    gather = lambda y: _all_experts(y, mesh, y_place, (moe.n_experts, B * C, d))  # noqa: E731
    out = _dispatch_combine(local, x_experts, w.view(Bl, S, -1), idx.view(Bl, S, -1), cfg, moe, C, first * El,
                            gather)
    return from_shard(out, mesh, x.placements, x.shape), aux


def moe_apply(
    params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    moe: MoEConfig,
    *,
    capacity_factor: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse MoE layer → ``(output in x's dtype, aux loss fp32)``.  Tokens
    are grouped by batch row, each group with capacity ``capacity(S)``, so a
    row's routing and drops never depend on the other rows (a decode batch's
    padding rows included).  ``capacity_factor`` overrides the config's.  A
    DTensor ``x`` or DTensor weights run on each rank's shards (the module's
    docstring), the shared expert as DTensor ops beside them."""
    B, S, d = x.shape
    if capacity_factor is not None:
        moe = replace(moe, capacity_factor=capacity_factor)
    C = capacity(S, moe)
    # the router's, the experts' and the shared expert's input, their gradients added in that order
    x_router, x_experts, x_shared = _Uses.apply(x, 3) if torch.is_grad_enabled() and x.requires_grad else (x,) * 3
    if is_dtensor(x, *(params[n] for n in ("router", "wi_gate", "wi_up", "wo"))):
        out, aux = _moe_on_shards(params, x_router, x_experts, cfg, moe, C)
    else:
        w, idx, aux = router_topk(params, x_router.reshape(-1, d), moe)
        out = _dispatch_combine(params, x_experts, w.view(B, S, -1), idx.view(B, S, -1), cfg, moe, C)
    out = constrain(out, "batch", "seq", "act_embed")
    if moe.n_shared > 0:
        out = out + ffn_apply(params["shared"], x_shared, cfg.hidden_act)
    return out.to(x.dtype), aux


def moe_apply_dense(params, x: torch.Tensor, cfg: ModelConfig, moe: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validation path: every expert computes every token, combined by the
    router weights.  Equals :func:`moe_apply` when nothing drops."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    w, idx, aux = router_topk(params, xf, moe)
    dtype = x.dtype
    g = torch.einsum("td,edf->tef", xf, params["wi_gate"].to(dtype))
    u = torch.einsum("td,edf->tef", xf, params["wi_up"].to(dtype))
    y = torch.einsum("tef,efd->ted", _act(g, cfg.hidden_act) * u, params["wo"].to(dtype))
    comb = torch.zeros((xf.shape[0], moe.n_experts), dtype=dtype, device=x.device).scatter_add_(1, idx, w)
    out = torch.einsum("te,ted->td", comb, y)
    if moe.n_shared > 0:
        out = out + ffn_apply(params["shared"], xf, cfg.hidden_act)
    return out.reshape(B, S, d).to(x.dtype), aux
