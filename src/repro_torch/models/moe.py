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

:func:`moe_apply_dense` is the validation path: every expert computes every
token, combined by the router weights; with ample capacity the sparse path
equals it.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
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


def router_topk(params, x: torch.Tensor, moe: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits in fp32 → ``(weights (..., k) in x's dtype, expert
    indices (..., k), the Switch load-balance aux loss E · Σ_e f_e · p_e)``,
    with ``f_e`` the share of tokens whose first choice is ``e``."""
    logits = x.float() @ params["router"].float()
    probs = torch.sigmoid(logits) if moe.router == "sigmoid" else torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, moe.top_k, dim=-1)
    if moe.router_scale:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    E = moe.n_experts
    first = idx[..., 0].reshape(-1)
    me = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, first, torch.ones_like(first, dtype=torch.float32)) / first.numel()
    pe = probs.reshape(-1, E).mean(0)
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


def gather_tokens(x: torch.Tensor, token_of: torch.Tensor, by_token: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's row of ``x`` (B, T, d) at every entry of ``token_of``
    (B, T·k: the token of each sorted entry, each token ``k`` times), with a
    gradient that sums a token's ``k`` rows in order (:class:`_GatherTokens`;
    ``by_token`` is ``argsort(token_of, stable=True)``)."""
    return _GatherTokens.apply(x, token_of, by_token, k)


def _dispatch_combine(params, x, w, idx, cfg: ModelConfig, moe: MoEConfig, C: int) -> torch.Tensor:
    """Sort-based dispatch and combine, each batch row one group with its own
    capacity ``C``.  ``x`` (B, T, d), ``w``/``idx`` (B, T, k) → (B, T, d)."""
    B, T, d = x.shape
    k, E = moe.top_k, moe.n_experts
    dev = x.device
    flat_e = idx.reshape(B, T * k)
    order = torch.argsort(flat_e, dim=1, stable=True)  # token order preserved within an expert
    sorted_e = flat_e.gather(1, order)
    token_of = order // k
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(1, sorted_e, torch.ones_like(sorted_e))
    starts = counts.cumsum(1) - counts
    rank = torch.arange(T * k, device=dev) - starts.gather(1, sorted_e)
    keep = rank < C
    # the slot buffer is (E, B, C, d), so that each expert's rows of every group are one bmm operand;
    # a dropped entry lands on one extra row, which nothing reads
    rows = torch.arange(B, device=dev)[:, None]
    slot = torch.where(keep, (sorted_e * B + rows) * C + rank, E * B * C)
    by_token = torch.argsort(token_of, dim=1, stable=True)  # each token's k entries together, in sorted order
    src = gather_tokens(x, token_of, by_token, k)
    buf = torch.zeros((E * B * C + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_copy(0, slot.reshape(-1), src.reshape(-1, d))[:-1].view(E, B * C, d)

    dtype = x.dtype
    g = torch.bmm(buf, params["wi_gate"].to(dtype))
    u = torch.bmm(buf, params["wi_up"].to(dtype))
    y = torch.bmm(_act(g, cfg.hidden_act) * u, params["wo"].to(dtype)).reshape(E * B * C, d)

    back = torch.where(keep[..., None], y[torch.where(keep, slot, 0)], 0.0)
    contrib = back * w.reshape(B, T * k).gather(1, order)[..., None]
    # each token's k contributions in the sorted (ascending expert) order, added one after another
    contrib = contrib.gather(1, by_token[..., None].expand(B, T * k, d)).view(B, T, k, d)
    return _sum_in_order(contrib)


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
    padding rows included).  ``capacity_factor`` overrides the config's."""
    B, S, d = x.shape
    if capacity_factor is not None:
        moe = replace(moe, capacity_factor=capacity_factor)
    C = capacity(S, moe)
    w, idx, aux = router_topk(params, x.reshape(-1, d), moe)
    out = _dispatch_combine(params, x, w.view(B, S, -1), idx.view(B, S, -1), cfg, moe, C)
    out = constrain(out, "batch", "seq", "act_embed")
    if moe.n_shared > 0:
        out = out + ffn_apply(params["shared"], x, cfg.hidden_act)
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
