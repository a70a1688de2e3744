"""DTensor inputs of the kernels' ops, run on each rank's local shard.

A step placed on a ``DeviceMesh`` (``launch.steps.place``) hands the ops
``DTensor``s sharded as the activation rules ask: q/k/v and the SSD scan's
x over batch and heads only.  Each op here brings its inputs to the
placements its kernel can take on a shard (batch and heads sharded, every
other dim whole), takes ``to_local()`` of each, runs the kernel's wrapper on
those plain tensors (the CUDA kernel on the card, its plain version on the
CPU) and returns ``DTensor.from_local`` at the lead input's placements, its
global shape and contiguous strides.  ``to_local`` and ``from_local`` carry
the gradient, so a backward runs its kernel on the same shards.

* An input sharded over another dim (the sequence, the head dim), or
  ``Partial``, is redistributed explicitly first: no op here falls back to
  a plain version on the whole tensor.
* GQA whose kv heads do not divide the mesh axis that splits the query
  heads: ``logical_spec`` leaves k/v replicated there, and each rank passes
  its kernel the kv heads its query heads read (rows ``[off // G, ...)`` of
  the group size ``G``); that slice's gradient is ``Partial`` over the axis
  (each rank holds the part its heads read).  The SSD scan's B and C
  groups are cut from the heads the same way.
* The decode cache may be split over its sequence (the plan's long-context
  rule, or kv heads that do not divide ``model``): each rank attends over
  its rows with the global row maximum, and the weighted sums and their
  denominators are all-reduced over that axis.  (The cache is written on
  the shards by :func:`repro_torch.launch.dtensors.write_token`.)

A plain tensor beside a DTensor is taken as replicated.  Nothing here runs
for plain inputs: the ops call these functions only when one input is a
DTensor.  The placement helpers and collectives they use are in
:mod:`repro_torch.launch.dtensors`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ..launch.dtensors import (
    all_reduce_over,
    as_dtensor,
    axes_on,
    from_shard,
    grad_placements,
    local_shard,
    map_placements,
    mesh_of,
    redistribute_to,
    span,
)

__all__ = ["flash_on_shards", "ssd_on_shards", "decode_attention_on_shards"]


def _kernel_placements(placements, keep: Sequence[int]):
    """Each mesh dim's placement kept where it shards a tensor dim in
    ``keep`` (batch, heads), ``Replicate`` elsewhere (another dim's shard,
    a ``Partial``)."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim in keep else Replicate() for p in placements]


def _grouped(lead, lead_dim: int, other, other_dim: int, batch_map: dict):
    """The shard of ``other`` (a DTensor whose ``other_dim`` holds groups of
    the lead's ``lead_dim`` heads: kv heads of query heads, SSD groups of
    heads) that the lead's local heads read, as a plain tensor with a
    gradient.  Where the groups divide the mesh axes that split the heads,
    ``other`` is sharded on them as the lead is; else it is replicated
    there and sliced, its gradient ``Partial`` over those axes."""
    mesh = lead.device_mesh
    head_axes = axes_on(lead.placements, lead_dim)
    split = math.prod(mesh.size(i) for i in head_axes)
    n_heads, n_groups = lead.shape[lead_dim], other.shape[other_dim]
    sharded = n_groups % split == 0
    mapping = dict(batch_map)
    if sharded:
        mapping[lead_dim] = other_dim
    want = map_placements(lead.placements, mapping)
    full = local_shard(redistribute_to(other, want), grad_placements(lead, want))
    if sharded or not head_axes:
        return full
    off, n = span(lead, lead_dim)
    per = n_heads // n_groups  # heads a group
    lo, hi = off // per, (off + n - 1) // per + 1
    if n % per == 0 and off % per == 0 or hi - lo == 1:
        return full.narrow(other_dim, lo, hi - lo)
    # the local heads straddle groups unevenly: one group row per head
    idx = torch.div(torch.arange(off, off + n, device=full.device), per, rounding_mode="floor")
    return full.index_select(other_dim, idx)


# ------------------------------------------------------------------ flash attention
def flash_on_shards(fn: Callable, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (``ops.flash_attention`` on plain tensors) on
    each rank's shard of batch-major ``(B, S, H, D)`` DTensors: q sharded
    over batch and heads, k and v over batch and the kv heads q's heads
    read; returns the output at q's placements."""
    mesh = mesh_of(q, k, v)
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    qp = _kernel_placements(q.placements, (0, 2))
    q = redistribute_to(q, qp)
    k_l = _grouped(q, 2, k, 2, {0: 0})
    v_l = _grouped(q, 2, v, 2, {0: 0})
    o = fn(local_shard(q), k_l, v_l, **kw)
    return from_shard(o, mesh, qp, (*q.shape[:-1], v.shape[-1]))


# ------------------------------------------------------------------ SSD scan
def ssd_on_shards(fn: Callable, x, dt, A, Bm, Cm, D=None, h0=None, **kw):
    """``fn(x, dt, A, Bm, Cm, D, h0, **kw)`` (``ops.ssd_scan`` on plain
    tensors) on each rank's shard: x ``(B, S, H, P)`` over batch and heads;
    dt, A, D and h0 cut on x's heads; B and C ``(B, S, G, N)`` over batch
    and the groups x's heads read.  Returns ``(y, h)`` at x's placements
    (h's at ``(B, H, P, N)``)."""
    mesh = mesh_of(x, dt, A, Bm, Cm, D, h0)
    x = as_dtensor(x, mesh)
    xp = _kernel_placements(x.placements, (0, 2))
    x = redistribute_to(x, xp)

    def cut(t, mapping):
        if t is None:
            return None
        want = map_placements(xp, mapping)
        return local_shard(redistribute_to(as_dtensor(t, mesh), want), grad_placements(x, want))

    args = (
        local_shard(x),
        cut(dt, {0: 0, 2: 2}),
        cut(A, {2: 0}),
        _grouped(x, 2, as_dtensor(Bm, mesh), 2, {0: 0}),
        _grouped(x, 2, as_dtensor(Cm, mesh), 2, {0: 0}),
        cut(D, {2: 0}),
        cut(h0, {0: 0, 2: 1}),
    )
    y, h = fn(*args, **kw)
    B, S, H, P = x.shape
    return (from_shard(y, mesh, xp, x.shape),
            from_shard(h, mesh, map_placements(xp, {0: 0, 2: 1}), (B, H, P, h.shape[-1])))


# ------------------------------------------------------------------ decode
def decode_attention_on_shards(fn: Callable, q, k_cache, v_cache, cache_len, *, scale: Optional[float] = None):
    """Single-token attention of ``q`` ``(B, Hq, D)`` over a DTensor cache
    ``(B, S, Hkv, D)`` on each rank's shard, the cache never moved: q and
    the lengths follow the cache's batch and kv-head placements.  A cache
    sharded over batch and heads runs ``fn`` (``ops.decode_attention``) on
    the shards; one split over its sequence combines the ranks' partial
    softmax sums (global row maximum first, then the sums and their
    denominators all-reduced).  Returns the output at q's placements."""
    import torch.distributed as dist

    mesh = mesh_of(q, k_cache, v_cache)
    cache = as_dtensor(k_cache, mesh)  # a cache's shards kept; a fresh projection's Partial summed
    cache = redistribute_to(cache, _kernel_placements(cache.placements, (0, 1, 2)))
    v_cache = redistribute_to(as_dtensor(v_cache, mesh), cache.placements)
    qp = map_placements(cache.placements, {0: 0, 2: 1})
    q = redistribute_to(as_dtensor(q, mesh), qp)
    if not isinstance(cache_len, int):
        cache_len = redistribute_to(as_dtensor(cache_len, mesh), map_placements(cache.placements, {0: 0}))
        cache_len = cache_len.to_local()
    seq_axes = axes_on(cache.placements, 1)
    if not seq_axes:
        o = fn(q.to_local(), cache.to_local(), v_cache.to_local(), cache_len, scale=scale)
        return from_shard(o, mesh, qp, q.shape)
    ql, kl, vl = q.to_local(), cache.to_local(), v_cache.to_local()
    Bl, Hq, D = ql.shape
    Hkv = kl.shape[2]
    G = Hq // Hkv
    scale = float(scale if scale is not None else D ** -0.5)
    s0, n = span(cache, 1)
    s = torch.einsum("bhgd,bkhd->bhgk", ql.float().reshape(Bl, Hkv, G, D), kl.float()) * scale
    cols = torch.arange(s0, s0 + n, device=ql.device)
    limit = torch.full((Bl,), cache_len, device=ql.device) if isinstance(cache_len, int) else cache_len
    s = s.masked_fill(~(cols[None, :] < limit[:, None])[:, None, None, :], float("-inf"))
    m = all_reduce_over(s.amax(-1, keepdim=True), mesh, seq_axes, dist.ReduceOp.MAX)
    p = torch.exp(s - m)
    parts = torch.cat([torch.einsum("bhgk,bkhd->bhgd", p, vl.float()), p.sum(-1, keepdim=True)], dim=-1)
    all_reduce_over(parts, mesh, seq_axes)
    o = (parts[..., :D] / parts[..., D:]).reshape(Bl, Hq, D).to(ql.dtype)
    return from_shard(o, mesh, qp, q.shape)
