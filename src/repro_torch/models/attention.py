"""Attention for full sequences and decode: GQA/MQA (optionally biased QKV)
and DeepSeek-V2's MLA (multi-head latent attention) with weight-absorbed
decode.

Layouts follow the reference: activations are batch-major ``(B, S, H, D)``;
one layer's decode cache is ``{"k", "v"}`` of ``(B, S_max, Hkv, D)`` for
GQA and ``{"ckv"}`` of ``(B, S_max, kv_lora_rank + qk_rope_dim)`` for MLA
(the compressed latent and the shared rope key: 576 values a token at
deepseek-v2's widths instead of 2·H·D).  Decode positions are per
sequence, ``(B,)``, so the serving engine can batch requests at different
depths.  Cross-attention (whisper's decoder over its encoder's output) has
GQA's weights and no positional rotation: prefill and training run the
flash kernel non-causally at ``(Sq, Sk)``, decode attends over the whole
cross cache ``{"k", "v"}`` of ``(B, S_enc, Hkv, D)``.

On a device mesh (DTensor inputs, a step placed by ``launch.steps.place``)
every projection is a DTensor op, the heads split over ``model`` and the
batch over ``data``; attention runs on each rank's shards
(``kernels.shards``), and MLA's two layers of their own are written here:
its prefill expands the shared rope key on each rank's heads, and its
decode attends over a latent cache split over its sequence
(:func:`mla_decode`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from ..launch.dtensors import (
    all_reduce_over,
    as_dtensor,
    axes_on,
    from_shard,
    grad_placements,
    is_dtensor,
    local_shard,
    map_placements,
    mesh_of,
    redistribute_to,
    span,
    unit_dims_whole,
    write_token,
)
from .act_sharding import constrain
from .layers import rmsnorm, rmsnorm_defs, rope
from .params import ParamDef

__all__ = [
    "gqa_defs", "gqa_apply", "gqa_decode", "init_gqa_cache",
    "mla_defs", "mla_apply", "mla_decode", "init_mla_cache",
    "cross_attn_defs", "cross_attn_kv", "cross_attn_apply",
]


def gqa_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    hd = cfg.resolved_head_dim
    d = {
        "wq": ParamDef((cfg.d_model, cfg.n_heads, hd), ("embed", "heads", "qk_dim")),
        "wk": ParamDef((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "qk_dim")),
        "wv": ParamDef((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "v_dim")),
        "wo": ParamDef((cfg.n_heads, hd, cfg.d_model), ("heads", "v_dim", "embed"), init="out_proj"),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDef((cfg.n_heads, hd), ("heads", "qk_dim"), "zeros")
        d["bk"] = ParamDef((cfg.n_kv_heads, hd), ("kv_heads", "qk_dim"), "zeros")
        d["bv"] = ParamDef((cfg.n_kv_heads, hd), ("kv_heads", "v_dim"), "zeros")
    return d


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,dhk->...hk")`` as one matmul; the result is contiguous.
    A DTensor weight's one head sharded over a one-rank mesh dim (MQA's kv
    head on a ``model`` dim of one rank) is met as replicated there
    (:func:`~repro_torch.launch.dtensors.unit_dims_whole`), the product's
    arithmetic unchanged."""
    d, h, k = w.shape
    return (x @ unit_dims_whole(w).to(x.dtype).reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _merge(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("...hk,hkd->...d")`` as one matmul."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.to(o.dtype).reshape(h * k, d)


def _project_qkv(params, x, cfg: ModelConfig, positions) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dtype = x.dtype
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(
    params,
    x: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    prefix_len: int = 0,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (prefill).  Returns ``(out, {"k", "v"})``,
    the K/V of the whole sequence for the decode cache."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    q = constrain(q, "batch", "seq", "act_heads", None)
    k = constrain(k, "batch", "seq", "act_kv_heads", None)
    v = constrain(v, "batch", "seq", "act_kv_heads", None)
    o = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len, impl=attn_impl)
    return _merge(o, params["wo"]), {"k": k, "v": v}


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def gqa_decode(
    params,
    x: torch.Tensor,  # (B, d_model) — one new token per sequence
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],  # this layer's {"k", "v"}, (B, S_max, Hkv, D)
    pos: torch.Tensor,  # (B,) write/read position of the new token
) -> torch.Tensor:
    """One decode step: write K/V at ``pos`` **in place** in ``cache``, then
    attend over each sequence's valid prefix ``[0, pos]``."""
    dtype = x.dtype
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if cfg.use_rope:
        q = rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    if is_dtensor(cache["k"]):  # each rank writes its shard, rows local to its batch block
        write_token(cache["k"], k, pos)
        write_token(cache["v"], v, pos)
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        cache["k"][rows, pos] = k.to(cache["k"].dtype)
        cache["v"][rows, pos] = v.to(cache["v"].dtype)
    o = ops.decode_attention(q, cache["k"], cache["v"], pos + 1)
    return _merge(o, params["wo"])


# =========================================================================== MLA
def mla_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    m = cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    d = {
        "wq": ParamDef((cfg.d_model, cfg.n_heads, qk), ("embed", "heads", "qk_dim")),
        "w_dkv": ParamDef((cfg.d_model, m.kv_lora_rank + m.qk_rope_dim), ("embed", "kv_lora")),
        "kv_norm": rmsnorm_defs(m.kv_lora_rank),
        "w_uk": ParamDef((m.kv_lora_rank, cfg.n_heads, m.qk_nope_dim), ("kv_lora", "heads", "qk_dim")),
        "w_uv": ParamDef((m.kv_lora_rank, cfg.n_heads, m.v_head_dim), ("kv_lora", "heads", "v_dim")),
        "wo": ParamDef((cfg.n_heads, m.v_head_dim, cfg.d_model), ("heads", "v_dim", "embed"), init="out_proj"),
    }
    if m.q_lora_rank:
        d["w_dq"] = ParamDef((cfg.d_model, m.q_lora_rank), ("embed", "kv_lora"))
        d["q_norm"] = rmsnorm_defs(m.q_lora_rank)
        d["w_uq"] = ParamDef((m.q_lora_rank, cfg.n_heads, qk), ("kv_lora", "heads", "qk_dim"))
    return d


def _mla_q(params, x, cfg: ModelConfig, positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q_nope, q_rope)`` per head, rope on the last ``qk_rope_dim`` columns."""
    m = cfg.mla
    if m.q_lora_rank:
        cq = rmsnorm(params["q_norm"], x @ params["w_dq"].to(x.dtype), cfg.rms_eps)
        q = _heads(cq, params["w_uq"])
    else:
        q = _heads(x, params["wq"])
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(params, x, cfg: ModelConfig, positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compressed latent (normed) and the shared rope key: what the cache stores."""
    m = cfg.mla
    dkv = x @ params["w_dkv"].to(x.dtype)
    c = rmsnorm(params["kv_norm"], dkv[..., : m.kv_lora_rank], cfg.rms_eps)
    # the shared rope key is a single "head"
    k_rope = rope(dkv[..., m.kv_lora_rank:][..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return c, k_rope


def _on_heads(t, head_dim: int = 2):
    """A DTensor ``(B, S, H, D)`` (or ``(B, H, D)``, ``head_dim`` 1) at its
    batch and head shards only (any other dim's shard or ``Partial`` made
    whole)."""
    from torch.distributed.tensor import Replicate, Shard

    keep = (0, head_dim)
    return redistribute_to(t, [p if isinstance(p, Shard) and p.dim in keep else Replicate() for p in t.placements])


def _with_rope_key(k_nope: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """MLA's keys ``(B, S, H, qk_nope + qk_rope)``: each head's ``k_nope``
    beside the shared rope key ``k_rope`` ``(B, S, qk_rope)``.  On a mesh
    the rope key, which has no head axis, meets the heads replicated over
    the dims that split them and is expanded on each rank's own heads (its
    gradient ``Partial`` there: each rank's heads' part)."""
    if not is_dtensor(k_nope, k_rope):
        H = k_nope.shape[2]
        return torch.cat([k_nope, k_rope[:, :, None].expand(*k_rope.shape[:2], H, k_rope.shape[-1])], dim=-1)
    mesh = mesh_of(k_nope, k_rope)
    k_nope = _on_heads(as_dtensor(k_nope, mesh))
    want = map_placements(k_nope.placements, {0: 0})
    rope_l = local_shard(redistribute_to(as_dtensor(k_rope, mesh), want), grad_placements(k_nope, want))
    nope_l = local_shard(k_nope)
    k = torch.cat([nope_l, rope_l[:, :, None].expand(*rope_l.shape[:2], nope_l.shape[2], rope_l.shape[-1])], dim=-1)
    return from_shard(k, mesh, k_nope.placements, (*k_nope.shape[:-1], k_nope.shape[-1] + k_rope.shape[-1]))


def _seq_split(ckv: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A DTensor ``ckv`` ``(B, S, C)`` at the decode cache's placements:
    the batch as ``q``'s, the sequence over the mesh dims that split
    ``q``'s heads where they divide it (the latent has no head axis), each
    rank keeping its slice of what it holds (no collective)."""
    from torch.distributed.tensor import Replicate, Shard

    head_axes = axes_on(q.placements, 2)
    split = math.prod(q.device_mesh.size(i) for i in head_axes)
    seq = head_axes if ckv.shape[1] % split == 0 else []
    return redistribute_to(ckv, [Shard(1) if i in seq else p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                                 for i, p in enumerate(q.placements)])


def mla_apply(
    params,
    x: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence MLA (prefill): K and V expanded per head from the
    latent, then flash attention at q/k width ``qk_nope + qk_rope`` and v
    width ``v_head_dim`` (on the card, deepseek-v2's (192, 128) kernel).
    Returns ``(out, {"ckv"})``, the latent and rope key of the whole
    sequence for the decode cache.

    On a mesh the query heads, ``k_nope`` and ``v`` are split over
    ``model`` (DTensor projections; the latent and the rope key, which have
    no head axis, are replicated there), the rope key is expanded on each
    rank's heads (:func:`_with_rope_key`), attention runs on the local
    heads (``flash_on_shards``: the (192, 128) kernel on the card), and
    ``wo`` sums the heads' parts over ``model`` (one all-reduce of ``B · S
    · d_model``).  ``ckv`` comes back at the cache's placements, the batch
    on ``data`` and the sequence on ``model`` (a slice, no collective)."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c, k_rope = _mla_ckv(params, x, cfg, positions)
    k_nope = _heads(c, params["w_uk"])
    v = _heads(c, params["w_uv"])
    k = _with_rope_key(k_nope, k_rope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    o = ops.flash_attention(q, k, v, causal=causal, scale=scale, impl=attn_impl)
    ckv = torch.cat([c, k_rope], dim=-1)
    if is_dtensor(ckv, q):
        ckv = _seq_split(as_dtensor(ckv, mesh_of(ckv, q)), _on_heads(as_dtensor(q, mesh_of(ckv, q))))
    return _merge(o, params["wo"]), {"ckv": ckv}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank + m.qk_rope_dim), dtype=dtype, device=device)}


def _latent_scores(q_c, q_rope, ckv, cols, pos, cfg: ModelConfig, dtype):
    """MLA decode's scores ``(B, H, S)`` over the latent rows ``ckv`` ``(B,
    S, C + R)`` at positions ``cols`` ``(S,)``, in the reference's order:
    in the compute dtype, then fp32 and the scale, the rows past ``pos``
    masked at fp32's min; and the latent part of the rows in the compute
    dtype."""
    m = cfg.mla
    c_cache = ckv[..., : m.kv_lora_rank].to(dtype)
    r_cache = ckv[..., m.kv_lora_rank:].to(dtype)
    s = torch.einsum("bhr,bsr->bhs", q_c, c_cache) + torch.einsum("bhk,bsk->bhs", q_rope, r_cache)
    s = s.float() * ((m.qk_nope_dim + m.qk_rope_dim) ** -0.5)
    valid = cols[None] < (pos + 1)[:, None]
    return s.masked_fill(~valid[:, None], torch.finfo(torch.float32).min), c_cache


def _latent_attention(s, c_cache, dtype):
    """The weighted latent ``(B, H, C)``: the softmax of ``s`` cast to the
    compute dtype, times the rows."""
    return torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1).to(dtype), c_cache)


def _mla_decode_on_shards(params, q_nope, q_rope, ckv, pos, cfg: ModelConfig, dtype):
    """Weight-absorbed attention of DTensor queries ``(B, H, ·)`` over a
    DTensor latent cache ``ckv`` ``(B, S, C + R)`` (the batch on ``data``,
    the sequence on ``model``), the cache never moved → ``o`` ``(B, H,
    v_head_dim)`` at the queries' batch and head placements.

    ``q_c = q_nope · w_uk`` on each rank's heads; every head's ``q_c`` and
    ``q_rope`` are then gathered over the heads' dims to the cache's batch
    placements (``B · H · (C + R)`` values).  Each rank scores its own span
    of the sequence (:func:`_latent_scores`); where the span is part of the
    sequence, the softmax combines across the ranks that split it: the row
    maximum all-reduced, then the sums of ``p · c`` and of ``p`` all-reduced
    together (``B · H · (C + 1)`` values), divided and cast.  Each rank
    keeps its heads' rows of ``o_c`` (a slice) and expands them through
    ``w_uv`` once.  Where no mesh dim of more than one rank splits the
    sequence, each rank runs the plain softmax on its rows: on one rank the
    result is the plain step's, bit for bit."""
    import torch.distributed as dist

    m = cfg.mla
    mesh = mesh_of(q_nope, q_rope, ckv)
    q_nope = _on_heads(as_dtensor(q_nope, mesh), 1)
    heads = q_nope.placements
    w_uk = local_shard(redistribute_to(as_dtensor(params["w_uk"], mesh), map_placements(heads, {1: 1})))
    q_c = torch.einsum("bhk,rhk->bhr", local_shard(q_nope), w_uk.to(dtype))
    B, H = q_nope.shape[:2]
    rows = map_placements(ckv.placements, {0: 0})  # the cache's batch shards, every head
    q_c = redistribute_to(from_shard(q_c, mesh, heads, (B, H, m.kv_lora_rank)), rows).to_local()
    q_r = redistribute_to(as_dtensor(q_rope, mesh), rows).to_local()
    pos_l = redistribute_to(as_dtensor(pos, mesh), rows).to_local()
    s0, n = span(ckv, 1)
    s, c_cache = _latent_scores(q_c, q_r, ckv.to_local(), torch.arange(s0, s0 + n, device=q_c.device), pos_l, cfg,
                                dtype)
    seq_axes = [i for i in axes_on(ckv.placements, 1) if mesh.size(i) > 1]
    if not seq_axes:
        o_c = _latent_attention(s, c_cache, dtype)
    else:
        top = all_reduce_over(s.amax(-1, keepdim=True), mesh, seq_axes, dist.ReduceOp.MAX)
        p = torch.exp(s - top)
        parts = torch.cat([torch.einsum("bhs,bsr->bhr", p, c_cache.float()), p.sum(-1, keepdim=True)], dim=-1)
        all_reduce_over(parts, mesh, seq_axes)
        o_c = (parts[..., :-1] / parts[..., -1:]).to(dtype)
    o_c = redistribute_to(from_shard(o_c, mesh, rows, (B, H, m.kv_lora_rank)), heads).to_local()
    w_uv = local_shard(redistribute_to(as_dtensor(params["w_uv"], mesh), map_placements(heads, {1: 1})))
    o = torch.einsum("bhr,rhv->bhv", o_c, w_uv.to(dtype))
    return from_shard(o, mesh, heads, (B, H, m.v_head_dim))


def mla_decode(
    params,
    x: torch.Tensor,  # (B, d_model) — one new token per sequence
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],  # this layer's {"ckv"}, (B, S_max, kv_lora + qk_rope)
    pos: torch.Tensor,  # (B,) write/read position of the new token
) -> torch.Tensor:
    """Weight-absorbed MLA decode: write the new token's latent at ``pos``
    **in place** in ``cache``, then attend in the compressed space over each
    sequence's valid prefix ``[0, pos]``: ``q_c = q_nope · w_uk``, score =
    ``q_c · c + q_rope · k_rope``, and the weighted latent is expanded
    through ``w_uv`` once.  The order is the reference's: scores in the
    compute dtype, then fp32, the scale, the mask at fp32's min, the softmax
    and the cast back.

    On a mesh (a DTensor cache: the batch on ``data``, the sequence on
    ``model``, as the plan places MLA's latent, which has no head axis) the
    new latent is written on the rank that holds its row
    (``launch.dtensors.write_token``: in place, no host sync), and the
    attention runs on the shards (:func:`_mla_decode_on_shards`: a gather of
    the queries over ``model``, then the split softmax's two all-reduces);
    ``wo`` sums the heads' parts over ``model``."""
    m = cfg.mla
    dtype = x.dtype
    q_nope, q_rope = _mla_q(params, x[:, None], cfg, pos[:, None])
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]  # (B, H, ·)
    c_new, k_rope_new = _mla_ckv(params, x[:, None], cfg, pos[:, None])
    ckv = cache["ckv"]
    new = torch.cat([c_new, k_rope_new], dim=-1)[:, 0]
    if is_dtensor(ckv):
        write_token(ckv, new, pos)
        return _merge(_mla_decode_on_shards(params, q_nope, q_rope, ckv, pos, cfg, dtype), params["wo"])
    rows = torch.arange(x.shape[0], device=x.device)
    ckv[rows, pos] = new.to(ckv.dtype)
    q_c = torch.einsum("bhk,rhk->bhr", q_nope, params["w_uk"].to(dtype))
    s, c_cache = _latent_scores(q_c, q_rope, ckv, torch.arange(ckv.shape[1], device=x.device), pos, cfg, dtype)
    o = torch.einsum("bhr,rhv->bhv", _latent_attention(s, c_cache, dtype), params["w_uv"].to(dtype))
    return _merge(o, params["wo"])


# =================================================================== cross-attn
def cross_attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    return gqa_defs(cfg)


def cross_attn_kv(params, enc_out: torch.Tensor, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The encoder output's K and V ``(B, S_enc, Hkv, D)``, once per layer:
    what prefill stores in the cross cache."""
    dtype = enc_out.dtype
    k = _heads(enc_out, params["wk"])
    v = _heads(enc_out, params["wv"])
    if cfg.qkv_bias:
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    return {"k": k, "v": v}


def cross_attn_apply(
    params,
    x: torch.Tensor,  # (B, S, d_model), or (B, d_model) for decode
    cfg: ModelConfig,
    kv: Dict[str, torch.Tensor],  # cross_attn_kv's, (B, S_enc, Hkv, D)
    *,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Decoder→encoder attention (no positional rotation, never causal): the
    flash kernel at ``(S, S_enc)`` for a sequence, ``ops.decode_attention``
    over the whole of ``kv`` for one token."""
    dtype = x.dtype
    q = _heads(x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
    if x.ndim == 2:
        o = ops.decode_attention(q, kv["k"], kv["v"], kv["k"].shape[1])
    else:
        o = ops.flash_attention(q, kv["k"], kv["v"], causal=False, impl=attn_impl)
    return _merge(o, params["wo"])
