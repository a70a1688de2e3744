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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from ..launch.dtensors import is_dtensor, write_token
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
    """``einsum("...d,dhk->...hk")`` as one matmul; the result is contiguous."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).view(*x.shape[:-1], h, k)


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
    sequence for the decode cache."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c, k_rope = _mla_ckv(params, x, cfg, positions)
    k_nope = _heads(c, params["w_uk"])
    v = _heads(c, params["w_uv"])
    H = cfg.n_heads
    k = torch.cat([k_nope, k_rope[:, :, None].expand(*k_rope.shape[:2], H, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    o = ops.flash_attention(q, k, v, causal=causal, scale=scale, impl=attn_impl)
    return _merge(o, params["wo"]), {"ckv": torch.cat([c, k_rope], dim=-1)}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank + m.qk_rope_dim), dtype=dtype, device=device)}


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
    and the cast back."""
    m = cfg.mla
    dtype = x.dtype
    q_nope, q_rope = _mla_q(params, x[:, None], cfg, pos[:, None])
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]  # (B, H, ·)
    c_new, k_rope_new = _mla_ckv(params, x[:, None], cfg, pos[:, None])
    ckv = cache["ckv"]
    rows = torch.arange(x.shape[0], device=x.device)
    ckv[rows, pos] = torch.cat([c_new, k_rope_new], dim=-1)[:, 0].to(ckv.dtype)
    c_cache = ckv[..., : m.kv_lora_rank].to(dtype)
    r_cache = ckv[..., m.kv_lora_rank:].to(dtype)

    q_c = torch.einsum("bhk,rhk->bhr", q_nope, params["w_uk"].to(dtype))
    s = torch.einsum("bhr,bsr->bhs", q_c, c_cache) + torch.einsum("bhk,bsk->bhs", q_rope, r_cache)
    s = s.float() * ((m.qk_nope_dim + m.qk_rope_dim) ** -0.5)
    valid = torch.arange(ckv.shape[1], device=x.device)[None] < (pos + 1)[:, None]
    s = s.masked_fill(~valid[:, None], torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(dtype)
    o_c = torch.einsum("bhs,bsr->bhr", p, c_cache)
    o = torch.einsum("bhr,rhv->bhv", o_c, params["w_uv"].to(dtype))
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
