"""GQA/MQA attention (optionally biased QKV) for full sequences and decode.

Layouts follow the reference: activations are batch-major ``(B, S, H, D)``;
one layer's decode cache is ``{"k", "v"}`` of ``(B, S_max, Hkv, D)``.
Decode positions are per sequence, ``(B,)``, so the serving engine can batch
requests at different depths.  MLA and cross-attention come with later
slices of the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import rope
from .params import ParamDef

__all__ = ["gqa_defs", "gqa_apply", "gqa_decode", "init_gqa_cache"]


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
    rows = torch.arange(x.shape[0], device=x.device)
    cache["k"][rows, pos] = k.to(cache["k"].dtype)
    cache["v"][rows, pos] = v.to(cache["v"].dtype)
    o = ops.decode_attention(q, cache["k"], cache["v"], pos + 1)
    return _merge(o, params["wo"])
