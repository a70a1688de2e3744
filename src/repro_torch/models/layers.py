"""Shared layer primitives: norms, GLU FFN, embeddings, RoPE.

The fp32 islands are the reference's: ``rmsnorm`` computes in fp32, logits
are fp32 with the padded vocabulary masked to ``-1e9``, and ``rope`` builds
its frequencies as ``exp(-log θ · i / half)`` in fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .params import ParamDef

__all__ = [
    "rmsnorm_defs",
    "rmsnorm",
    "ffn_defs",
    "ffn_apply",
    "embed_defs",
    "lm_head_defs",
    "embed_apply",
    "logits_apply",
    "rope",
]


# ----------------------------------------------------------------------- norms
def rmsnorm_defs(d_model: int) -> Dict[str, ParamDef]:
    # zeros-init "(1+g)" parameterisation (gemma-style)
    return {"scale": ParamDef((d_model,), (None,), "zeros")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + params["scale"].float())).to(dtype)


# ----------------------------------------------------------------------- FFN
def ffn_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "wi_gate": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "wi_up": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "wo": ParamDef((d_ff, d_model), ("mlp", "embed"), init="out_proj"),
    }


def ffn_apply(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    dtype = x.dtype
    g = x @ params["wi_gate"].to(dtype)
    u = x @ params["wi_up"].to(dtype)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * u) @ params["wo"].to(dtype)


# ----------------------------------------------------------------------- embeddings
def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    return {
        "embedding": ParamDef(
            (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), init="embed", scale=0.02
        )
    }


def lm_head_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    return {"w": ParamDef((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))}


def embed_apply(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = params["embedding"][tokens].to(cfg.compute_tdtype())
    if cfg.scale_embedding:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def logits_apply(params, head_params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final projection in fp32 with padded-vocab masking."""
    xf = x.float()
    if cfg.tie_embeddings:
        logits = xf @ params["embedding"].float().T
    else:
        logits = xf @ head_params["w"].float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9
    return logits


# ----------------------------------------------------------------------- RoPE
def rope(
    x: torch.Tensor,  # (..., S, H, D)
    positions: torch.Tensor,  # (..., S) integer
    theta: float = 10_000.0,
    rotary_dim: Optional[int] = None,
) -> torch.Tensor:
    """Rotary position embedding over the last ``rotary_dim`` features."""
    D = x.shape[-1]
    rd = rotary_dim or D
    if rd % 2:
        raise ValueError(f"rotary dim {rd} is odd")
    half = rd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32, device=x.device))
    freq = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freq  # (..., S, half)
    # broadcast over the head axis: x is (..., S, H, D)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < D else out
