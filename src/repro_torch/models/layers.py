"""Shared layer primitives: norms, GLU FFN, embeddings, RoPE, and the
encoder's fixed sinusoidal positions.

The fp32 islands are the reference's: ``rmsnorm`` computes in fp32, logits
are fp32 with the padded vocabulary masked to ``-1e9``, ``rope`` builds its
frequencies as ``exp(-log θ · i / half)`` in fp32, and
``sinusoidal_positions`` computes in fp32 and casts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..launch.dtensors import is_dtensor, like, lookup_on_shards, redistribute_to, span
from .act_sharding import constrain
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
    "sinusoidal_positions",
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
    h = constrain(g * u, "batch", "seq", "act_mlp")
    return h @ params["wo"].to(dtype)


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
    table = params["embedding"]
    # a DTensor table (a step on a mesh) is read on each rank's shard: DTensor's own index ops gather it whole
    x = (lookup_on_shards(table, tokens) if is_dtensor(table) else table[tokens]).to(cfg.compute_tdtype())
    if cfg.scale_embedding:
        x = x * like(torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device), x)
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
        if is_dtensor(logits):
            logits = _mask_padded_vocab(logits, cfg.vocab_size)
        else:
            logits[..., cfg.vocab_size:] = -1e9
    return constrain(logits, "batch", "seq", "vocab_logits")


def _mask_padded_vocab(logits, vocab: int):
    """A DTensor's padded columns (``>= vocab``) at ``-1e9`` on each rank's
    block of the vocabulary, out of place: a view of a sharded dim cannot
    be written through.  ``Partial`` logits (the head's product over a
    ``d_model`` split on the mesh) are summed first: masked part by part,
    the ranks' ``-1e9`` would add up."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    logits = redistribute_to(logits, [Replicate() if isinstance(p, Partial) else p for p in logits.placements])
    first, width = span(logits, logits.ndim - 1)
    part = logits.to_local()
    part = part.masked_fill(torch.arange(first, first + width, device=part.device) >= vocab, -1e9)
    return DTensor.from_local(part, logits.device_mesh, logits.placements, run_check=False, shape=logits.shape,
                              stride=logits.stride())


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
    # made on the device by a fill: a tensor copied from the host would wait for it in every decode step
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32, device=x.device))
    freq = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    # the tables meet a DTensor x (a step on a mesh) replicated, each rank's shard taking its rows
    ang = positions.float()[..., None] * like(freq, positions)  # (..., S, half)
    # broadcast over the head axis: x is (..., S, H, D)
    sin = like(torch.sin(ang)[..., None, :], x)
    cos = like(torch.cos(ang)[..., None, :], x)
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < D else out


def sinusoidal_positions(seq: int, d_model: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Whisper-style fixed positional embeddings ``(seq, d_model)`` for the
    (stubbed) encoder: ``[sin(p·f), cos(p·f)]`` with ``f_i = exp(-log(10⁴)
    · i / max(half - 1, 1))``, computed in fp32 and cast to ``dtype``."""
    half = d_model // 2
    log_base = torch.log(torch.full((), 10_000.0, dtype=torch.float32, device=device))
    freq = torch.exp(-log_base * torch.arange(half, dtype=torch.float32, device=device) / max(half - 1, 1))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
