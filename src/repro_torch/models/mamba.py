"""Mamba-2 block (SSD): projections, causal depthwise conv, gated output.

Sequence mixing runs through :func:`repro_torch.kernels.ops.ssd_scan` (the
CUDA kernel on the card).  The decode path is the exact single-step
recurrence over the carried ``(conv windows, SSD state)`` cache.  As in the
reference, projections are split per tensor (x/z/B/C/dt) and the causal
conv is ``width`` shifted multiplies instead of a grouped convolution.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from ..launch.dtensors import as_dtensor, from_shard, is_dtensor, map_placements, redistribute_to, zeros_rows_like
from .act_sharding import constrain
from .layers import rmsnorm_defs
from .params import ParamDef

__all__ = ["mamba_defs", "mamba_apply", "mamba_decode", "init_mamba_cache"]


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    if s is None:
        raise ValueError(f"{cfg.name} has no SSM config")
    H = s.n_heads(cfg.d_model)
    P, N, G, W = s.head_dim, s.d_state, s.n_groups, s.conv_width
    return {
        "w_z": ParamDef((cfg.d_model, H, P), ("embed", "ssm_heads", None)),
        "w_x": ParamDef((cfg.d_model, H, P), ("embed", "ssm_heads", None)),
        "w_B": ParamDef((cfg.d_model, G, N), ("embed", None, "ssm_state")),
        "w_C": ParamDef((cfg.d_model, G, N), ("embed", None, "ssm_state")),
        "w_dt": ParamDef((cfg.d_model, H), ("embed", "ssm_heads")),
        "dt_bias": ParamDef((H,), ("ssm_heads",), "zeros"),
        "A_log": ParamDef((H,), ("ssm_heads",), "zeros"),  # A = -exp(A_log) → -1
        "D": ParamDef((H,), ("ssm_heads",), "ones"),
        "conv_x": ParamDef((W, H, P), ("conv", "ssm_heads", None), scale=0.5),
        "conv_B": ParamDef((W, G, N), ("conv", None, "ssm_state"), scale=0.5),
        "conv_C": ParamDef((W, G, N), ("conv", None, "ssm_state"), scale=0.5),
        "gate_norm": rmsnorm_defs(H * P),
        "out": ParamDef((H, P, cfg.d_model), ("ssm_heads", None, "embed"), init="out_proj"),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as shifted multiplies, in fp32, then silu.

    u: (B, S, ...) input; w: (W, ...) taps (tap W-1 is the current step);
    ``window``: (B, W-1, ...) left context for chunked prefill / decode."""
    W, S = w.shape[0], u.shape[1]
    if window is None:
        window = zeros_rows_like(u, W - 1)
    ext = torch.cat([window.to(u.dtype), u], dim=1)  # (B, S+W-1, ...)
    out = torch.zeros_like(u, dtype=torch.float32)
    for i in range(W):
        out = out + ext[:, i : i + S].float() * w[i].float()
    return F.silu(out).to(u.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,d...->...")`` as one matmul in x's dtype."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def _project(params, x: torch.Tensor, cfg: ModelConfig):
    z = _proj(x, params["w_z"])
    xs = _proj(x, params["w_x"])
    Bm = _proj(x, params["w_B"])
    Cm = _proj(x, params["w_C"])
    dt = F.softplus(x.float() @ params["w_dt"].float() + params["dt_bias"].float())  # fp32
    return z, xs, Bm, Cm, dt


def _gate_out(params, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated RMSNorm + output projection; y, z: (..., H, P)."""
    lead, (H, P) = y.shape[:-2], y.shape[-2:]
    g = (y.float() * F.silu(z.float())).reshape(*lead, H * P)
    g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + cfg.rms_eps)
    g = (g * (1.0 + params["gate_norm"]["scale"].float())).to(y.dtype)
    return g @ params["out"].to(y.dtype).reshape(H * P, -1)


def mamba_apply(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    return_cache: bool = False,
    ssd_impl: str = "auto",
    conv_window: Optional[Dict[str, torch.Tensor]] = None,
    h0: Optional[torch.Tensor] = None,
):
    """Full-sequence Mamba-2 mixing (training / prefill) of x (B, S, d_model).
    With ``return_cache`` also returns the decode cache: the last ``W-1``
    **pre-conv** features of x, B and C, and the final SSD state ``h``
    (B, H, P, N) fp32.  A chunked prefill continues an earlier one:
    ``conv_window`` holds its left context (``{"x", "B", "C"}``, each
    (B, W-1, ...) pre-conv features, as the cache's ``conv_*`` leaves) and
    ``h0`` its final state; ``ssd_impl`` is :func:`ops.ssd_scan`'s ``impl``."""
    s = cfg.ssm
    z, xs, Bm, Cm, dt = _project(params, x, cfg)
    win = conv_window or {}
    xs_c = _causal_conv(xs, params["conv_x"], win.get("x"))
    Bm_c = _causal_conv(Bm, params["conv_B"], win.get("B"))
    Cm_c = _causal_conv(Cm, params["conv_C"], win.get("C"))
    xs_c = constrain(xs_c, "batch", "seq", "act_heads", None)
    A = -torch.exp(params["A_log"].float())
    # D upcast exactly: the kernels take dt, A and D in fp32 (jamba keeps its parameters in bf16)
    y, h = ops.ssd_scan(xs_c, dt, A, Bm_c, Cm_c, params["D"].float(), h0=h0, chunk=s.chunk,
                        impl=ssd_impl)
    out = _gate_out(params, y, z, cfg)
    if not return_cache:
        return out
    W = s.conv_width
    cache = {
        "conv_x": xs[:, -(W - 1):],
        "conv_B": Bm[:, -(W - 1):],
        "conv_C": Cm[:, -(W - 1):],
        "h": h,
    }
    return out, cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    H, P, N, G, W = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.n_groups, s.conv_width
    return {
        "conv_x": torch.zeros((batch, W - 1, H, P), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, W - 1, G, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, W - 1, G, N), dtype=dtype, device=device),
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }


def _step_conv(win: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """Append the new pre-conv features to the window, convolve, slide."""
    ext = torch.cat([win.to(new.dtype), new[:, None]], dim=1)  # (B, W, ...)
    out = torch.einsum("bw...,w...->b...", ext.float(), w.float())
    return F.silu(out).to(new.dtype), ext[:, 1:]


def _read_state(h: torch.Tensor, Ch: torch.Tensor) -> torch.Tensor:
    """``C·h``: ``einsum("bhpn,bhn->bhp", h, Ch)``.  On a mesh the einsum
    runs on each rank's (row, head, p) block, ``Ch`` brought to the same
    rows and heads, and its result is wrapped at those placements:
    DTensor's einsum flattens (b, h) into one batch dim, which it refuses
    while both are sharded.  The local product is the plain one."""
    if not is_dtensor(h):
        return torch.einsum("bhpn,bhn->bhp", h, Ch)
    out = map_placements(h.placements, {0: 0, 1: 1, 2: 2})
    h = redistribute_to(h, out)
    Ch = redistribute_to(as_dtensor(Ch, h.device_mesh), map_placements(out, {0: 0, 1: 1}))
    return from_shard(torch.einsum("bhpn,bhn->bhp", h.to_local(), Ch.to_local()), h.device_mesh, out, h.shape[:3])


def mamba_decode(params, x: torch.Tensor, cfg: ModelConfig, cache: Dict[str, torch.Tensor]):
    """One-token state update, ``h ← e^{A·dt}h + dt·(x⊗B)``, ``y = C·h + D·x``.
    x: (B, d_model).  Returns ``(out, new cache)``; ``cache`` is not changed."""
    z, xs, Bm, Cm, dt = _project(params, x, cfg)  # (B,H,P) / (B,G,N) / (B,H)
    xs_c, win_x = _step_conv(cache["conv_x"], xs, params["conv_x"])
    Bm_c, win_B = _step_conv(cache["conv_B"], Bm, params["conv_B"])
    Cm_c, win_C = _step_conv(cache["conv_C"], Cm, params["conv_C"])
    rep = xs_c.shape[1] // Bm_c.shape[1]
    Bh = Bm_c.repeat_interleave(rep, dim=1).float()  # (B,H,N)
    Ch = Cm_c.repeat_interleave(rep, dim=1).float()
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(A[None] * dt)  # (B,H)
    xf = xs_c.float()
    h = cache["h"] * decay[..., None, None] + dt[..., None, None] * xf[..., None] * Bh[:, :, None, :]
    y = _read_state(h, Ch) + params["D"].float()[None, :, None] * xf
    out = _gate_out(params, y.to(x.dtype), z, cfg)
    return out, {"conv_x": win_x, "conv_B": win_B, "conv_C": win_C, "h": h}
