"""Attention ops with kernel dispatch, batch-major ``(B, S, H, D)`` as in the reference.

``impl`` of :func:`flash_attention`:

* ``"auto"``  — the CUDA kernel for a CUDA tensor, the plain version for a
  CPU tensor (the only reason the plain version runs on the main path);
* ``"plain"`` — the plain version on any device, so that tests and
  ``chip_smoke.py`` can hold the kernel against it.

Prefix-LM masking (``prefix_len > 0``) and a value width other than the key
width (MLA prefill) are not on this slice's path: on a CUDA tensor they
raise ``NotImplementedError`` and do not fall back.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention as flash_attention_cuda
from .ref import attention_ref

__all__ = ["flash_attention", "decode_attention"]


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    prefix_len: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatch on ``impl`` and on what the kernel covers; the wrapper owns
    the scale default, the shape checks and the CPU branch."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r} (want 'auto' or 'plain')")
    no_kernel = prefix_len > 0 or v.shape[-1] != q.shape[-1]
    if impl == "auto" and no_kernel and q.device.type != "cpu":
        if prefix_len > 0:
            raise NotImplementedError(
                "prefix-LM masking has no CUDA kernel yet; it comes with the enc-dec/prefix-LM slice"
            )
        raise NotImplementedError(
            "a value width other than the key width (MLA prefill) has no CUDA kernel yet; "
            "it comes with the MoE/MLA slice"
        )
    if impl == "plain" or no_kernel:
        return attention_ref(q, k, v, causal=causal, scale=scale, prefix_len=prefix_len)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale)


def decode_attention(
    q: torch.Tensor,  # (B, Hq, D) — one new token
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    cache_len,  # (B,) tensor or an int — valid prefix length (inclusive of new token)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over a KV cache (bandwidth-bound; plain torch,
    as the reference computes it outside any kernel)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = float(scale if scale is not None else D ** -0.5)
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * scale
    cache_len = torch.as_tensor(cache_len, device=q.device)
    if cache_len.ndim == 0:
        cache_len = cache_len.expand(B)
    valid = torch.arange(S, device=q.device)[None, :] < cache_len[:, None]
    s = s.masked_fill(~valid[:, None, None, :], torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)
