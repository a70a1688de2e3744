"""Plain PyTorch versions of the port's kernels (the correctness oracles).

These are naive on purpose (full score matrices, fp32 throughout): the CPU
path of every wrapper, and what ``chip_smoke.py`` holds each kernel against
on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    prefix_len: int = 0,  # prefix-LM: bidirectional over the first N positions
    kv_len: Optional[torch.Tensor] = None,  # (B,) per-batch valid cache length
) -> torch.Tensor:
    """Full-softmax GQA attention with fp32 accumulation.

    Query head ``h`` reads kv head ``h // group``.  With ``causal`` the last
    query aligns with the last key.  A row with no visible key gives zeros,
    as the flash kernels do (the softmax of an all-masked row is undefined).
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv != 0:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    qf = q.float().reshape(B, Sq, Hkv, G, D)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale

    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)  # align last q with last k
        ki = torch.arange(Sk, device=q.device)[None, :]
        cmask = qi >= ki
        if prefix_len > 0:
            cmask = cmask | (ki < prefix_len)
        mask = mask & cmask[None]
    if kv_len is not None:
        valid = torch.arange(Sk, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
        mask = mask & valid[:, None, :]
    neg = torch.finfo(torch.float32).min
    s = s.masked_fill(~mask[:, None, None], neg)

    p = torch.softmax(s, dim=-1)
    p = p * mask.any(dim=-1)[:, None, None, :, None]  # all-masked rows → 0
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Sq, Hq, -1).to(q.dtype)
