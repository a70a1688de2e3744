"""Attention and SSD ops with kernel dispatch, batch-major as in the reference.

``impl`` of :func:`flash_attention` and :func:`ssd_scan`:

* ``"auto"``  — the CUDA kernel for a CUDA tensor, the plain version for a
  CPU tensor (the only reason the plain version runs on the main path); a
  fake tensor on either device takes the kernel's path, whose wrapper
  records the launch by its shape (a cost count, ``perf.cost``);
* ``"plain"`` — the plain version on any device, so that tests and
  ``chip_smoke.py`` can hold the kernel against it.

Every mask goes to the kernel wrapper: causal or not, ``Sq != Sk``
(non-causal cross-attention, whisper's decoder over its encoder), and a
prefix-LM prefix (``prefix_len > 0``, causal self-attention: paligemma's
vision tokens), which the reference sends to its blocked jnp form
(``repro/kernels/ops.py:145``) and the port's kernels take in both
directions.  A value width other than the key width goes to the wrapper as
any other call does: MLA's prefill pair (192, 128) launches the forward
kernel, and a pair the kernels do not take raises there, naming the pairs
they take.  A CUDA call that needs a gradient goes through
:class:`FlashAttention`: the forward kernel with the rows' logsumexp, and
the backward kernel, at every pair and mask the forward takes (MLA's (192,
128) trains through both).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention as flash_attention_cuda
from .flash_attention import flash_attention_backward, is_fake
from .ref import attention_ref, ssd_chunked_ref
from .ssd_scan import ssd_scan_autograd

__all__ = ["flash_attention", "FlashAttention", "decode_attention", "ssd_scan", "ref_chunk"]


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: forward by the forward kernel, which
    also writes the rows' logsumexp; backward by the backward kernel, which
    recomputes P from it (:func:`~.flash_attention.flash_attention_backward`).
    Saves q, k, v, the output and the logsumexp, and hands the mask (causal,
    prefix) to the backward.  v may be narrower than q and k (MLA's (192,
    128)); dv then has v's width.  On CPU tensors both wrappers compute their
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, prefix_len=0):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, scale=scale, prefix_len=prefix_len, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.prefix_len = causal, scale, prefix_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # autograd may hand over an expanded or transposed gradient
            do = do.contiguous()
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, causal=ctx.causal, scale=ctx.scale,
                                              prefix_len=ctx.prefix_len)
        return (dq, dk, dv) + (None,) * (len(ctx.needs_input_grad) - 3)  # none for the mask's arguments


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
    the scale default, the shape and width checks and the CPU branch.  Off
    the CPU, a call that needs a gradient goes through :class:`FlashAttention`."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r} (want 'auto' or 'plain')")
    if impl == "plain":
        return attention_ref(q, k, v, causal=causal, scale=scale, prefix_len=prefix_len)
    if (q.device.type != "cpu" or is_fake(q)) and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, scale, prefix_len)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale, prefix_len=prefix_len)


def decode_attention(
    q: torch.Tensor,  # (B, Hq, D) — one new token
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    cache_len,  # (B,) tensor or an int — valid prefix length (inclusive of new token)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over a KV cache (bandwidth-bound; plain torch,
    as the reference computes it outside any kernel).  An int ``cache_len``
    of the whole cache (cross-attention over an encoder's output) masks
    nothing and copies nothing to the device."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = float(scale if scale is not None else D ** -0.5)
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * scale
    if not (isinstance(cache_len, int) and cache_len >= S):
        cache_len = torch.as_tensor(cache_len, device=q.device)
        if cache_len.ndim == 0:
            cache_len = cache_len.expand(B)
        valid = torch.arange(S, device=q.device)[None, :] < cache_len[:, None]
        s = s.masked_fill(~valid[:, None, None, :], torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def ref_chunk(S: int, chunk: int) -> int:
    """The reference's chunk for a sequence of ``S``: ``min(chunk, S)``,
    halved until it divides ``S`` (``ops.py:207-211``)."""
    chunk = min(chunk, S)
    while chunk > 0 and S % chunk != 0:
        chunk //= 2
    if chunk == 0:
        raise ValueError(f"no chunk divides seq len {S}")
    return chunk


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    D: Optional[torch.Tensor] = None,
    h0: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan → ``(y (B,S,H,P), final state (B,H,P,N) fp32)``, with
    a gradient.  ``chunk`` follows the reference's rule (:func:`ref_chunk`)
    for the plain version and the backward; the CUDA kernel takes any S in
    its own 64-row tiles (see :mod:`.ssd_scan`).  A CPU tensor takes the
    plain version with torch's own autograd; a CUDA tensor goes through
    :class:`~.ssd_scan.SSDScan`, whose forward is the kernel."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r} (want 'auto' or 'plain')")
    chunk = ref_chunk(x.shape[1], chunk)
    if impl == "plain" or (x.device.type == "cpu" and not is_fake(x)):
        return ssd_chunked_ref(x, dt, A, Bm, Cm, D, h0, chunk=chunk, return_state=True)
    return ssd_scan_autograd(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
