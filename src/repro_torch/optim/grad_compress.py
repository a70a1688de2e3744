"""Int8 gradient compression with error feedback, as functions on tensor
dicts (the reference's ``optim/grad_compress.py``).

Each microbatch gradient contribution is quantised to int8 with a
per-tensor scale before entering the accumulator; the quantisation residual
is carried in an fp32 error-feedback buffer and added to the next
contribution, so the *long-run* gradient is unbiased.  On a deployment the
int8 tensors are what crosses DP replicas; here the same numerics run on
one device and :func:`wire_bytes` counts what the exchange would move.

The arithmetic is the reference's: scale ``max(max|x|, 1e-12) / 127`` in
fp32, ``round`` half to even (``torch.round`` and ``jnp.round`` agree), a
clip to ±127.  The scale is per reference leaf: the reference stacks its
layers, so one tensor (and one scale) holds a parameter of every layer of
the stack, where the port keeps a tensor a layer.  ``groups`` maps each
port leaf to the reference leaf it belongs to
(``models.convert.reference_leaf``); the leaves of a group share the
group's scale, the largest ``|x|`` over all of them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..launch.dtensors import is_dtensor

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress", "ef_state_init", "wire_bytes"]

Tree = Dict[str, torch.Tensor]


def _amax(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x.float(), ord=float("inf"))


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale fp32 scalar)`` with ``x ≈ q * scale``, the scale
    from ``max|x|`` (or from ``amax``, the largest ``|x|`` of the group ``x``
    belongs to).  Holds one fp32 temporary of ``x``'s size besides ``q``."""
    xf = x.float()
    # divided by a tensor on the device: a Python scalar divisor becomes a reciprocal multiply on the card,
    # one rounding off the reference's quotient
    scale = torch.clamp(_amax(xf) if amax is None else amax, min=1e-12) / torch.full((), 127.0, device=xf.device)
    q = (xf / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float().mul_(scale)


def ef_state_init(params: Tree) -> Tree:
    """A zeroed fp32 error-feedback buffer per leaf."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}


def ef_compress(grads: Tree, ef_state: Tree, groups: Optional[Mapping[str, str]] = None) -> Tuple[Tree, Tree]:
    """``(compressed-then-decompressed grads, new error-feedback state)``,
    both fp32, for the leaves of ``grads`` (``ef_state`` may hold more).
    Each leaf is its own group unless ``groups`` names its group; a group's
    leaves must all be in ``grads``.  The new state is ``ef_state``'s own
    buffers, updated **in place** (as ``adamw_update`` updates the
    moments): each buffer takes the corrected gradient ``e + g`` and then
    its residual, so a leaf needs no fp32 copy of its gradient."""
    if is_dtensor(*grads.values(), *(ef_state[n] for n in grads)):
        raise NotImplementedError("ef_compress runs on plain tensors; int8 compression of a sharded step is not "
                                  "written yet (ROADMAP)")
    groups = groups or {}
    corrected = {n: ef_state[n].add_(g) for n, g in grads.items()}  # g.float() + e: fp32 addition commutes
    amax: Dict[str, torch.Tensor] = {}
    for n, c in corrected.items():
        key, m = groups.get(n, n), _amax(c)
        amax[key] = torch.maximum(amax[key], m) if key in amax else m
    deq = {}
    for n, c in corrected.items():
        q, s = quantize_int8(c, amax[groups.get(n, n)])
        deq[n] = dequantize_int8(q, s)
        c.sub_(deq[n])
    return deq, ef_state


def wire_bytes(params: Tree, groups: Optional[Mapping[str, str]] = None) -> int:
    """Bytes one compressed gradient exchange moves (int8 + a 4-byte scale a
    group; each leaf its own group unless ``groups`` names one)."""
    groups = groups or {}
    return sum(p.numel() for p in params.values()) + 4 * len({groups.get(n, n) for n in params})
