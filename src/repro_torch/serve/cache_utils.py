"""Cache utilities shared by the serving engine and tests."""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["transplant", "cache_bytes"]


def transplant(big: Dict[str, torch.Tensor], small: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy a prefill cache (prompt-length buffers) into a full-size decode
    cache **in place** and return ``big``.  Leaves with equal shapes are
    copied outright; leaves differing in exactly one axis (the sequence axis)
    are written at offset 0 there.  ``big`` may be a view (one slot of the
    engine's cache)."""
    if big.keys() != small.keys():
        raise ValueError(f"cache keys differ: {sorted(big)} vs {sorted(small)}")
    for key, b in big.items():
        s = small[key]
        if b.ndim != s.ndim:
            raise ValueError(f"cache rank mismatch: {tuple(b.shape)} vs {tuple(s.shape)}")
        diff = [i for i in range(b.ndim) if b.shape[i] != s.shape[i]]
        if len(diff) > 1:
            raise ValueError(f"cache shape mismatch: {tuple(b.shape)} vs {tuple(s.shape)}")
        dst = b if not diff else b.narrow(diff[0], 0, s.shape[diff[0]])
        dst.copy_(s)
    return big


def cache_bytes(cache: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())
