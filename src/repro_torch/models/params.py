"""Parameter descriptors and their materialization.

Every model builds a tree (nested dicts) of :class:`ParamDef` (shape +
logical axis names + init recipe), as the reference does.  From it,
:func:`init_params` draws the tensors and :class:`ParamTree` holds them as an
``nn.Module`` whose children mirror the tree's keys, so the layer functions
read ``params["attn"]["wq"]`` from a module and from a plain dict alike.

The init recipes are the reference's: normal with std ``fan_in^-0.5``
(``fan_in`` = the leading dimension), ``out_proj`` at ``0.02/√2``,
``embed`` at the def's scale, zeros and ones as named.  The draws come from
one seeded ``torch.Generator`` in sorted-key order; their bits are not
``jax.random``'s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

__all__ = ["ParamDef", "init_params", "iter_leaves", "ParamTree"]


@dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + init."""

    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed | out_proj
    scale: Optional[float] = None  # stddev override for normal inits
    dtype: Any = None  # overrides the model param dtype when set

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"axes {self.logical_axes} do not match shape {self.shape}")


def iter_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` over a nested dict in sorted-key order, paths joined by ``/``."""
    for key in sorted(tree):
        sub = tree[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(sub, dict):
            yield from iter_leaves(sub, path)
        else:
            yield path, sub


def _materialize(defn: ParamDef, generator: torch.Generator, default_dtype, device) -> torch.Tensor:
    dtype = defn.dtype or default_dtype
    shape = defn.shape
    if defn.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if defn.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 1 else 1
    if defn.init == "embed":
        std = defn.scale if defn.scale is not None else 1.0
    elif defn.init == "out_proj":
        # residual-branch output projections get depth-scaled-down init
        std = defn.scale if defn.scale is not None else 0.02 / math.sqrt(2.0)
    else:
        std = defn.scale if defn.scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def init_params(defs, generator: torch.Generator, dtype=torch.float32, device="cuda"):
    """Materialize a ParamDef tree on ``device`` from ``generator`` (which
    must live on that device's type)."""

    def walk(tree):
        out = {}
        for key in sorted(tree):
            sub = tree[key]
            out[key] = walk(sub) if isinstance(sub, dict) else _materialize(sub, generator, dtype, device)
        return out

    return walk(defs)


class ParamTree(nn.Module):
    """An ``nn.Module`` over a nested dict of tensors: a dict becomes a child
    module, a tensor an ``nn.Parameter`` (sharing the tensor's storage), each
    under its key.  ``tree["key"]`` and ``"key" in tree`` read it as the
    reference's layer functions read a parameter dict."""

    def __init__(self, tree: Dict[str, Any]) -> None:
        super().__init__()
        for key in sorted(tree):
            sub = tree[key]
            if isinstance(sub, dict):
                self.add_module(key, ParamTree(sub))
            else:
                self.register_parameter(key, nn.Parameter(sub, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules
