"""Carry the reference's weights into a :class:`Transformer`.

The reference keeps its decoder layers stacked on a leading axis
(``blocks/pos_<p>/...`` of shape ``(repeats, ...)``, after ``prefix_<j>``
layers); the port keeps one module per layer.  :func:`load_jax_params`
takes the reference's parameter tree with numpy leaves and unstacks it.
This module imports numpy and torch only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .params import iter_leaves
from .transformer import Transformer

__all__ = ["load_jax_params", "flatten_jax_tree"]


def flatten_jax_tree(tree, cfg) -> Dict[str, np.ndarray]:
    """The reference's tree as ``{port parameter name: array}``, with
    ``blocks/pos_<p>`` leaves split into ``layers.<i>`` ones."""
    n_prefix = cfg.moe.first_k_dense if cfg.moe else 0
    period = cfg.superblock_period
    out: Dict[str, np.ndarray] = {}
    for path, arr in iter_leaves(tree):
        parts = path.split("/")
        if parts[0] == "blocks" and parts[1].startswith("pos_"):
            p = int(parts[1][len("pos_"):])
            rest = ".".join(parts[2:])
            for r in range(arr.shape[0]):
                out[f"layers.{n_prefix + r * period + p}.{rest}"] = arr[r]
        elif parts[0].startswith("prefix_"):
            out[f"layers.{int(parts[0][len('prefix_'):])}." + ".".join(parts[1:])] = arr
        else:
            out[".".join(parts)] = arr
    return out


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or arr.dtype.kind == "V":  # ml_dtypes bfloat16
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def load_jax_params(model: Transformer, tree) -> Transformer:
    """Copy the reference's parameters (a nested dict of numpy arrays, as
    ``repro.models.init_params`` returns them after ``np.asarray`` on each
    leaf) into ``model`` in place.  Raises ``ValueError`` on any leaf that is
    missing, extra or of another shape; nothing is copied then."""
    flat = flatten_jax_tree(tree, model.cfg)
    params = dict(model.named_parameters())
    missing = sorted(params.keys() - flat.keys())
    extra = sorted(flat.keys() - params.keys())
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, extra {extra}")
    bad = [
        f"{name}: {tuple(flat[name].shape)} vs {tuple(p.shape)}"
        for name, p in params.items()
        if tuple(flat[name].shape) != tuple(p.shape)
    ]
    if bad:
        raise ValueError("mis-shaped leaves: " + "; ".join(bad))
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(_to_tensor(flat[name]).to(p.dtype))
    return model
