"""Activation-sharding constraints decoupled from model code.

Models call :func:`constrain(x, "batch", "seq", None)` with *logical* axis
names; the launcher installs a logical→mesh mapping for the duration of a
step via :func:`activation_sharding` (the reference's
``models/act_sharding.py``).  Outside any mapping constraints are no-ops, so
model code never depends on a mesh.

Under a mapping, a ``DTensor`` is redistributed to the placements the
reference's spec would give (assignments that do not divide the dim
dropped, as the reference does); a plain tensor is returned as it is, as
the reference returns ``x`` where ``with_sharding_constraint`` does not
apply.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Mapping, Optional

import torch

from .params import PartitionSpec, spec_placements

__all__ = ["activation_sharding", "constrain", "current_rules", "logical_spec"]

_RULES: contextvars.ContextVar[Optional[Mapping[str, object]]] = contextvars.ContextVar(
    "activation_rules", default=None
)


def current_rules() -> Optional[Mapping[str, object]]:
    return _RULES.get()


@contextlib.contextmanager
def activation_sharding(rules: Optional[Mapping[str, object]]):
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


def logical_spec(shape, logical, rules: Mapping[str, object]) -> PartitionSpec:
    """The spec :func:`constrain` asks for: each logical name's mesh axes
    under ``rules``, keeping those that divide the dim (mesh sizes in the
    rules' ``"__axis_sizes__"``)."""
    sizes = rules.get("__axis_sizes__", {})
    parts = []
    for dim, name in zip(shape, logical):
        ax = rules.get(name) if name is not None else None
        if ax is None:
            parts.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        prod = 1
        ok = []
        for a in axes:
            s = sizes.get(a, 1)
            if dim % (prod * s) == 0:
                ok.append(a)
                prod *= s
        if not ok:
            parts.append(None)
        elif len(ok) == 1:
            parts.append(ok[0])
        else:
            parts.append(tuple(ok))
    return PartitionSpec(*parts)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    rules = _RULES.get()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, spec_placements(logical_spec(x.shape, logical, rules), mesh))
