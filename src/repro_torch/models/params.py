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
``jax.random``'s.  A normal leaf is drawn in fp32 and scaled in place
before its cast; a stacked experts leaf (leading axis ``"experts"``, up to
16 × 8192 × 24576 values at jamba's width) is drawn one expert at a time
straight into a tensor of the parameter dtype, so no fp32 copy of the whole
leaf is ever held.

The sharding vocabulary is the reference's too: :data:`DEFAULT_RULES` maps
logical axes to mesh axes, :func:`logical_to_pspec` turns one leaf's axes
into a :class:`PartitionSpec` (dropping assignments that do not divide the
dim, each mesh axis to its leftmost claim), and :func:`param_pspecs` does
so over a ParamDef tree.  The port's ``PartitionSpec`` is a tuple of
per-dim entries (``None``, a mesh axis name, or a tuple of names), equal as
a tuple to the reference's ``jax.sharding.PartitionSpec``;
``launch.shardings.ShardingPlan.placements`` turns it into DTensor
placements.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

__all__ = [
    "ParamDef",
    "PartitionSpec",
    "LogicalRules",
    "DEFAULT_RULES",
    "init_params",
    "iter_leaves",
    "map_tree",
    "ParamTree",
    "logical_to_pspec",
    "param_pspecs",
    "spec_placements",
]


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


class PartitionSpec(tuple):
    """One leaf's sharding: a tuple of per-dim entries, each ``None``
    (replicated), a mesh axis name, or a tuple of names (the dim split over
    those axes, outermost first); trailing dims left out are replicated.
    ``PartitionSpec("data", None)`` is the reference's ``P("data", None)``;
    as there, a one-name tuple entry is that name (``PartitionSpec(("data",))
    == ("data",)``), an empty one ``None`` and a list a tuple."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                return None if not p else p[0] if len(p) == 1 else tuple(p)
            return p

        return super().__new__(cls, (norm(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


#: logical axis name → mesh axis (str), tuple of mesh axes, or None.
LogicalRules = Mapping[str, Union[str, Tuple[str, ...], None]]

#: Production rules, the reference's (``models/params.py:61``).  "embed" rides
#: the FSDP (data) axis; head/mlp/expert/vocab dims ride the TP/EP (model)
#: axis; batch rides (pod, data); long-context cache sequence rides data (SP).
DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("pod", "data"),
    "embed": "data",  # FSDP param shard
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "qk_dim": None,
    "v_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": "data",  # within-expert Megatron MLP sharding
    "kv_lora": None,
    "seq": None,
    "cache_seq": None,  # switched to "data" by the long-context policy
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,  # stacked superblock leading dim
    "stack": None,
}


def iter_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` over a nested dict in sorted-key order, paths joined by ``/``."""
    for key in sorted(tree):
        sub = tree[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(sub, dict):
            yield from iter_leaves(sub, path)
        else:
            yield path, sub


def map_tree(fn: Callable[[Any], Any], tree):
    """``fn`` over every leaf of a nested dict (anything not a dict is a
    leaf: a ParamDef, a tensor, a PartitionSpec), keeping the keys."""
    if isinstance(tree, dict):
        return {key: map_tree(fn, sub) for key, sub in tree.items()}
    return fn(tree)


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
    if defn.logical_axes[0] == "experts":
        out = torch.empty(shape, dtype=dtype, device=device)
        for e in range(shape[0]):
            out[e] = torch.randn(shape[1:], generator=generator, dtype=torch.float32, device=device).mul_(std)
        return out
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device).mul_(std).to(dtype)


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


def logical_to_pspec(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    rules: LogicalRules,
    mesh_axis_sizes: Mapping[str, int],
) -> PartitionSpec:
    """Map logical axes → PartitionSpec, dropping non-divisible assignments
    (the reference's ``logical_to_pspec``, ``models/params.py:139``).

    A mesh axis may appear at most once in a spec; first (leftmost) logical
    axis wins, later claims fall back to replicated.  Trailing replicated
    dims are stripped.
    """
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical_axes):
        assignment = rules.get(name) if name is not None else None
        if assignment is None:
            parts.append(None)
            continue
        axes = (assignment,) if isinstance(assignment, str) else tuple(assignment)
        # keep only mesh axes that exist, are unused, and divide the dim
        chosen = []
        prod = 1
        for ax in axes:
            size = mesh_axis_sizes.get(ax)
            if size is None or ax in used:
                continue
            if dim % (prod * size) == 0:
                chosen.append(ax)
                prod *= size
        used.update(chosen)
        if not chosen:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(tuple(chosen))
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def param_pspecs(defs, rules: LogicalRules, mesh):
    """PartitionSpec tree matching a ParamDef tree, on ``mesh`` (a
    ``DeviceMesh`` with ``mesh_dim_names``)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return map_tree(lambda d: logical_to_pspec(d.logical_axes, d.shape, rules, sizes), defs)


def spec_placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the spec puts that mesh axis on tensor dim ``d``,
    ``Replicate()`` otherwise.  A dim split over several axes (``("pod",
    "data")``) becomes one ``Shard(d)`` on each, which DTensor nests in mesh
    order, so the tuple must name its axes in mesh order: a tuple out of
    that order has no plain DTensor counterpart and raises ``ValueError``,
    as does an axis the mesh lacks or names twice."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for ax in axes:
            if ax not in names:
                raise ValueError(f"{spec!r}: mesh axes are {names}, not {ax!r}")
            if ax in seen:
                raise ValueError(f"{spec!r}: mesh axis {ax!r} is named twice")
            seen.add(ax)
        order = [names.index(ax) for ax in axes]
        if order != sorted(order):
            raise ValueError(f"{spec!r}: dim {dim} is split over {axes}, not in the mesh's order {names}; "
                             "DTensor nests the shards of one dim in mesh order")
        for i in order:
            out[i] = Shard(dim)
    return out


class ParamTree(nn.Module):
    """An ``nn.Module`` over a nested dict of tensors: a dict becomes a child
    module, a tensor a trainable ``nn.Parameter`` (sharing the tensor's
    storage), each under its key.  ``tree["key"]`` and ``"key" in tree`` read
    it as the reference's layer functions read a parameter dict.  The
    inference entry points (``prefill``, ``decode_step``) run under
    ``torch.no_grad()``, so serving records no graph."""

    def __init__(self, tree: Dict[str, Any]) -> None:
        super().__init__()
        for key in sorted(tree):
            sub = tree[key]
            if isinstance(sub, dict):
                self.add_module(key, ParamTree(sub))
            else:
                self.register_parameter(key, nn.Parameter(sub))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules
