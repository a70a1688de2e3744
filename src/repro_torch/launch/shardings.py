"""Sharding policy: logical-axis rules per (config × shape × mesh).

The reference's ``launch/shardings.py`` over a ``torch.distributed``
``DeviceMesh``.  One function — :func:`make_plan` — returns everything a
step needs:

* ``param_specs``   PartitionSpec tree for parameters (FSDP over "data",
  TP/EP over "model", divisibility-checked), keyed as the port's
  ``model_defs`` (one entry per layer: the reference's stacked leading
  ``layers`` axis, which its rules leave replicated, is not there),
* ``act_rules``     logical→mesh mapping installed around a step
  (:mod:`repro_torch.models.act_sharding`),
* ``batch_rule``    input-batch PartitionSpec,
* ``cache_specs_fn`` decode-cache PartitionSpec tree (KV batch-sharded; for
  ``long_500k`` the cache sequence axis rides "data" — sequence parallelism
  — because global_batch=1 leaves the DP axes idle).

:meth:`ShardingPlan.placements` turns a spec tree into DTensor placements
(the reference's ``ShardingPlan.named``).  Overrides (the hillclimbing
levers) are threaded through ``PlanOverrides``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from ..models.params import DEFAULT_RULES, PartitionSpec as P, map_tree, param_pspecs, spec_placements
from ..models.transformer import model_defs
from .mesh import dp_axes, mesh_axis_sizes

__all__ = ["ShardingPlan", "PlanOverrides", "make_plan"]


@dataclass(frozen=True)
class PlanOverrides:
    """Hillclimbing levers (all optional), the reference's: the first four
    :func:`make_plan` reads; the step factory (:func:`~.steps.build_cell`)
    reads the rest, and raises on a value the port does not honour (the
    decode loop: the port's decode step writes its cache in place, so only
    ``"inplace"``)."""

    param_rules: Dict[str, Any] = field(default_factory=dict)  # logical→axis overrides
    act_rules: Dict[str, Any] = field(default_factory=dict)
    fsdp: bool = True  # shard params over "data" (ZeRO-3) or replicate
    seq_shard_long: bool = True  # long-context: cache seq on "data"
    remat: Optional[str] = None  # none | dots | full
    microbatches: Optional[int] = None
    kv_cache_dtype: Optional[str] = None
    decode_loop: Optional[str] = None  # inplace | scan
    ssd_chunk: Optional[int] = None
    accum_dtype: Optional[str] = None  # grad accumulator dtype


@dataclass
class ShardingPlan:
    mesh: Any  # DeviceMesh
    param_specs: Any
    act_rules: Dict[str, Any]
    batch_rule: P
    cache_specs_fn: Callable[[Any], Any]  # cache tree -> spec tree
    dp: Tuple[str, ...]
    long_context: bool

    def placements(self, spec_tree):
        """The tree of DTensor placement lists for ``spec_tree`` on this
        plan's mesh (``models.params.spec_placements`` per leaf)."""
        return map_tree(lambda s: spec_placements(s, self.mesh), spec_tree)


def _divides(dim: int, mesh_sizes: Dict[str, int], assignment) -> Optional[Any]:
    if assignment is None:
        return None
    axes = (assignment,) if isinstance(assignment, str) else tuple(assignment)
    prod = 1
    ok = []
    for a in axes:
        s = mesh_sizes.get(a)
        if s is None:
            continue
        if dim % (prod * s) == 0:
            ok.append(a)
            prod *= s
    if not ok:
        return None
    return ok[0] if len(ok) == 1 else tuple(ok)


def make_plan(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    overrides: PlanOverrides = PlanOverrides(),
) -> ShardingPlan:
    sizes = mesh_axis_sizes(mesh)
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    long_context = shape.kind == "decode" and shape.global_batch < dp_size

    # ---------------- parameter rules -------------------------------------------
    rules = dict(DEFAULT_RULES)
    rules["batch"] = dp
    if not overrides.fsdp:
        rules["embed"] = None
    rules.update(overrides.param_rules)
    param_specs = param_pspecs(model_defs(cfg), rules, mesh)

    # ---------------- activation rules -------------------------------------------
    act_rules: Dict[str, Any] = {
        "__axis_sizes__": sizes,
        "batch": dp if not long_context else None,
        "seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "vocab_logits": "model",
        "experts": "model",
    }
    act_rules.update(overrides.act_rules)

    # ---------------- batch inputs -------------------------------------------------
    batch_rule = P(dp if not long_context else None)

    # ---------------- decode-cache specs --------------------------------------------
    seq_axis = "data" if (long_context and overrides.seq_shard_long) else None
    batch_axis = dp if not long_context else None

    def leaf_spec(name: str, shape) -> P:
        # every leaf of the port's cache carries a leading layer-stack axis
        # (one stack per kind of layer), replicated as the reference's
        # superblock-repeat axis is
        lead = (None,)
        shp = tuple(shape[1:])

        def dv(dim, a):
            return _divides(dim, sizes, a)

        if name in ("k", "v", "cross_k", "cross_v"):  # (B, S, Hkv, hd)
            heads_ax = dv(shp[2], "model")
            # kv heads not divisible by the TP axis (e.g. qwen2's 8 kv heads
            # on a 16-wide model axis) would replicate the cache 16× — shard
            # the cache *sequence* over "model" instead
            seq_ax = dv(shp[1], seq_axis) if heads_ax is not None else (
                dv(shp[1], seq_axis) or dv(shp[1], "model")
            )
            spec = (dv(shp[0], batch_axis), seq_ax, heads_ax, None)
        elif name == "ckv":  # (B, S, C) — MLA latent: no head dim, shard seq
            spec = (dv(shp[0], batch_axis), dv(shp[1], seq_axis) or dv(shp[1], "model"), None)
        elif name in ("conv_x", "conv_B", "conv_C"):  # (B, W-1, ...)
            spec = (dv(shp[0], batch_axis),) + (None,) * (len(shp) - 1)
        elif name == "h":  # (B, H, P, N)
            spec = (dv(shp[0], batch_axis), dv(shp[1], "model"), None, None)
        else:
            spec = (None,) * len(shp)
        return P(*(lead + tuple(spec)))

    def cache_specs(cache_tree):
        """The spec of each leaf of a cache tree (nested dicts of tensors
        or anything with a ``.shape``; a leaf's rule is read from its key)."""
        return {key: cache_specs(sub) if isinstance(sub, dict) else leaf_spec(key, sub.shape)
                for key, sub in cache_tree.items()}

    return ShardingPlan(
        mesh=mesh,
        param_specs=param_specs,
        act_rules=act_rules,
        batch_rule=batch_rule,
        cache_specs_fn=cache_specs,
        dp=dp,
        long_context=long_context,
    )
