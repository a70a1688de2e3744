"""Step builders + abstract input specs for every (arch × shape × mesh).

The reference's ``launch/steps.py`` over the port's models.
:func:`build_cell` returns everything the dry run (and a real launch)
needs for one cell: the step callable, abstract example args (tensors on
the ``meta`` device: no allocation, 398B params stay virtual), their
placements on the plan's mesh (the reference's in-shardings) and the
donation.

Step selection per shape kind (assignment rules):
  train_*   → train_step   (fwd+bwd+AdamW, grad-accum microbatches)
  prefill_* → prefill_step (forward + cache emission, no grad)
  decode_* / long_* → serve_step (one token through the full stack + cache)

Each step takes the reference's arguments, with the parameters as the
nested dict :func:`~repro_torch.models.model_defs` keys (one entry per
layer, not the reference's stacked leaves), and runs under the plan's
activation rules.  It builds its model over them
(``Transformer.from_params``), so a train step updates them in place (the
reference donates them) and a decode step writes its cache in place.
:func:`materialize` turns a cell's abstract inputs into real tensors, so a
cell can also run, and :func:`place` puts them on the plan's mesh as
DTensors at ``cell.in_shardings`` (the reference's ``jax.jit(cell.fn,
in_shardings=...)``): the step then runs sharded, each kernel on every
rank's local shard (``kernels.shards``, built on ``launch.dtensors``),
and :func:`full_tensor` gathers what it returns.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig, torch_dtype
from ..models import Transformer, activation_sharding, init_cache, model_defs
from ..models.params import init_params, map_tree, spec_placements
from ..optim import adamw_init, ef_state_init
from ..train.trainer import TrainConfig, functional_train_step
from .mesh import mesh_axis_sizes
from .shardings import PlanOverrides, ShardingPlan, make_plan

__all__ = ["CellSpec", "build_cell", "default_microbatches", "model_flops_for_cell", "abstract_params",
           "materialize", "place", "full_tensor"]


@dataclass
class CellSpec:
    arch: str
    shape: ShapeConfig
    step_name: str  # train_step | prefill_step | serve_step
    fn: Callable
    args: Tuple[Any, ...]  # trees of meta tensors
    in_shardings: Tuple[Any, ...]  # trees of DTensor placement lists on plan.mesh
    donate_argnums: Tuple[int, ...]
    plan: ShardingPlan
    chips: int
    model_flops: float  # 6·N·D / 2·N·D for this cell (all chips)
    cfg: Optional[ModelConfig] = None  # the config after the overrides
    tcfg: Optional[TrainConfig] = None  # a train cell's


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig, dp_size: int) -> int:
    if shape.kind != "train":
        return 1
    per_dp = max(1, shape.global_batch // dp_size)
    n = cfg.param_count()
    target_mb = 1 if n >= 5e9 else (2 if n >= 1e9 else 4)
    return max(1, per_dp // target_mb)


def model_flops_for_cell(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.param_count(active_only=True)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_active * shape.tokens


def abstract_params(defs, dtype: torch.dtype, device="meta"):
    """The parameter tree of ``defs`` as empty tensors (each leaf in its
    def's dtype or ``dtype``) on ``device``: on ``meta`` nothing is
    allocated."""
    return map_tree(lambda d: torch.empty(d.shape, dtype=d.dtype or dtype, device=device), defs)


def _flat(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested dict's leaves by dotted path (``named_parameters``' names)."""
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        out.update(_flat(sub, name + ".") if isinstance(sub, dict) else {name: sub})
    return out


def _batch_struct(cfg: ModelConfig, shape: ShapeConfig, plan: ShardingPlan, *, with_labels: bool):
    """Abstract training/prefill batch for this architecture family, and
    each key's placements."""
    B, S = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    batch: Dict[str, Any] = {"tokens": torch.empty((B, S), dtype=torch.int32, **meta)}
    if with_labels:
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, **meta)
    if cfg.encdec:
        batch["enc_embeds"] = torch.empty((B, S, cfg.d_model), dtype=cfg.compute_tdtype(), **meta)
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.empty((B, cfg.vision_tokens, cfg.d_model), dtype=cfg.compute_tdtype(), **meta)
    rule = spec_placements(plan.batch_rule, plan.mesh)
    return batch, {k: rule for k in batch}


def _cfg_with(cfg: ModelConfig, overrides: PlanOverrides) -> ModelConfig:
    """``cfg`` with the overrides' model levers (remat, kv-cache dtype, SSD
    chunk); raises on a decode loop the port does not run."""
    if overrides.decode_loop not in (None, "inplace"):
        raise ValueError(f"PlanOverrides.decode_loop={overrides.decode_loop!r}: the port's decode step writes its "
                         "cache in place, one layer after another (the reference's 'inplace'); it has no 'scan' "
                         "loop")
    updates: Dict[str, Any] = {}
    if overrides.remat is not None:
        updates["remat"] = overrides.remat
    if overrides.kv_cache_dtype is not None:
        updates["kv_cache_dtype"] = overrides.kv_cache_dtype
    if overrides.decode_loop is not None:
        updates["decode_loop"] = overrides.decode_loop
    if overrides.ssd_chunk is not None and cfg.ssm is not None:
        updates["ssm"] = replace(cfg.ssm, chunk=overrides.ssd_chunk)
    return replace(cfg, **updates) if updates else cfg


def build_cell(
    arch: str,
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    *,
    overrides: PlanOverrides = PlanOverrides(),
    tcfg: Optional[TrainConfig] = None,
    attn_impl: str = "auto",
) -> CellSpec:
    plan = make_plan(cfg, shape, mesh, overrides)
    sizes = mesh_axis_sizes(mesh)
    chips = 1
    for n in sizes.values():
        chips *= int(n)
    dp_size = 1
    for a in plan.dp:
        dp_size *= int(sizes[a])
    cfg = _cfg_with(cfg, overrides)

    params_abs = abstract_params(model_defs(cfg), cfg.param_tdtype())
    pplace = plan.placements(plan.param_specs)
    mf = model_flops_for_cell(cfg, shape)

    def with_rules(fn):
        @functools.wraps(fn)
        def wrapped(*args):
            with activation_sharding(plan.act_rules):
                return fn(*args)

        return wrapped

    cell = functools.partial(CellSpec, arch, shape, plan=plan, chips=chips, model_flops=mf, cfg=cfg)
    if shape.kind == "train":
        n_micro = (
            overrides.microbatches
            if overrides.microbatches is not None
            else default_microbatches(cfg, shape, dp_size)
        )
        tcfg = tcfg or TrainConfig(microbatches=n_micro, accum_dtype=overrides.accum_dtype or "float32")
        step = with_rules(functional_train_step(cfg, tcfg))
        flat = _flat(params_abs)
        opt_abs = adamw_init(flat, torch_dtype(cfg.opt_state_dtype))
        flat_place = _flat(pplace)
        opt_place: Dict[str, Any] = {"m": dict(flat_place), "v": dict(flat_place)}
        if tcfg.compress_grads:
            opt_abs["ef"] = ef_state_init(flat)
            opt_place["ef"] = dict(flat_place)
        opt_place["step"] = spec_placements((), mesh)
        opt_place = {k: opt_place[k] for k in opt_abs}  # the state's own key order
        batch, batch_place = _batch_struct(cfg, shape, plan, with_labels=True)
        return cell("train_step", step, (params_abs, opt_abs, batch), (pplace, opt_place, batch_place),
                    donate_argnums=(0, 1), tcfg=tcfg)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            model = Transformer.from_params(cfg, params)
            return model.prefill(batch["tokens"], enc_embeds=batch.get("enc_embeds"),
                                 vision_embeds=batch.get("vision_embeds"), attn_impl=attn_impl)

        batch, batch_place = _batch_struct(cfg, shape, plan, with_labels=False)
        return cell("prefill_step", with_rules(prefill_step), (params_abs, batch), (pplace, batch_place),
                    donate_argnums=())

    # decode / long-context decode: one new token against a seq_len cache
    B = shape.global_batch
    max_len = shape.seq_len + (cfg.vision_tokens or 0)
    enc_len = shape.seq_len if cfg.encdec else 0
    cache_abs = init_cache(cfg, B, max_len, enc_len=enc_len, device="meta")
    cache_place = plan.placements(plan.cache_specs_fn(cache_abs))
    io = spec_placements((plan.dp if not plan.long_context else None,), mesh)

    def serve_step(params, cache, tokens, pos):
        return Transformer.from_params(cfg, params).decode_step(cache, tokens, pos)

    args = (
        params_abs,
        cache_abs,
        torch.empty((B,), dtype=torch.int32, device="meta"),
        torch.empty((B,), dtype=torch.int32, device="meta"),
    )
    return cell("serve_step", with_rules(serve_step), args, (pplace, cache_place, io, io), donate_argnums=(1,))


def materialize(cell: CellSpec, device="cuda", seed: int = 0) -> Tuple[Any, ...]:
    """Real tensors on ``device`` for ``cell``'s abstract inputs, each of
    its shape and dtype: the parameters through the model's own init from
    ``seed`` (the weights ``Transformer(cfg, device=, seed=)`` draws),
    zeroed AdamW moments (and error feedback), token ids, labels and stub
    embeddings drawn from a generator seeded ``seed + 1``, a zeroed cache
    and a decode step's positions at the cache's last row (each sequence
    attends over all of it)."""
    cfg = cell.cfg
    device = torch.device(device)
    init = init_params(model_defs(cfg), torch.Generator(device=device).manual_seed(seed), cfg.param_tdtype(), device)

    def take(abstract, real):
        return {k: take(abstract[k], real[k]) if isinstance(abstract[k], dict) else real[k] for k in abstract}

    params = take(cell.args[0], init)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def draw(t: torch.Tensor) -> torch.Tensor:
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen, dtype=t.dtype, device=device)
        return torch.randn(t.shape, generator=gen, dtype=torch.float32, device=device).to(t.dtype)

    if cell.step_name == "train_step":
        flat = _flat(params)
        opt = adamw_init(flat, torch_dtype(cfg.opt_state_dtype))
        if "ef" in cell.args[1]:
            opt["ef"] = ef_state_init(flat)
        return params, opt, {k: draw(v) for k, v in cell.args[2].items()}
    if cell.step_name == "prefill_step":
        return params, {k: draw(v) for k, v in cell.args[1].items()}
    cache = {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in cell.args[1].items()}
    tokens = draw(cell.args[2])
    last = cell.shape.seq_len + (cfg.vision_tokens or 0) - 1
    pos = torch.full(cell.args[3].shape, last, dtype=torch.int32, device=device)
    return params, cache, tokens, pos


def place(cell: CellSpec, args: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """``args`` (:func:`materialize`'s, on the mesh's device: the card for an
    NCCL mesh) as DTensors on ``cell.plan.mesh`` at ``cell.in_shardings``.
    Each rank must hold the same values (``materialize`` from one seed), so
    each keeps its own shard and nothing is sent; a leaf that is a DTensor
    already (an earlier step's cache, placed parameters) stays as it is.  A
    dict of ``args`` is placed in place, leaf by leaf, each full tensor
    dropped as its shard is made, so no full tree is held twice.  The
    donation is the reference's: a train step updates the placed parameters
    and optimizer state in place, a decode step writes the placed cache."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = cell.plan.mesh

    def put(t: torch.Tensor, placements):
        return t if isinstance(t, DTensor) else distribute_tensor(t, mesh, placements, src_data_rank=None)

    def walk(tree, placements):
        if not isinstance(tree, dict):
            return put(tree, placements)
        for key in list(tree):
            tree[key] = walk(tree[key], placements[key])
        return tree

    return tuple(walk(a, p) for a, p in zip(args, cell.in_shardings))


def full_tensor(tree):
    """``tree`` (nested dicts, tuples or lists) with every DTensor gathered
    into a plain tensor (``DTensor.full_tensor``); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_tensor(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(full_tensor(v) for v in tree)
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
