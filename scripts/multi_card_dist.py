#!/usr/bin/env python3
"""The port's distribution across cards: the GPipe pipeline and a sharded mesh on several ranks.

Run from the root of a checkout on a machine with two or more NVIDIA GPUs:

    python3 scripts/multi_card_dist.py                    # one rank a card (at most 4), NCCL
    python3 scripts/multi_card_dist.py --device cpu --world 4 --small   # the same on the host, gloo
    python3 scripts/multi_card_dist.py --device cpu --world 4 --small steps   # only the sharded steps
    python3 scripts/multi_card_dist.py steps --arch jamba-1.5-large-398b      # only one config's cells

It starts one process a rank (a TCP rendezvous on a free localhost port;
each process is given ``TIMEOUT_S`` and killed after) and checks, on every
rank:

* ``pipeline_toy``: ``tests/test_pipeline.py``'s stack (8 tanh layers of
  width 16, 6 microbatches of 4, fp32, seeded) as a GPipe pipeline of one
  stage a rank: its output and this rank's stage gradient of
  ``sum(out ** 2)`` against the sequential stack on the same device
  (within 2e-5), the hand-offs and their backward over NCCL;
* ``pipeline_full_width``: deepseek-7b at its published width cut to two
  layers a rank (bf16; rank 0's weights broadcast to every rank), 4
  microbatches of one 2,048-token row through one stage a rank, against the
  sequential stack on the same device, bit for bit, with the flash forward's
  launches counted and both timed after one warm-up layer;
* ``mesh``: the tiny mesh at (data 2, model world / 2), deepseek-7b's plan
  at train_4k on it, the same cut's parameters distributed by the plan's
  placements (scattered from rank 0): each rank's block equal to the slice
  its placements name, and ``full_tensor()`` bit for bit the parameter;
  twice, each pass timed (the first also opens the subgroups'
  communicators);
* ``steps``: ``build_cell``'s steps on the (data 2, model world / 2) mesh,
  their inputs placed as DTensors at ``cell.in_shardings``
  (``launch.steps.place``): deepseek-7b's prefill of 4 rows of 2,048 tokens
  and its decode step against a 2,048-row cache (uncut), its published
  width cut to 8 layers trained one step of 4 × 2,048 tokens in 2
  microbatches, mamba2-130m's train cell at its published widths cut
  to 12 layers, deepseek-v2-lite's prefill and decode cut to 8 layers and
  its train cell to 2 (experts on ``model``, their FFN width and the batch
  on ``data``; MLA's latent cache split over its sequence on ``model``),
  llama4-scout's prefill and decode cut to 2 layers, whisper-medium's and
  paligemma-3b's three cells uncut, jamba's prefill and decode cut to 2
  layers (an SSM layer and an MoE layer) and its train cell to 1: each
  cell at the depth where rank 0's one-card fp32 step fits one card (the
  last field of ``chip_smoke.SHARDED_CELLS``) (``--small``: the smoke configs,
  32-token rows), each as an fp32 control and then in its config's dtypes
  (``STEP_DTYPES``).  Rank 0
  first runs each cell's plain-tensor step alone on its card from the
  same seed (the one-card output); the sharded outputs, gathered, are
  held against it (fp32: logits over the vocabulary and each cache leaf
  within ``FP32_REL`` of their largest magnitude, the padded vocabulary
  at -1e9, a train step's loss, grad norm and each leaf's first moment
  within their bounds; in a train step each gap within its bound or
  twice the gap of the one-card step rerun with its weights nudged by a
  unit in the last place, whichever is larger; an MoE cell is held against
  the one-card step rerun on the sharded step's routes (``_pinned``; its
  nudged rerun on those routes too), and reports its gaps to the unpinned one-card step and every token the two
  route otherwise, with its top-(k+1) margin;
  bf16:
  the same outputs' gaps to the one-card fp32 step within twice the
  one-card bf16 step's, plus one bf16 unit in the last place), and the
  flash and SSD launches of each rank are counted.  Both are timed: the
  first call and the median of two warm calls on the host clock.

Name parts to run only those (``pipeline``, ``mesh``, ``steps``; all by
default).  One JSON line a rank and a last line with ``"ok"``, beside the card's name
and power limit.  Exits non-zero when a check fails, a rank fails or hangs,
or (on ``cuda``) there are fewer than two cards.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    SHARDED_CELLS,
    SHARDED_MICRO,
    SHARDED_SEED,
    expected_kernels,
    kernel_launches,
    zero_launches,
)

TIMEOUT_S = 1200
TOY_TOL = 2e-5
#: the full-width pipeline: layers a stage, microbatches, tokens a microbatch (--small: the smoke config's)
LAYERS_A_STAGE, MICRO, SEQ, SMALL_SEQ = 2, 4, 2048, 32
PARTS = ("pipeline", "mesh", "steps")
#: each steps cell (chip_smoke.py's SHARDED_CELLS, seed and microbatches) runs as an fp32 control (parameters
#: and compute in fp32), then in its config's dtypes (bf16 at full width).  The fp32 cells hold logits and
#: cache within FP32_REL of scale, and a train step's loss, grad norm and each leaf's first moment (the clipped
#: gradient; relative L2) within FP32_REL and FP32_GRAD_L2 (tests/test_torch_train.py's first-step bounds)
#: or twice the gap of the one-card step rerun with every weight moved by one unit in its last place
#: (``_nudge``), whichever is larger: a leaf whose gradient is a small sum of large terms (a norm's scale,
#: attention's q and k at this init) moves by far more than a rounding under any change of its sums' order.
#: A bf16 cell is held against its own rounding: the one-card bf16 step's gap to the one-card fp32 step of
#: the same weights (bf16 weights are the fp32 draws rounded) is the floor, and the sharded bf16 step's gap
#: to that fp32 step must lie within BF16_FLOOR_TIMES the floor plus BF16_SLACK, for the logits, each cache
#: leaf, the loss, the grad norm and each leaf's first moment.  bf16 rounds each rank's partial products
#: before the cross-rank sum, so the sharded step may stray from fp32 farther than the one-card step does;
#: the bound lets it stray twice as far, and the slack (one unit in bf16's last place) keeps a floor that is
#: near 0 by chance (a scalar: the loss, the grad norm) from failing a step that is one rounding off
STEP_DTYPES = ("float32", "bfloat16")
FP32_REL, FP32_GRAD_L2 = 1e-3, 2e-3
BF16_FLOOR_TIMES, BF16_SLACK = 2.0, torch.finfo(torch.bfloat16).eps
#: An fp32 MoE cell is held on the sharded step's own routes: at these cuts' init (the stacked layers' std,
#: repeats^-0.5) a rounding's change of the router's input can send a token to other experts than one card
#: does, which moves the later layers by far more than FP32_REL whether or not the combine is right.  So rank
#: 0 reruns the one-card fp32 step with the router's expert indices pinned to the sharded step's (gathered
#: over the ranks; the gate weights the one-card router's own probabilities at them), and the sharded step is
#: held against that pinned step within the bounds above (a train cell's nudged rerun, the floor of its bounds,
#: pinned to the same routes).  The comparison with the unpinned one-card step is reported beside it, with
#: every token the two route otherwise (router call, token, top-(k+1) margin).
ROUTE_DIFFERENCES_SHOWN = 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pipeline_toy(mesh, device):
    from repro_torch.train.pipeline import pipeline_forward, split_stages

    S, s = mesh.size(0), mesh.get_local_rank("stage")
    L, D, M, MB = 8, 16, 6, 4
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(L, D, D, generator=g) * D ** -0.5).to(device).requires_grad_()
    b = (torch.randn(L, D, generator=g) * 0.1).to(device).requires_grad_()
    xs = torch.randn(M, MB, D, generator=g).to(device)
    fn = lambda lp, x: torch.tanh(x @ lp["w"] + lp["b"])  # noqa: E731
    out = pipeline_forward(split_stages({"w": w, "b": b}, S), xs, fn, mesh, "stage")
    (out ** 2).sum().backward()
    gw, gb = w.grad.clone(), b.grad.clone()
    w.grad = b.grad = None
    x = xs
    for i in range(L):
        x = fn({"w": w[i], "b": b[i]}, x)
    (x ** 2).sum().backward()
    rows = slice(s * (L // S), (s + 1) * (L // S))
    gaps = {"output": (out - x).abs().max().item(), "grad_w": (gw[rows] - w.grad[rows]).abs().max().item(),
            "grad_b": (gb[rows] - b.grad[rows]).abs().max().item(),
            "grad_elsewhere": torch.cat([gw[:rows.start], gw[rows.stop:]]).abs().max().item() if S > 1 else 0.0}
    ok = max(gaps["output"], gaps["grad_w"], gaps["grad_b"]) <= TOY_TOL and gaps["grad_elsewhere"] == 0
    return {"stages": S, "stage": s, "microbatches": M, "max_abs_gaps": gaps, "tolerance": TOY_TOL, "ok": ok}


def _model(cfg, device):
    """A seeded model on this rank's device, rank 0's weights on every rank."""
    import torch.distributed as dist

    from repro_torch.models import Transformer

    model = Transformer(cfg, device=device, seed=0)
    with torch.no_grad():
        for p in model.parameters():
            dist.broadcast(p, src=0)
    return model


def _stacked(model):
    per = [dict(layer.named_parameters()) for layer in model.layers]
    out = {}
    for name in per[0]:
        *parents, last = name.split(".")
        cur = out
        for key in parents:
            cur = cur.setdefault(key, {})
        cur[last] = torch.stack([layer[name].detach() for layer in per])
    return out


def pipeline_full_width(model, mesh, device, seq):
    from torch.utils._pytree import tree_map

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import embed_apply
    from repro_torch.train.pipeline import pipeline_forward, split_stages

    cfg, S = model.cfg, mesh.size(0)
    stacked = _stacked(model)
    tokens = torch.randint(0, cfg.vocab_size, (MICRO, seq), generator=torch.Generator().manual_seed(11)).to(device)
    positions = torch.arange(seq, device=device)[None]
    layer_fn = lambda lp, x: model._layer(lp, x, positions)[0]  # noqa: E731
    with torch.no_grad():
        xs = embed_apply(model.embed, tokens, cfg)[:, None]
        layer_fn(tree_map(lambda t: t[0], stacked), xs[0])  # builds and warms the kernels before the timing
        _sync(device)
        before = fa.flash_attention.launches
        t0 = time.perf_counter()
        out = pipeline_forward(split_stages(stacked, S), xs, layer_fn, mesh, "stage")
        _sync(device)
        pipe_ms = (time.perf_counter() - t0) * 1e3
        launches = fa.flash_attention.launches - before
        t0 = time.perf_counter()
        want = []
        for x in xs:
            for i in range(cfg.n_layers):
                x = layer_fn(tree_map(lambda t: t[i], stacked), x)
            want.append(x)
        want = torch.stack(want)
        _sync(device)
        seq_ms = (time.perf_counter() - t0) * 1e3
    equal = torch.equal(out, want)
    want_launches = (MICRO + S - 1) * LAYERS_A_STAGE if device.type == "cuda" else 0
    return {"stages": S, "layers": cfg.n_layers, "microbatches": MICRO, "tokens_a_microbatch": seq,
            "dtype": str(out.dtype).replace("torch.", ""), "bit_equal_to_sequential": equal,
            "max_abs_gap": (out.float() - want.float()).abs().max().item(), "flash_launches": launches,
            "flash_launches_expected": want_launches, "pipeline_ms": pipe_ms, "sequential_ms": seq_ms,
            "ok": equal and bool(torch.isfinite(out).all()) and launches == want_launches}


def mesh_round_trip(model, world, device):
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.configs import SHAPES
    from repro_torch.launch.mesh import make_tiny_mesh, mesh_axis_sizes
    from repro_torch.launch.shardings import make_plan
    from repro_torch.models.params import iter_leaves

    mesh = make_tiny_mesh(data=2, model=world // 2, device_type=device.type)
    plan = make_plan(model.cfg, SHAPES["train_4k"], mesh)
    placements = {p.replace("/", "."): pl for p, pl in iter_leaves(plan.placements(plan.param_specs))}
    seconds = []
    for _ in range(2):  # the first pass also opens the subgroups' communicators; the second is the reading
        sharded, bad, local_bytes = 0, [], 0
        _sync(device)
        t0 = time.perf_counter()
        for name, p in model.named_parameters():
            d = distribute_tensor(p.detach(), mesh, placements[name])
            size, offset = compute_local_shape_and_global_offset(p.shape, mesh, d.placements)
            block = p.detach()[tuple(slice(o, o + n) for o, n in zip(offset, size))]
            local = d.to_local()
            sharded += any(isinstance(pl, Shard) for pl in d.placements)
            local_bytes += local.numel() * local.element_size()
            if not (local.shape == block.shape and torch.equal(local, block)
                    and torch.equal(d.full_tensor(), p.detach())):
                bad.append(name)
            del d, local
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    return {"shape": list(mesh.mesh.shape), "axes": list(mesh.mesh_dim_names), "sizes": mesh_axis_sizes(mesh),
            "coordinate": mesh.get_coordinate(), "params": len(placements), "sharded": sharded,
            "local_bytes": local_bytes, "total_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "round_trip_s": seconds, "mismatched": bad, "ok": not bad and sharded > 0}


def _rel_gap(got, want) -> float:
    """Largest absolute gap over the largest magnitude."""
    got, want = got.float(), want.float().to(got.device)
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def _l2_gap(got, want) -> float:
    got, want = got.float(), want.float().to(got.device)
    return (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp(min=1e-30)).item()


@torch.no_grad()
def _nudge(tree, gen):
    """Every leaf of ``tree`` times ``1 ± eps`` of its dtype, the sign drawn
    from ``gen`` (about one unit in the last place, a rounding's worth)."""
    for leaf in (tree.values() if isinstance(tree, dict) else ()):
        if isinstance(leaf, dict):
            _nudge(leaf, gen)
            continue
        up = torch.rand(leaf.shape, generator=gen, device=leaf.device) < 0.5
        eps = torch.finfo(leaf.dtype).eps
        leaf.copy_((leaf.float() * torch.where(up, 1 + eps, 1 - eps)).to(leaf.dtype))


def _gaps(got, want):
    """A step's gaps to ``want``: a train step's loss and grad norm
    relative and each leaf's first moment (the clipped gradient,
    ``m.<leaf>``) in relative L2; a serving step's logits and each cache
    leaf (``cache.<leaf>``) relative to their largest magnitude."""
    if "m" in want:
        gaps = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k])) for k in ("loss", "grad_norm")}
        gaps.update({f"m.{k}": _l2_gap(got["m"][k], want["m"][k]) for k in want["m"]})
        return gaps
    gaps = {"logits": _rel_gap(got["logits"], want["logits"])}
    gaps.update({f"cache.{k}": _rel_gap(got["cache"][k], want["cache"][k]) for k in want["cache"]})
    return gaps


@contextlib.contextmanager
def _routes(calls):
    """The port's ``moe.router_topk`` traced while open: each call's expert
    indices and the smallest gap of its top-(k+1) probabilities (a second
    call of the router, as chip_smoke.py's ``moe_parity`` takes it), kept on
    the device and appended to ``calls``."""
    from repro_torch.models import moe

    real = moe.router_topk

    def traced(params, x, cfg_moe, **kw):
        w, idx, aux = real(params, x, cfg_moe, **kw)
        more = dataclasses.replace(cfg_moe, top_k=min(cfg_moe.top_k + 1, cfg_moe.n_experts), router_scale=False)
        top = real(params, x, more, **kw)[0].detach().float()
        calls.append((idx.detach().clone(), (top[..., :-1] - top[..., 1:]).min(-1).values))
        return w, idx, aux

    moe.router_topk = traced
    try:
        yield
    finally:
        moe.router_topk = real


@contextlib.contextmanager
def _pinned(calls):
    """The port's ``moe.router_topk`` while open choosing, at its n-th call,
    the expert indices of ``calls[n]`` (the sharded step's, gathered): the
    router's own code with its ``torch.topk`` swapped, for that call, for
    the router's probabilities at those indices, so the gate weights and the
    aux loss are ``router_topk``'s on the pinned routes."""
    from repro_torch.models import moe

    real, count = moe.router_topk, iter(range(len(calls)))

    def pinned(params, x, cfg_moe, **kw):
        idx, topk = calls[next(count)][0].to(x.device), torch.topk
        torch.topk = lambda probs, k, dim=-1: (probs.gather(dim, idx), idx)
        try:
            return real(params, x, cfg_moe, **kw)
        finally:
            torch.topk = topk

    moe.router_topk = pinned
    try:
        yield
    finally:
        moe.router_topk = real


def _route_differences(one, got):
    """Every token another run routes to other experts than the one-card
    step (its router call, its index in the call's rows and its largest
    top-(k+1) margin over both runs), the first ``ROUTE_DIFFERENCES_SHOWN``
    of them in call order, their count, and both runs' router calls."""
    shown, count = [], 0
    for n, ((oi, og), (gi, gg)) in enumerate(zip(one, got)):
        differ = (oi != gi).reshape(-1, oi.shape[-1]).any(-1)
        margins = torch.maximum(og, gg).reshape(-1)
        for t in torch.nonzero(differ).flatten().tolist():
            count += 1
            if len(shown) < ROUTE_DIFFERENCES_SHOWN:
                shown.append({"call": n, "token": t, "margin": float(margins[t])})
    return {"calls": [len(one), len(got)], "count": count, "shown": shown}


def _first_miss(got, want, bounds):
    """Where a serving step first misses its bound: the output (``logits``,
    or the cache leaf whose first missing layer comes first, in the cache's
    key order) and that layer, with its gap to the scale of the whole
    leaf."""
    if bounds.get("logits", 1) < _rel_gap(got["logits"], want["logits"]):
        first = {"leaf": "logits", "layer": None, "gap": _rel_gap(got["logits"], want["logits"])}
    else:
        first = None
    for k in want.get("cache", {}):
        g, w = got["cache"][k].float(), want["cache"][k].float()
        by_layer = (g - w).abs().reshape(w.shape[0], -1).amax(-1) / w.abs().max().clamp(min=1e-30)
        over = torch.nonzero(by_layer > bounds[f"cache.{k}"]).flatten().tolist()
        if over and (first is None or first["layer"] is None or over[0] < first["layer"]):
            first = {"leaf": f"cache.{k}", "layer": over[0], "gap": float(by_layer[over[0]])}
    return first


def _gathered_routes(calls, mesh):
    """This rank's router calls (its rows of the batch) gathered from every
    rank, each call's rows in the batch's order (the ranks of ``model``
    coordinate 0, by their ``data`` coordinate), on the host."""
    import torch.distributed as dist

    mine = [(i.cpu(), g.cpu()) for i, g in calls]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.get_local_rank("data"), mesh.get_local_rank("model"), mine))
    blocks = [c for _, _, c in sorted((d, m, c) for d, m, c in every if m == 0)]
    return [(torch.cat([b[n][0] for b in blocks]), torch.cat([b[n][1] for b in blocks])) for n in range(len(mine))]


def _vocab_only(out, vocab):
    """A serving step's kept outputs with its logits cut to the vocabulary
    and the padded columns (``>= vocab``, at ``-1e9``) apart as
    ``"padded"``: a gap relative to the largest magnitude would otherwise be
    one relative to 1e9."""
    if "logits" not in out:
        return out
    return {**out, "logits": out["logits"][..., :vocab], "padded": out["logits"][..., vocab:]}


def _timed(fn, device, keep, trace=contextlib.nullcontext):
    """``keep`` of the first call's output on the host (taken before the warm
    calls, which update a train step's parameters and moments in place) and
    its ms, then the median ms of two warm calls.  ``trace()`` is open
    around the first call only."""
    _sync(device)
    t0 = time.perf_counter()
    with trace():
        out = fn()
    _sync(device)
    first = (time.perf_counter() - t0) * 1e3
    out = _host(keep(out))
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        warm.append((time.perf_counter() - t0) * 1e3)
    return out, first, sorted(warm)[0] / 2 + sorted(warm)[1] / 2


def _host(tree):
    """The outputs worth comparing, copied to the host: logits and cache, or
    the metrics and first moments."""
    from repro_torch.launch.steps import full_tensor

    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v) for v in tree)
    return full_tensor(tree).detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree


def sharded_steps(args, device):
    """The steps part (see the module docstring)."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
    from repro_torch.launch.mesh import make_tiny_mesh
    from repro_torch.launch.shardings import PlanOverrides
    from repro_torch.launch.steps import build_cell, materialize, place

    mesh = make_tiny_mesh(data=2, model=args.world // 2, device_type=device.type)
    seq = SMALL_SEQ if args.small else SEQ
    rows, ok = {}, True
    fp32_out = None  # rank 0's one-card fp32 output of the cell, the bf16 run's reference
    cells = [c for c in SHARDED_CELLS if not args.arch or c[0] in args.arch]
    for (arch, name, _, batch, kind, layers, four), dtype in ((c, d) for c in cells for d in STEP_DTYPES):
        cfg = get_smoke_config(arch) if args.small else get_config(arch)
        layers = four if four is not None else layers  # the depth at which rank 0's one-card fp32 step fits
        if layers is not None and not args.small:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        fp32 = dtype == "float32"
        if fp32:
            cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        over = PlanOverrides(microbatches=SHARDED_MICRO) if kind == "train" else PlanOverrides()
        cell = build_cell(arch, cfg, ShapeConfig(name, seq, batch, kind), mesh, overrides=over)
        keep = (lambda o: {"loss": o[2]["loss"], "grad_norm": o[2]["grad_norm"], "m": o[1]["m"]}) \
            if kind == "train" else (lambda o: {"logits": o[0], "cache": o[1]})
        vocab = cfg.vocab_size  # the logits' gaps over the vocabulary; the padded columns must hold -1e9
        one, routed = {}, fp32 and any(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        nudged = fp32 and kind == "train"
        one_routes, routes = [], []
        if args.rank == 0:  # the one-card step, alone
            plain = materialize(cell, device.type, SHARDED_SEED)
            out, first, warm = _timed(lambda: cell.fn(*plain), device, keep,
                                      (lambda: _routes(one_routes)) if routed else contextlib.nullcontext)
            one = {"out": out, "first_call_ms": first, "step_ms": warm}
            del out, plain
            if device.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
        placed = place(cell, materialize(cell, device.type, SHARDED_SEED))
        zero_launches()
        got, first, warm = _timed(lambda: cell.fn(*placed), device, keep,
                                  (lambda: _routes(routes)) if routed else contextlib.nullcontext)
        launches = {k: n // 3 for k, n in kernel_launches().items()}  # three calls, one a main-path call
        del placed
        if routed:
            routes = _gathered_routes(routes, mesh)
        if routed and args.rank == 0:  # the one-card step again, on the sharded step's routes
            inputs = materialize(cell, device.type, SHARDED_SEED)
            with _pinned(routes):
                one["pinned"] = _host(keep(cell.fn(*inputs)))
            del inputs
        if nudged and args.rank == 0:
            # the one-card step with every weight moved by about one unit in its last place (an MoE cell's on the
            # sharded step's routes too, so that its gaps are rounding's on the routes the sharded step is held on)
            inputs = materialize(cell, device.type, SHARDED_SEED)
            _nudge(inputs[0], torch.Generator(device=device).manual_seed(SHARDED_SEED + 2))
            with _pinned(routes) if routed else contextlib.nullcontext():
                one["nudged"] = _vocab_only(_host(keep(cell.fn(*inputs))), vocab)
            del inputs
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        row = {"step": cell.step_name, "rows": batch, "seq": seq, "n_layers": cfg.n_layers,
               "sharded_first_call_ms": first, "sharded_step_ms": warm, "launches": launches}
        if args.rank == 0:
            got, want = _vocab_only(got, vocab), _vocab_only(one["out"], vocab)
            if routed:  # held on the sharded step's routes; the unpinned one-card step's gaps reported
                unpinned = want
                want = _vocab_only(one["pinned"], vocab)
                row["unpinned_gaps"] = {k: v for k, v in _gaps(got, unpinned).items() if not k.startswith("m.")}
            gaps = _gaps(got, want)
            if fp32:
                # each gap within its bound, or twice the nudged one-card step's gap where that is larger
                floor = _gaps(one["nudged"], want) if nudged else {k: 0.0 for k in gaps}
                bounds = {k: max(FP32_GRAD_L2 if k.startswith("m.") else FP32_REL, 2 * floor[k]) for k in gaps}
                held_gaps = gaps
                fp32_out = unpinned if routed else want
            else:
                # the sharded bf16 step's gap to the one-card fp32 step, within BF16_FLOOR_TIMES the one-card bf16
                # step's gap to it, plus BF16_SLACK
                floor = _gaps(want, fp32_out)
                held_gaps = _gaps(got, fp32_out)
                bounds = {k: BF16_FLOOR_TIMES * floor[k] + BF16_SLACK for k in gaps}
                row["gaps_to_fp32"] = {k: v for k, v in held_gaps.items() if not k.startswith("m.")}
                fp32_out = None
            over = {k: held_gaps[k] / bounds[k] for k in gaps}
            worst = max(gaps, key=lambda k: (over[k], held_gaps[k]))
            row.update(gaps={k: v for k, v in gaps.items() if not k.startswith("m.")},
                       floors={k: v for k, v in floor.items() if not k.startswith("m.")},
                       worst=worst, worst_gap=held_gaps[worst], worst_floor=floor[worst], worst_bound=bounds[worst])
            if kind == "train":
                row["max_first_moment_gap"] = max(v for k, v in gaps.items() if k.startswith("m."))
            probe = got["loss"] if kind == "train" else got["logits"]
            held = all(v <= 1 for v in over.values())
            if fp32 and not held and kind != "train":
                row["first_miss"] = _first_miss(got, want, bounds)
            if routed:  # where the sharded step routes a token otherwise than the one-card step (reported)
                one_routes = [(i.cpu(), g.cpu()) for i, g in one_routes]
                row.update(held_on="the sharded step's routes", route_differences=_route_differences(one_routes, routes))
            if "padded" in got:
                row["padded_columns_masked"] = bool((got["padded"] == -1e9).all() and (want["padded"] == -1e9).all())
                held = held and row["padded_columns_masked"]
            row.update(one_card_first_call_ms=one["first_call_ms"], one_card_step_ms=one["step_ms"],
                       held=held, ok=bool(torch.isfinite(probe).all()))
            row["ok"] = row["ok"] and row["held"]
            ok = ok and row["ok"]
        if device.type == "cuda":
            ok = ok and all(launches[k] > 0 for k in expected_kernels(cfg, kind))
        key = f"{arch} {name} {dtype}" + (f" ({cfg.n_layers} layers)" if layers and not args.small else "")
        rows[key] = row
        print(f"rank {args.rank}: {key} {json.dumps(row)}", file=sys.stderr, flush=True)  # kept if a later cell hangs
    return {"mesh": list(mesh.mesh.shape), "axes": list(mesh.mesh_dim_names), "cells": rows, "ok": ok}


def rank_main(args) -> int:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, get_smoke_config

    if args.device == "cuda":
        torch.cuda.set_device(args.rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device, args.rank) if args.device == "cuda" else torch.device("cpu")
    backend = "nccl" if args.device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{args.port}", rank=args.rank,
                            world_size=args.world)
    try:
        stage_mesh = init_device_mesh(args.device, (args.world,), mesh_dim_names=("stage",))
        base = get_smoke_config("deepseek-7b") if args.small else get_config("deepseek-7b")
        cfg = dataclasses.replace(base, n_layers=LAYERS_A_STAGE * args.world)
        out = {"rank": args.rank, "backend": backend, "device": str(device), "config": cfg.name,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model}
        if "pipeline" in args.parts:
            out["pipeline_toy"] = pipeline_toy(stage_mesh, device)
        if {"pipeline", "mesh"} & set(args.parts):
            model = _model(cfg, device)
            if "pipeline" in args.parts:
                out["pipeline_full_width"] = pipeline_full_width(model, stage_mesh, device,
                                                                 SMALL_SEQ if args.small else SEQ)
            if "mesh" in args.parts:
                out["mesh"] = mesh_round_trip(model, args.world, device)
            del model
        if "steps" in args.parts:
            if device.type == "cuda":
                torch.cuda.empty_cache()
            out["steps"] = sharded_steps(args, device)
        out["ok"] = all(out[k]["ok"] for k in ("pipeline_toy", "pipeline_full_width", "mesh", "steps") if k in out)
        print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=None, help="ranks (default: the cards, at most 4)")
    ap.add_argument("--small", action="store_true", help="the smoke config's widths and 32-token rows")
    ap.add_argument("parts", nargs="*", choices=PARTS, default=list(PARTS), help="parts to run (default: all)")
    ap.add_argument("--arch", action="append", default=[],
                    help="the steps part's cells of this config only (repeatable; default: every cell)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    if args.device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < 2:
            print(f"multi_card_dist: {cards} CUDA device(s); this needs two or more", file=sys.stderr)
            return 1
        args.world = args.world or min(cards, 4)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    else:
        args.world, smi = args.world or 4, ["host CPU (gloo)"]
    if args.world < 2 or args.world % 2:
        print("multi_card_dist: the mesh is (2, world / 2): give an even world of 2 or more", file=sys.stderr)
        return 1
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--device", args.device, "--world", str(args.world),
           "--port", str(port)] + (["--small"] if args.small else []) + [f"--arch={a}" for a in args.arch] + \
        list(args.parts)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(args.world)]
    lines, ok = [], True
    try:
        for r, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(timeout=max(1.0, TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                print(f"multi_card_dist: rank {r} did not finish in {TIMEOUT_S} s", file=sys.stderr)
                ok = False
                break
            if p.returncode != 0:
                ok = False
                print(f"multi_card_dist: rank {r} exited {p.returncode}:\n{stderr[-3000:]}", file=sys.stderr)
            lines += [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                print(f"multi_card_dist: rank {r} killed; its last stderr:\n{p.communicate()[1][-6000:]}",
                      file=sys.stderr)
    for line in lines:
        print(json.dumps(line), flush=True)
    ok = ok and len(lines) == args.world and all(x["ok"] for x in lines)
    print("\n".join(smi), flush=True)
    print(json.dumps({"ok": ok, "world": args.world, "device": args.device, "wall_s": time.perf_counter() - t0}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
