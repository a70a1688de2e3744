#!/usr/bin/env python3
"""The port's distribution across cards: the GPipe pipeline and a sharded mesh on several ranks.

Run from the root of a checkout on a machine with two or more NVIDIA GPUs:

    python3 scripts/multi_card_dist.py                    # one rank a card (at most 4), NCCL
    python3 scripts/multi_card_dist.py --device cpu --world 4 --small   # the same on the host, gloo

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
  communicators).

One JSON line a rank and a last line with ``"ok"``, beside the card's name
and power limit.  Exits non-zero when a check fails, a rank fails or hangs,
or (on ``cuda``) there are fewer than two cards.
"""

from __future__ import annotations

import argparse
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

import torch  # noqa: E402

TIMEOUT_S = 600
TOY_TOL = 2e-5
#: the full-width pipeline: layers a stage, microbatches, tokens a microbatch (--small: the smoke config's)
LAYERS_A_STAGE, MICRO, SEQ, SMALL_SEQ = 2, 4, 2048, 32


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
               "n_layers": cfg.n_layers, "d_model": cfg.d_model, "pipeline_toy": pipeline_toy(stage_mesh, device)}
        model = _model(cfg, device)
        out["pipeline_full_width"] = pipeline_full_width(model, stage_mesh, device, SMALL_SEQ if args.small else SEQ)
        out["mesh"] = mesh_round_trip(model, args.world, device)
        out["ok"] = all(out[k]["ok"] for k in ("pipeline_toy", "pipeline_full_width", "mesh"))
        print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=None, help="ranks (default: the cards, at most 4)")
    ap.add_argument("--small", action="store_true", help="the smoke config's widths and 32-token rows")
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
           "--port", str(port)] + (["--small"] if args.small else [])
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
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for line in lines:
        print(json.dumps(line), flush=True)
    ok = ok and len(lines) == args.world and all(x["ok"] for x in lines)
    print("\n".join(smi), flush=True)
    print(json.dumps({"ok": ok, "world": args.world, "device": args.device, "wall_s": time.perf_counter() - t0}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
