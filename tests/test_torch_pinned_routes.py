"""``scripts/multi_card_dist.py``'s fp32 MoE control, held on pinned routes, meeting a route difference on the CPU.

The script holds a sharded fp32 MoE step against rank 0's one-card step
rerun with the router's expert indices pinned to the sharded step's own
(``_pinned``), since a rounding can send a token to other experts on the
mesh than on one card.  Here the sharded side is made to route otherwise
for certain: on a gloo world of four ranks, (data 2, model 2),
deepseek-v2-lite's smoke config (8 experts, top-2) runs its prefill and
its train cell (4 × 32 tokens, 2 microbatches) with every router call
choosing, for the first token of the rank's rows, its third expert in
place of its second (the gate weights the router's own probabilities at
the chosen experts, as a flip from rounding gives them).  The script's own
functions then trace the routes (``_routes``), gather them
(``_gathered_routes``), rerun the one-card step on them (``_pinned``,
the train cell's nudged rerun too) and count the differences
(``_route_differences``).  The check must tell the two comparisons apart:
held on the pinned routes the sharded step lies within the script's
bounds (``FP32_REL``, ``FP32_GRAD_L2``, or twice the pinned nudged step's
gap); against the unpinned one-card step it misses ``FP32_REL``, and
``_first_miss`` names the leaf.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import multi_card_dist as mcd  # noqa: E402

TIMEOUT_S = 240
WORLD = 4
ARCH = "deepseek-v2-lite-16b"
KINDS = ("prefill", "train")

RANK = """
import contextlib, dataclasses, json, sys
import torch
import torch.distributed as dist

import multi_card_dist as mcd
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.launch.mesh import make_tiny_mesh
from repro_torch.launch.shardings import PlanOverrides
from repro_torch.launch.steps import build_cell, materialize, place
from repro_torch.models import moe

rank, world, store, arch = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
mesh = make_tiny_mesh(data=2, model=world // 2, device_type="cpu")
cfg = get_smoke_config(arch)
assert cfg.param_dtype == cfg.compute_dtype == "float32"


@contextlib.contextmanager
def flipped():
    # every router call on this rank: its first row's k-th expert swapped for its (k+1)-th
    real = moe.router_topk

    def route(params, x, cfg_moe, **kw):
        more = dataclasses.replace(cfg_moe, top_k=cfg_moe.top_k + 1, router_scale=False)
        top = real(params, x, more, **kw)[1]
        idx = top[..., :-1].clone()
        idx[0, -1] = top[0, -1]
        topk = torch.topk
        torch.topk = lambda probs, k, dim=-1: (probs.gather(dim, idx), idx)
        try:
            return real(params, x, cfg_moe, **kw)
        finally:
            torch.topk = topk

    moe.router_topk = route
    try:
        yield
    finally:
        moe.router_topk = real


out = {}
for kind in ("prefill", "train"):
    over = PlanOverrides(microbatches=2) if kind == "train" else PlanOverrides()
    cell = build_cell(arch, cfg, ShapeConfig(kind, 32, 4, kind), mesh, overrides=over)
    keep = (lambda o: {"loss": o[2]["loss"], "grad_norm": o[2]["grad_norm"], "m": o[1]["m"]}) \\
        if kind == "train" else (lambda o: {"logits": o[0], "cache": o[1]})
    placed, routes = place(cell, materialize(cell, "cpu", mcd.SHARDED_SEED)), []
    with flipped(), mcd._routes(routes):
        got = mcd._host(keep(cell.fn(*placed)))
    routes = mcd._gathered_routes(routes, mesh)
    if rank == 0:
        one_routes = []
        with mcd._routes(one_routes):
            one = mcd._host(keep(cell.fn(*materialize(cell, "cpu", mcd.SHARDED_SEED))))
        with mcd._pinned(routes):
            pinned = mcd._host(keep(cell.fn(*materialize(cell, "cpu", mcd.SHARDED_SEED))))
        v = cfg.vocab_size
        got, one, pinned = (mcd._vocab_only(t, v) for t in (got, one, pinned))
        row = {"pinned": mcd._gaps(got, pinned), "unpinned": mcd._gaps(got, one),
               "differences": mcd._route_differences(one_routes, routes), "first_call_tokens": len(routes[0][0])}
        if kind == "train":
            inputs = materialize(cell, "cpu", mcd.SHARDED_SEED)
            mcd._nudge(inputs[0], torch.Generator().manual_seed(mcd.SHARDED_SEED + 2))
            with mcd._pinned(routes):
                row["floor"] = mcd._gaps(mcd._vocab_only(mcd._host(keep(cell.fn(*inputs))), v), pinned)
        else:
            row["first_miss"] = mcd._first_miss(got, one, {k: mcd.FP32_REL for k in row["unpinned"]})
        out[kind] = row
    dist.barrier()
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    work = tmp_path_factory.mktemp("pinned_routes")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "scripts"), str(ROOT)]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(WORLD), str(work / "store"), ARCH],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-4000:]
    return json.loads(results[0][0].strip().splitlines()[-1])


def _bound(leaf: str) -> float:
    return mcd.FP32_GRAD_L2 if leaf.startswith("m.") else mcd.FP32_REL


@pytest.mark.parametrize("kind", KINDS)
def test_the_sharded_step_routes_otherwise(control, kind):
    diff, tokens = control[kind]["differences"], control[kind]["first_call_tokens"]
    assert diff["calls"][0] == diff["calls"][1] > 0
    # the first router call's flipped tokens (the first of each data block's rows), and what the flips moved
    # in later calls
    assert {(0, 0), (0, tokens // 2)} <= {(d["call"], d["token"]) for d in diff["shown"]}, diff
    assert diff["count"] >= 2 * diff["calls"][0], diff


@pytest.mark.parametrize("kind", KINDS)
def test_held_on_pinned_routes_the_control_holds(control, kind):
    row = control[kind]
    floor = row.get("floor", {})
    over = {k: g for k, g in row["pinned"].items() if g > max(_bound(k), 2 * floor.get(k, 0.0))}
    assert not over, over


@pytest.mark.parametrize("kind", KINDS)
def test_against_the_unpinned_step_the_control_misses(control, kind):
    row = control[kind]
    over = {k: g for k, g in row["unpinned"].items() if g > mcd.FP32_REL}
    assert over, row["unpinned"]
    if kind == "prefill":
        assert row["first_miss"] is not None and row["first_miss"]["gap"] > mcd.FP32_REL
