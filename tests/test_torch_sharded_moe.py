"""``build_cell``'s MoE and MLA steps run on a device mesh against the reference's steps, on the CPU.

Built as ``tests/test_torch_sharded_steps.py`` is: the port's ranks are gloo
processes (one subprocess each, a ``FileStore`` rendezvous under
``tmp_path``, killed after ``TIMEOUT_S``), on the same weights as the
reference (the reference's init at ``WEIGHTS_KEY``, the weights
``tests/test_torch_moe.py`` holds these configs to the same tolerances
on).  One world of four ranks runs every sharded case in turn, one lone
rank the one-rank checks, and a second world of four the float64
witness:

* deepseek-v2-lite-16b's smoke config at its own 3 layers (a dense first
  layer, then 2 MoE layers of 8 experts top-2 beside a shared one; MLA) and
  llama4-scout-17b-a16e's (3 MoE layers of 4 experts top-1 beside a shared
  one; 4 query heads on 2 kv heads), each on a (data 2, model 2) and a
  (data 1, model 4) mesh.  On (1, 4) llama4 holds one expert a rank and its
  2 kv heads do not divide ``model``, so its decode cache is split over
  its sequence; deepseek-v2-lite holds 2 experts and 1 MLA head a rank and
  10 of its cache's 40 latent rows.  Each case runs the prefill cell (4 ×
  32 tokens), two greedy decode steps of the serve cell from the
  reference's prefill cache (a 40-row cache) and one step of the train
  cell (4 × 32 tokens in 2 microbatches), its inputs DTensors at
  ``cell.in_shardings``.
* The checks that can fail, each a test of its own: every expert product
  (``torch.bmm``, recorded on every rank) runs on ``E / model`` experts;
  a control whose combine keeps only its own experts' outputs (the sum
  over ``model`` dropped), one whose MLA decode takes no cross-rank
  maximum and sums, and one whose aux statistics are the local tokens'
  miss their tolerances.
* llama4-scout's vocabulary pads: with the head's product ``Partial``
  over "data" on (2, 2), the padded columns are masked once (a vocabulary
  of 500 padded to 512 against the plain step).
* On a (1, 1) mesh every step of both configs is the plain-tensor step
  bit for bit (outputs, cache, updated parameters and moments).
* The float64 witness: deepseek-v2-lite's prefill on (1, 4) and (2, 2)
  in a copy of the port that computes in float64 throughout equals the
  plain float64 step to ``FLOAT64_REL`` (1e-10) of the scale, on these
  weights and on the port's own init at seed 3.

The tolerances are the ones the repo holds these configs to: logits within
``LOGITS_ATOL`` 5e-4 (``tests/test_torch_moe.py``), the aux loss within
rtol 1e-6, each cache leaf within 5e-5 of its largest magnitude, greedy
tokens equal; the train step as ``tests/test_torch_train.py`` holds step
1 (loss rtol 1e-6, grad norm rtol 1e-3, each leaf's gradient within 2e-3
and its change within 1e-1 in relative L2), with step 1's expert choices
equal to the reference's save where the top-(k+1) router probabilities tie
within ``TIE_EPS`` (1e-5) on both sides.  The cache tolerance sits near
these configs' fp32 rounding: the reference's init draws the stacked
layers' weights at std ``repeats^-0.5`` (gains of ~6-8 a projection at
these widths), so two fp32 runs of one function (the reference's and the
port's, or two meshes') can differ on deepseek-v2-lite's third layer's
latent cache by about the 5e-5 it is held to.  On the port's init at seed 3 the (1, 4) step lands 5.4e-5 from the
reference; the float64 witness shows that it computes the plain function
there too, and on this file's weights every case is inside 5e-5.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.models import moe as ref_moe
from repro.models import prefill as ref_prefill
from repro.optim import ScheduleConfig as RefScheduleConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.serve.cache_utils import transplant as ref_transplant
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.models.convert import flatten_jax_tree

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
WORLD = 4
ARCHS = ("deepseek-v2-lite-16b", "llama4-scout-17b-a16e")
#: (config, (data, model)): the sharded cases
CASES = [(a, m) for a in ARCHS for m in ((2, 2), (1, 4))]
CASE_IDS = [f"{a}-{d}x{m}" for a, (d, m) in CASES]
B, S, MAX_LEN, DECODE_STEPS = 4, 32, 40, 2
LOGITS_ATOL = 5e-4  # tests/test_torch_moe.py's
AUX_RTOL = 1e-6
CACHE_REL = 5e-5  # of each cache leaf's largest magnitude
STEP1_TOL = dict(loss=1e-6, grad_norm=1e-3, grad=2e-3, change=1e-1)  # tests/test_torch_train.py's
TIE_EPS = 1e-5  # tests/test_torch_train.py's
WEIGHTS_KEY = 7  # tests/test_torch_moe.py's whole-model weights
#: the float64 witness: the config, and a sharded step's largest gap to the plain step, of each output's scale
WITNESS_ARCH, FLOAT64_REL = "deepseek-v2-lite-16b", 1e-10
WITNESS_MESHES = ((1, 4), (2, 2))
SCHEDULE = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
#: the controls: (what is dropped, config, mesh)
CONTROLS = [("combine", "deepseek-v2-lite-16b", (2, 2)), ("combine", "llama4-scout-17b-a16e", (1, 4)),
            ("mla_decode", "deepseek-v2-lite-16b", (1, 4)), ("aux", "deepseek-v2-lite-16b", (2, 2)),
            ("aux", "llama4-scout-17b-a16e", (2, 2))]
CONTROL_IDS = [f"{w}-{a}-{d}x{m}" for w, a, (d, m) in CONTROLS]

PORT = """
import contextlib, dataclasses, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.shardings import PlanOverrides
from repro_torch.launch.steps import build_cell, full_tensor, materialize, place
from repro_torch.models import attention as port_attention
from repro_torch.models import moe as port_moe
from repro_torch.optim import ScheduleConfig, adamw_init
from repro_torch.train import TrainConfig

rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg_in = json.loads(open(work + "/setup.json").read())
B, S, MAX_LEN, STEPS = cfg_in["B"], cfg_in["S"], cfg_in["MAX_LEN"], cfg_in["DECODE_STEPS"]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)


def nest(flat):
    tree = {}
    for name, arr in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = torch.from_numpy(np.array(arr))
    return tree


def flat(tree, prefix=""):
    out = {}
    for key, sub in tree.items():
        out.update(flat(sub, prefix + key + ".") if isinstance(sub, dict) else {prefix + key: sub})
    return out


def cells(arch, mesh):
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(schedule=ScheduleConfig(**cfg_in["schedule"]), microbatches=2)
    return cfg, (build_cell(arch, cfg, ShapeConfig("prefill", S, B, "prefill"), mesh),
                 build_cell(arch, cfg, ShapeConfig("decode", MAX_LEN, B, "decode"), mesh),
                 build_cell(arch, cfg, ShapeConfig("train", S, B, "train"), mesh,
                            overrides=PlanOverrides(microbatches=2), tcfg=tcfg))


class ExpertProducts(TorchFunctionMode):
    # the experts each torch.bmm runs on (its first operand's leading dim: a DTensor's global one)
    def __init__(self):
        super().__init__()
        self.experts = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.bmm:
            self.experts.append(int(args[0].shape[0]))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def routes(record):
    # the port's router_topk traced: each call's expert indices and the smallest gap of its top-(k+1)
    # probabilities, for this rank's rows
    real = port_moe.router_topk

    def traced(params, x, moe, **kw):
        w, idx, aux = real(params, x, moe, **kw)
        more = dataclasses.replace(moe, top_k=min(moe.top_k + 1, moe.n_experts), router_scale=False)
        top = real(params, x, more, **kw)[0].detach().float()
        record.append((idx.numpy(), (top[..., :-1] - top[..., 1:]).min(-1).values.numpy()))
        return w, idx, aux

    port_moe.router_topk = traced
    try:
        yield
    finally:
        port_moe.router_topk = real


def batch_rank(mesh):
    # this rank's block of the batch: its coordinate on "data" (the batch's only axis here)
    return mesh.get_local_rank("data")


def prefill(arch, mesh, out):
    cfg, (pre, _, _) = cells(arch, mesh)
    z = dict(np.load(f"{work}/{arch}.npz"))
    weights = {k[2:]: v for k, v in z.items() if k.startswith("w.")}
    toks = torch.from_numpy(z["tokens"]).long()
    mode = ExpertProducts()
    with mode:
        logits, cache = full_tensor(pre.fn(*place(pre, (nest(weights), {"tokens": toks.clone()}))))
    out["prefill_logits"] = logits.numpy()
    out.update({"prefill_cache." + k: v.numpy() for k, v in cache.items()})
    return mode.experts


def train(arch, mesh, out, record=None):
    cfg, (_, _, tr) = cells(arch, mesh)
    z = dict(np.load(f"{work}/{arch}.npz"))
    weights = {k[2:]: v for k, v in z.items() if k.startswith("w.")}
    params = nest(weights)
    opt = adamw_init(flat(params))
    batch = {"tokens": torch.from_numpy(z["tokens"]).long(), "labels": torch.from_numpy(z["labels"]).long()}
    with routes(record) if record is not None else contextlib.nullcontext():
        new_params, opt, metrics = full_tensor(tr.fn(*place(tr, (params, opt, batch))))
    out.update({"train." + k: np.asarray(float(v)) for k, v in metrics.items()})
    out.update({"params." + k: v.detach().numpy() for k, v in flat(new_params).items()})
    out.update({"m." + k: v.numpy() for k, v in opt["m"].items()})
    out.update({"v." + k: v.numpy() for k, v in opt["v"].items()})


def decode(arch, mesh, out):
    cfg, (_, dec, _) = cells(arch, mesh)
    z = dict(np.load(f"{work}/{arch}.npz"))
    weights = {k[2:]: v for k, v in z.items() if k.startswith("w.")}
    toks = torch.from_numpy(z["tokens"]).long()
    # decode from the reference's prefill cache and first token, which the test writes while the ranks run
    while not os.path.exists(f"{work}/{arch}.decode.npz"):
        time.sleep(0.05)
    z = dict(np.load(f"{work}/{arch}.decode.npz"))
    big = {k: torch.from_numpy(z["cache." + k]) for k in dec.args[1]}
    params, big = place(dec, (nest(weights), big, toks[:, 0].clone(), toks[:, 0].clone()))[:2]
    tok, pos = torch.from_numpy(z["first"]).long(), torch.full((B,), S, dtype=torch.long)
    for i in range(STEPS):
        step_logits, big = dec.fn(*place(dec, (params, big, tok.clone(), pos.clone())))
        step_logits = full_tensor(step_logits)
        out[f"decode_logits.{i}"], out[f"decode_tokens.{i}"] = step_logits.numpy(), tok.numpy()
        tok, pos = step_logits.argmax(-1), pos + 1
    out.update({"decode_cache." + k: v.numpy() for k, v in full_tensor(big).items()})


@contextlib.contextmanager
def dropped(what):
    # the controls: the combine keeps only this rank's experts' outputs (the sum over "model" dropped); the
    # MLA decode's cross-rank maximum and sums dropped; the aux statistics taken from the local tokens only
    if what == "combine":
        name, module = "_all_experts", port_moe

        def fake(y, mesh, placements, shape):
            whole = real(y, mesh, placements, shape)
            first = sum(mesh.get_local_rank(i) for i, p in enumerate(placements)
                        if getattr(p, "dim", None) == 0) * y.shape[0]
            keep = torch.zeros_like(whole)
            keep[first:first + y.shape[0]] = 1
            return whole * keep
    elif what == "mla_decode":
        name, module, fake = "all_reduce_over", port_attention, lambda t, mesh, axes, op=None: t
    else:
        name, module, fake = "sum_over", port_moe, lambda t, mesh, axes: t
    real = getattr(module, name)
    setattr(module, name, fake)
    try:
        yield
    finally:
        setattr(module, name, real)


def padded_vocab(out):
    # llama4-scout's smoke with a vocabulary that pads (500 to 512), its prefill cell on (2, 2): the head's
    # d_model is split over "data" there, so its logits come out Partial before the padded columns are masked
    mesh = port_mesh.make_tiny_mesh(data=2, model=2, device_type="cpu")
    cfg = dataclasses.replace(get_smoke_config("llama4-scout-17b-a16e"), vocab_size=500)
    cell = build_cell(cfg.name, cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
    out["padded_vocab.want"] = cell.fn(*materialize(cell, "cpu", 0))[0].numpy()
    out["padded_vocab.got"] = full_tensor(cell.fn(*place(cell, materialize(cell, "cpu", 0)))[0]).numpy()


def sharded(out):
    padded_vocab(out)
    for arch, (data, model) in cfg_in["cases"]:
        mesh = port_mesh.make_tiny_mesh(data=data, model=model, device_type="cpu")
        case, calls = {}, []
        experts = prefill(arch, mesh, case)
        train(arch, mesh, case, calls)
        decode(arch, mesh, case)
        tag = f"{arch}/{data}x{model}/"
        out.update({tag + k: v for k, v in case.items()})
        # every rank's expert products, and its routes beside its block of the batch
        gathered = [None] * world
        dist.all_gather_object(gathered, (batch_rank(mesh), mesh.get_local_rank("model"), experts, calls))
        out[tag + "experts"] = np.asarray([e for g in gathered for e in g[2]])
        out[tag + "experts_per_rank"] = np.asarray([len(g[2]) for g in gathered])
        blocks = sorted((g[0], g[3]) for g in gathered if g[1] == 0)
        for n in range(len(calls)):
            out[tag + f"routes.{n}"] = np.concatenate([b[1][n][0] for b in blocks])
            out[tag + f"margins.{n}"] = np.concatenate([b[1][n][1] for b in blocks])
    for what, arch, (data, model) in cfg_in["controls"]:
        mesh = port_mesh.make_tiny_mesh(data=data, model=model, device_type="cpu")
        case = {}
        with dropped(what):
            if what == "combine":
                prefill(arch, mesh, case)
            elif what == "mla_decode":
                decode(arch, mesh, case)
            else:
                train(arch, mesh, case)
        out.update({f"control/{what}/{arch}/{data}x{model}/{k}": v for k, v in case.items()})


def one_rank():
    mesh = port_mesh.make_tiny_mesh(data=1, model=1, device_type="cpu")
    equal = {}
    for arch in cfg_in["archs"]:
        cfg, steps = cells(arch, mesh)
        for cell in steps:
            plain = cell.fn(*materialize(cell, "cpu", 0))
            placed = full_tensor(cell.fn(*place(cell, materialize(cell, "cpu", 0))))
            pairs = {}

            def walk(a, b, path):
                if isinstance(a, dict):
                    for k in a:
                        walk(a[k], b[k], f"{path}.{k}")
                elif isinstance(a, (tuple, list)):
                    for i, (x, y) in enumerate(zip(a, b)):
                        walk(x, y, f"{path}[{i}]")
                elif isinstance(a, torch.Tensor):
                    pairs[path] = bool(torch.equal(a, b))
                else:
                    pairs[path] = float(a) == float(b)

            walk(plain, placed, cell.step_name)
            equal[f"{arch}.{cell.step_name}"] = pairs
    with open(work + "/one_rank.json", "w") as f:
        json.dump(equal, f)


try:
    if world == 1:
        one_rank()
    else:
        out = {}
        sharded(out)
        if rank == 0:
            np.savez(work + "/sharded.npz", **out)
finally:
    dist.destroy_process_group()
"""


WITNESS = """
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.steps import build_cell, full_tensor, place
from repro_torch.models import model_defs
from repro_torch.models.params import init_params, iter_leaves

rank, world, store, work, arch, B, S = sys.argv[1:8]
rank, world, B, S = int(rank), int(world), int(B), int(S)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)


def nest(flat):
    tree = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.clone()
    return tree


z = np.load(f"{work}/{arch}.npz")
drawn = init_params(model_defs(get_smoke_config(arch)), torch.Generator().manual_seed(3), torch.float32, "cpu")
sets = {"reference_init": {k[2:]: torch.from_numpy(z[k]).double() for k in z.files if k.startswith("w.")},
        "port_init": {p.replace("/", "."): t.double() for p, t in iter_leaves(drawn)}}
toks = torch.from_numpy(z["tokens"]).long()
cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float64", compute_dtype="float64")
out = {}
try:
    for name, flat in sets.items():
        plain = None
        for data, model in ((1, 4), (2, 2)):
            mesh = port_mesh.make_tiny_mesh(data=data, model=model, device_type="cpu")
            cell = build_cell(arch, cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
            if plain is None:  # the plain-tensor step
                plain = cell.fn(nest(flat), {"tokens": toks.clone()})
            logits, cache = full_tensor(cell.fn(*place(cell, (nest(flat), {"tokens": toks.clone()}))))
            for k, got, want in [("logits", logits, plain[0])] + [(k, cache[k], plain[1][k]) for k in cache]:
                gap = (got - want).abs().max() / want.abs().max()
                out[f"witness/{name}/{data}x{model}/gap.{k}"] = np.asarray(float(gap))
    if rank == 0:
        np.savez(work + "/witness.npz", **out)
finally:
    dist.destroy_process_group()
"""


def _env(src):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(PYTHONPATH=str(src), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return env


def _start(cmds, src=ROOT / "src"):
    return [subprocess.Popen(c, env=_env(src), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for c in cmds]


def _float64_copy(dest):
    """A copy of the port under ``dest`` whose every fp32 cast (``.float()``,
    ``torch.float32``) is a float64 one: with float64 weights and compute
    dtype it runs each step in float64 throughout."""
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "repro_torch", ignore=shutil.ignore_patterns("__pycache__"))
    for path in (dest / "repro_torch").rglob("*.py"):
        text = path.read_text()
        path.write_text(text.replace(".float()", ".double()").replace("torch.float32", "torch.float64"))


def _wait(procs):
    """Wait for every process within TIMEOUT_S, kill the rest; returns
    their (returncode, stderr)."""
    results = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            results.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _weights(arch):
    """The smoke config and its weights: the reference's init at
    ``WEIGHTS_KEY`` (the weights ``tests/test_torch_moe.py`` holds these
    configs to the same cache tolerance on), as the reference's tree and as
    the port's names (``flatten_jax_tree`` of it)."""
    cfg = ref_smoke(arch)
    params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(WEIGHTS_KEY), cfg.param_jdtype())
    return cfg, params, flatten_jax_tree(jax.tree_util.tree_map(np.asarray, params), cfg)


def _ref_cache(cache):
    """Each cache leaf over all layers, the dense prefix first, as the port stacks it."""
    mixers = [cache[n]["mixer"] for n in sorted(cache) if n.startswith("prefix_")]
    stack = cache["blocks"]["pos_0"]["mixer"]
    return {k: np.concatenate([np.asarray(m[k])[None] for m in mixers] + [np.asarray(stack[k])]) for k in stack}


def _router_trace(module, record):
    """``module.router_topk`` wrapped to hand each call's expert indices and
    its top-(k+1) probabilities to ``record`` (``tests/test_torch_train.py``'s)."""
    real = module.router_topk

    def traced(params, x, moe):
        w, idx, aux = real(params, x, moe)
        more = dataclasses.replace(moe, top_k=min(moe.top_k + 1, moe.n_experts), router_scale=False)
        record(idx, real(params, x, more)[0])
        return w, idx, aux

    return real, traced


def _reference_routes(cfg, params, batch, n_micro):
    """Each microbatch's router calls in the reference's forward: (expert
    indices, smallest gap between the top-(k+1) probabilities) per token."""
    calls = []

    def record(idx, top):
        top = top.astype(jnp.float32)
        jax.debug.callback(lambda i, g: calls.append((np.asarray(i), np.asarray(g))), idx,
                           (top[..., :-1] - top[..., 1:]).min(-1))

    real, ref_moe.router_topk = _router_trace(ref_moe, record)
    try:
        size = len(batch["tokens"]) // n_micro
        for i in range(n_micro):
            logits, _ = ref_forward(cfg, params, {"tokens": jnp.asarray(batch["tokens"][i * size:(i + 1) * size])})
            logits.block_until_ready()
    finally:
        ref_moe.router_topk = real
    return calls


def _prefill(cfg, params, toks):
    """The reference's prefill: its logits and cache, and the decode cache it fills."""
    logits, cache = ref_prefill(cfg, params, {"tokens": toks})
    big = ref_transplant(ref_init_cache(cfg, B, MAX_LEN, dtype=cfg.compute_jdtype()), cache)
    return dict(prefill_logits=np.asarray(logits), prefill_cache=_ref_cache(cache), big=big)


def _reference(cfg, params, toks, labels, pre):
    """The rest of the reference's side: greedy decode steps from its
    prefill's cache, step 1's routes and one train step."""
    out = {k: pre[k] for k in ("prefill_logits", "prefill_cache")}
    big, tok = pre["big"], pre["prefill_logits"].argmax(-1).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    for i in range(DECODE_STEPS):
        logits, big = ref_decode_step(cfg, params, big, tok, pos)
        out[f"decode_logits.{i}"], out[f"decode_tokens.{i}"] = np.asarray(logits), tok
        tok, pos = np.asarray(logits).argmax(-1).astype(np.int32), pos + 1
    out["decode_cache"] = _ref_cache(big)
    batch = {"tokens": toks, "labels": labels}
    out["routes"] = _reference_routes(cfg, params, batch, 2)
    step = jax.jit(ref_make_train_step(cfg, RefTrainConfig(schedule=RefScheduleConfig(**SCHEDULE), microbatches=2)))
    state = ref_adamw_init(params, jnp.dtype(cfg.opt_state_dtype))
    new, state, metrics = step(params, state, batch)
    out["train"] = {k: float(metrics[k]) for k in ("loss", "aux", "grad_norm", "lr", "tokens")}
    for key, tree in (("start", params), ("params", new), ("m", state["m"]), ("v", state["v"])):
        out[key] = flatten_jax_tree(jax.tree_util.tree_map(np.asarray, tree), cfg)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs (four sharded ranks, one lone rank) and the
    reference's steps, computed while the ranks run."""
    work = tmp_path_factory.mktemp("sharded_moe")
    setup = {"B": B, "S": S, "MAX_LEN": MAX_LEN, "DECODE_STEPS": DECODE_STEPS, "schedule": SCHEDULE,
             "cases": [[a, list(m)] for a, m in CASES], "archs": list(ARCHS),
             "controls": [[w, a, list(m)] for w, a, m in CONTROLS]}
    (work / "setup.json").write_text(json.dumps(setup))
    procs = _start([[sys.executable, "-c", PORT, "0", "1", str(work / "store1"), str(work)]])
    weights = {}
    for arch in ARCHS:
        cfg, params, flat = _weights(arch)
        rng = np.random.default_rng(len(arch))
        toks, labels = (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32) for _ in range(2))
        weights[arch] = (cfg, params, toks, labels)
        np.savez(work / f"{arch}.npz", tokens=toks, labels=labels, **{"w." + k: v for k, v in flat.items()})
    procs += _start([[sys.executable, "-c", PORT, str(r), str(WORLD), str(work / "store4"), str(work)]
                     for r in range(WORLD)])
    _float64_copy(work / "src64")
    procs += _start([[sys.executable, "-c", WITNESS, str(r), str(WORLD), str(work / "store64"), str(work), WITNESS_ARCH,
                      str(B), str(S)] for r in range(WORLD)], src=work / "src64")
    try:
        prefills = {}
        for arch, (cfg, params, toks, labels) in weights.items():
            pre = prefills[arch] = _prefill(cfg, params, toks)
            cache = {"cache." + k: v for k, v in _ref_cache(pre["big"]).items()}
            np.savez(work / "decode.tmp.npz", first=pre["prefill_logits"].argmax(-1), **cache)
            os.replace(work / "decode.tmp.npz", work / f"{arch}.decode.npz")  # whole when the ranks see it
        reference = {arch: _reference(*weights[arch], prefills[arch]) for arch in ARCHS}
    finally:
        results = _wait(procs)
    for rc, err in results:
        assert rc == 0, err[-3000:]
    sharded = {**np.load(work / "sharded.npz"), **np.load(work / "witness.npz")}
    one = json.loads((work / "one_rank.json").read_text())
    return reference, sharded, one


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port(sharded, tag, prefix):
    head = f"{tag}/{prefix}."
    return {k[len(head):]: v for k, v in sharded.items() if k.startswith(head)}


def _tag(arch, mesh):
    return f"{arch}/{mesh[0]}x{mesh[1]}"


def _close_cache(what, port, ref):
    assert sorted(port) == sorted(ref), (sorted(port), sorted(ref))
    for k, v in port.items():
        r = np.asarray(ref[k])
        assert v.shape == r.shape, k
        np.testing.assert_allclose(v, r, atol=CACHE_REL * np.abs(r).max(), rtol=0, err_msg=f"{what} cache {k}")


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_sharded_prefill_matches_reference(runs, arch, mesh):
    reference, sharded, _ = runs
    ref, tag = reference[arch], _tag(arch, mesh)
    got = sharded[f"{tag}/prefill_logits"]
    np.testing.assert_allclose(got, ref["prefill_logits"], atol=LOGITS_ATOL, rtol=0)
    assert np.array_equal(got.argmax(-1), ref["prefill_logits"].argmax(-1))
    _close_cache(tag, _port(sharded, tag, "prefill_cache"), ref["prefill_cache"])


@pytest.mark.parametrize("mesh", WITNESS_MESHES, ids=[f"{d}x{m}" for d, m in WITNESS_MESHES])
@pytest.mark.parametrize("weights", ["reference_init", "port_init"])
def test_sharded_prefill_is_the_plain_function_in_float64(runs, weights, mesh):
    """The witness for the cache tolerance: deepseek-v2-lite's prefill run
    in float64 throughout (a copy of the port with every fp32 cast a float64
    one) on the mesh and as plain tensors, on this file's weights and on the
    port's own init at seed 3.  The sharded step computes the plain
    function: its logits and latent cache lie within ``FLOAT64_REL`` of the
    plain step's (float64 rounding, grown through the layers), where a wrong
    or missing term (a rope key expanded on the wrong heads, a sequence
    split off by a row, a combine short of a rank's experts) shows at its
    own size.  In fp32 the stacked layers' init (std ``repeats^-0.5``, gains
    of ~6-8 a projection at these widths) grows rounding through the layers,
    so two fp32 runs of this one function can differ by about the 5e-5 the
    cache is held to: on the port's init at seed 3 the (1, 4) step lands
    5.4e-5 from the reference."""
    _, sharded, _ = runs
    gaps = _port(sharded, f"witness/{weights}/{mesh[0]}x{mesh[1]}", "gap")
    assert sorted(gaps) == ["ckv", "logits"]
    assert max(gaps.values()) <= FLOAT64_REL, gaps


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_sharded_decode_steps_match_reference(runs, arch, mesh):
    """Two greedy steps of the serve cell from the prefill's cache: the
    tokens fed in equal, the logits close, the cache written in place on the
    shards (MLA's latent and llama4's (1, 4) K/V split over their sequence,
    so each step's row lies on one rank) close to the reference's."""
    reference, sharded, _ = runs
    ref, tag = reference[arch], _tag(arch, mesh)
    for i in range(DECODE_STEPS):
        assert np.array_equal(sharded[f"{tag}/decode_tokens.{i}"], ref[f"decode_tokens.{i}"])
        np.testing.assert_allclose(sharded[f"{tag}/decode_logits.{i}"], ref[f"decode_logits.{i}"],
                                   atol=LOGITS_ATOL, rtol=0, err_msg=f"step {i}")
    _close_cache(tag, _port(sharded, tag, "decode_cache"), ref["decode_cache"])


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_sharded_train_step_matches_reference(runs, arch, mesh):
    """Step 1's expert choices first (each router call of each microbatch,
    every rank's rows), then the step as tests/test_torch_train.py holds
    step 1, and the aux loss."""
    reference, sharded, _ = runs
    ref, tag = reference[arch], _tag(arch, mesh)
    calls = ref["routes"]
    assert len(calls) == 2 * sum(ref_smoke(arch).layer_is_moe(i) for i in range(ref_smoke(arch).n_layers))
    for n, (ri, rg) in enumerate(calls):
        pi, pg = sharded[f"{tag}/routes.{n}"], sharded[f"{tag}/margins.{n}"]
        assert pi.shape == ri.shape, (n, pi.shape, ri.shape)
        for t in np.nonzero((ri != pi).any(-1))[0]:
            margin = max(float(rg[t]), float(pg[t]))
            assert margin < TIE_EPS, (f"router call {n}, token {t}: experts {ri[t].tolist()} in the reference, "
                                      f"{pi[t].tolist()} on the mesh, top-k margin {margin}")
    metrics = _port(sharded, tag, "train")
    np.testing.assert_allclose(float(metrics["loss"]), ref["train"]["loss"], rtol=STEP1_TOL["loss"])
    np.testing.assert_allclose(float(metrics["aux"]), ref["train"]["aux"], rtol=AUX_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), ref["train"]["grad_norm"], rtol=STEP1_TOL["grad_norm"])
    np.testing.assert_allclose(float(metrics["lr"]), ref["train"]["lr"], rtol=1e-6)
    assert int(metrics["tokens"]) == int(ref["train"]["tokens"]) == B * S
    params, m, v = (_port(sharded, tag, k) for k in ("params", "m", "v"))
    assert sorted(params) == sorted(m) == sorted(v) == sorted(ref["params"])
    grad = {k: _rel(m[k], ref["m"][k]) for k in m}
    assert max(grad.values()) <= STEP1_TOL["grad"], grad
    size = {k: _rel(np.sqrt(v[k]), np.sqrt(ref["v"][k])) for k in v}
    assert max(size.values()) <= STEP1_TOL["grad"], size
    change = {k: _rel(params[k] - ref["start"][k], ref["params"][k] - ref["start"][k]) for k in params}
    assert max(change.values()) <= STEP1_TOL["change"], change


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_each_rank_runs_its_own_experts_only(runs, arch, mesh):
    """Every expert product of the prefill (three ``torch.bmm`` an MoE layer
    on each rank) runs on ``E / model`` experts: not all ``E``, as it would
    were the experts replicated or gathered over ``model``."""
    _, sharded, _ = runs
    cfg, tag = ref_smoke(arch), _tag(arch, mesh)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    assert sharded[f"{tag}/experts_per_rank"].tolist() == [3 * n_moe] * WORLD
    assert set(sharded[f"{tag}/experts"].tolist()) == {cfg.moe.n_experts // mesh[1]}


@pytest.mark.parametrize("what,arch,mesh", CONTROLS, ids=CONTROL_IDS)
def test_a_dropped_collective_misses_the_tolerance(runs, what, arch, mesh):
    """The controls: the combine without its sum over ``model`` (each rank
    adds only its own experts' outputs) misses the prefill logits'
    tolerance; the MLA decode without the cross-rank maximum and sums misses
    the decode logits'; aux statistics of the local tokens miss AUX_RTOL."""
    reference, sharded, _ = runs
    ref = reference[arch]
    head = f"control/{what}/{_tag(arch, mesh)}/"
    got = {k[len(head):]: v for k, v in sharded.items() if k.startswith(head)}
    if what == "combine":
        assert np.abs(got["prefill_logits"] - ref["prefill_logits"]).max() > LOGITS_ATOL
    elif what == "mla_decode":
        assert np.abs(got["decode_logits.0"] - ref["decode_logits.0"]).max() > LOGITS_ATOL
    else:
        assert abs(float(got["train.aux"]) - ref["train"]["aux"]) > AUX_RTOL * abs(ref["train"]["aux"])


def test_padded_vocabulary_masked_once_on_a_partial_head(runs):
    """llama4-scout's vocabulary pads (202,048 to 202,112).  On (2, 2) the
    head's product over a d_model split on "data" is ``Partial``: the padded
    columns must be -1e9 once (masked on each part they summed to -2e9),
    the others the plain step's, here with a vocabulary of 500 padded to
    512."""
    _, sharded, _ = runs
    got, want = sharded["padded_vocab.got"], sharded["padded_vocab.want"]
    assert got.shape == want.shape == (B, 512)
    assert (got[:, 500:] == -1e9).all() and (want[:, 500:] == -1e9).all()
    np.testing.assert_allclose(got[:, :500], want[:, :500], atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", ["prefill_step", "serve_step", "train_step"])
def test_one_rank_mesh_is_the_plain_step_bit_for_bit(runs, arch, step):
    _, _, one = runs
    pairs = one[f"{arch}.{step}"]
    assert pairs and all(pairs.values()), [k for k, ok in pairs.items() if not ok]
