"""``build_cell``'s hybrid, enc-dec and prefix-LM steps run on a device mesh against the reference's steps, on the CPU.

Built as ``tests/test_torch_sharded_moe.py`` is: the port's ranks are gloo
processes (one subprocess each, a ``FileStore`` rendezvous under
``tmp_path``, killed after ``TIMEOUT_S``), on the same weights as the
reference (the reference's init at ``WEIGHTS_KEY``, the weights each
family's parity file holds it to).  One world of four ranks runs every
sharded case in turn and the controls, one lone rank the one-rank checks:

* jamba-1.5-large-398b's smoke config cut to 5 layers: SSM layers at 0-3
  (Mamba-2, 8 SSD heads of 32), MoE (4 experts top-2) at 1 and 3, GQA
  attention (4 query heads on 2 kv heads) at 4 — the shallowest cut that
  holds each kind of layer.  whisper-medium's (2 encoder and 2 decoder
  layers of 4 heads, cross attention over 32 frames) and
  paligemma-3b's (3 layers, MQA: 4 query heads on 1 kv head, 16 vision
  tokens as a prefix-LM prefix) at their own depth.  Each on a (data 2,
  model 2) and a (data 1, model 4) mesh.  On both, paligemma's one kv head
  cannot be split over ``model``, so its decode cache is split over its
  sequence; whisper's cross cache is split over its heads.
* Each case runs the prefill cell (4 × 32 tokens, with 32 frame
  embeddings or 16 patch embeddings: the cell's own batch), two greedy
  decode steps of the serve cell from the reference's prefill cache (a
  40-row cache after a VLM's vision rows; whisper's 40-row cross cache, its
  last 8 rows zero in both packages; every leaf still at the cell's
  placements after each step) and one step of the train cell (4 × 32
  tokens in 2 microbatches), its inputs DTensors at ``cell.in_shardings``.
  whisper's cross attention also runs alone on the mesh, as
  ``tests/test_torch_encdec.py`` holds it: ``cross_attn_kv`` over 40
  frames, then ``cross_attn_apply`` for 9 rows (the flash kernel at (9, 40),
  non-causal) and for one token (decode over the whole cross cache).
* The float64 witness: each config's prefill on (1, 4) and (2, 2) in a
  copy of the port that computes in float64 throughout equals the plain
  float64 step to ``FLOAT64_REL`` (1e-10) of the scale, so what the fp32
  checks allow for rounding is rounding.
* One control a family, each with one change, must miss its tolerance:
  paligemma's prefix not passed to the local flash kernel, whisper's cross
  attention given the layer's self-attention K and V, and jamba's final
  SSM state zeroed on one rank's heads.
* On a (1, 1) mesh every step of the three configs is the plain-tensor
  step bit for bit (outputs, cache, updated parameters and moments); and
  ``attention._heads`` takes a weight whose one head is sharded over a
  one-rank mesh dim (MQA's kv head), which DTensor's own reshape refuses.
* The decode cache's placements (``cross_k`` / ``cross_v`` among them)
  equal the reference's ``cache_specs_fn`` for the three configs, smoke
  and full size, on (1, 1), (2, 2) and (1, 4).

The tolerances are each family's parity file's: logits within 5e-4 for
jamba (``tests/test_torch_hybrid.py``'s for its MoE cuts) and whisper
(``tests/test_torch_encdec.py``), within 2e-5 for paligemma
(``tests/test_torch_prefix_lm.py``); jamba's aux loss within rtol 1e-6;
each cache leaf within 5e-5 of its largest magnitude; the cross attention
alone within atol 2e-5 (``tests/test_torch_encdec.py``'s ``CROSS_ATOL``);
greedy tokens equal; the train step as
``tests/test_torch_train.py`` holds step 1 (loss rtol 1e-6, grad norm rtol
1e-3, each leaf's gradient within 2e-3 and its change within 1e-1 in
relative L2).  The cache tolerance sits near these configs' fp32
rounding: the reference's init draws the stacked layers' weights at std
``repeats^-0.5`` (0.71 for whisper's two layers, 1 for jamba's cut), so two
fp32 runs of one function differ by a good part of it.  On this file's
inputs whisper's sharded prefill caches lie 3.1-3.6e-5 of the scale from
the reference's; with 40 frames in place of the cell's 32 the reference's
own layer-2 K lies 4.5e-5 from the float64 function and the (1, 4) step's
5.3e-5 from the reference's, while the sharded step's float64 gap to the
plain step stays at 1e-14 (the witness below).
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import ShapeConfig as RefShapeConfig
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch.shardings import make_plan as ref_make_plan
from repro.models import decode_step as ref_decode_step
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.models import prefill as ref_prefill
from repro.models.attention import cross_attn_apply as ref_cross_apply
from repro.models.attention import cross_attn_kv as ref_cross_kv
from repro.optim import ScheduleConfig as RefScheduleConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.serve.cache_utils import transplant as ref_transplant
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.shardings import make_plan
from repro_torch.models import init_cache
from repro_torch.models.convert import flatten_jax_tree

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 360
WORLD = 4
ARCHS = ("jamba-1.5-large-398b", "whisper-medium", "paligemma-3b")
#: the cuts: jamba at 5 layers (SSM, SSM + MoE, SSM, SSM + MoE, attention at position 4)
N_LAYERS = {"jamba-1.5-large-398b": 5}
#: (config, (data, model)): the sharded cases
CASES = [(a, m) for a in ARCHS for m in ((2, 2), (1, 4))]
CASE_IDS = [f"{a}-{d}x{m}" for a, (d, m) in CASES]
B, S, MAX_LEN, DECODE_STEPS = 4, 32, 40, 2
CROSS_ENC, CROSS_ROWS = 40, 9  # whisper's cross attention alone: frames, query rows
#: logits, each family's parity file's
LOGITS_ATOL = {"jamba-1.5-large-398b": 5e-4, "whisper-medium": 5e-4, "paligemma-3b": 2e-5}
AUX_RTOL = 1e-6
CACHE_REL = 5e-5  # of each cache leaf's largest magnitude
CROSS_ATOL = 2e-5  # tests/test_torch_encdec.py's, for cross_attn_kv and cross_attn_apply
#: the float64 witness: a sharded prefill's largest gap to the plain step, of each output's scale
FLOAT64_REL, WITNESS_MESHES = 1e-10, ((1, 4), (2, 2))
STEP1_TOL = dict(loss=1e-6, grad_norm=1e-3, grad=2e-3, change=1e-1)  # tests/test_torch_train.py's
WEIGHTS_KEY = 7  # the weights of tests/test_torch_{hybrid,encdec,prefix_lm}.py
SCHEDULE = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
#: the controls: (the one change, config, mesh)
CONTROLS = [("prefix", "paligemma-3b", (2, 2)), ("cross_kv", "whisper-medium", (1, 4)),
            ("ssm_state", "jamba-1.5-large-398b", (2, 2))]
CONTROL_IDS = [f"{w}-{a}-{d}x{m}" for w, a, (d, m) in CONTROLS]

PORT = """
import contextlib, dataclasses, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.kernels import ops as port_ops
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.dtensors import from_shard
from repro_torch.launch.shardings import PlanOverrides
from repro_torch.launch.steps import build_cell, full_tensor, materialize, place
from repro_torch.models import activation_sharding
from repro_torch.models import attention as port_attention
from repro_torch.models import transformer as port_transformer
from repro_torch.optim import ScheduleConfig, adamw_init
from repro_torch.train import TrainConfig

rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg_in = json.loads(open(work + "/setup.json").read())
B, S, MAX_LEN, STEPS = cfg_in["B"], cfg_in["S"], cfg_in["MAX_LEN"], cfg_in["DECODE_STEPS"]
EMBEDS = ("enc_embeds", "vision_embeds")
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


def config(arch):
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, n_layers=cfg_in["n_layers"][arch]) if arch in cfg_in["n_layers"] else cfg


def cells(arch, mesh):
    cfg = config(arch)
    tcfg = TrainConfig(schedule=ScheduleConfig(**cfg_in["schedule"]), microbatches=2)
    return cfg, (build_cell(arch, cfg, ShapeConfig("prefill", S, B, "prefill"), mesh),
                 build_cell(arch, cfg, ShapeConfig("decode", MAX_LEN, B, "decode"), mesh),
                 build_cell(arch, cfg, ShapeConfig("train", S, B, "train"), mesh,
                            overrides=PlanOverrides(microbatches=2), tcfg=tcfg))


def inputs(arch):
    z = dict(np.load(f"{work}/{arch}.npz"))
    weights = {k[2:]: v for k, v in z.items() if k.startswith("w.")}
    batch = {k: torch.from_numpy(z[k]) for k in ("tokens", *EMBEDS) if k in z}
    batch["tokens"] = batch["tokens"].long()
    return z, weights, batch


def prefill(arch, mesh, out):
    cfg, (pre, _, _) = cells(arch, mesh)
    _, weights, batch = inputs(arch)
    params, placed = place(pre, (nest(weights), batch))
    # the embeddings at the batch rule: their batch on "data", the rest whole
    out["embeds_placed"] = np.asarray([tuple(placed[k].placements) == tuple(pre.in_shardings[1][k])
                                       for k in placed if k in EMBEDS] + [True])
    logits, cache = full_tensor(pre.fn(params, placed))
    out["prefill_logits"] = logits.numpy()
    out.update({"prefill_cache." + k: v.numpy() for k, v in cache.items()})


def train(arch, mesh, out):
    cfg, (_, _, tr) = cells(arch, mesh)
    z, weights, batch = inputs(arch)
    params = nest(weights)
    opt = adamw_init(flat(params))
    batch["labels"] = torch.from_numpy(z["labels"]).long()
    new_params, opt, metrics = full_tensor(tr.fn(*place(tr, (params, opt, batch))))
    out.update({"train." + k: np.asarray(float(v)) for k, v in metrics.items()})
    out.update({"params." + k: v.detach().numpy() for k, v in flat(new_params).items()})
    out.update({"m." + k: v.numpy() for k, v in opt["m"].items()})
    out.update({"v." + k: v.numpy() for k, v in opt["v"].items()})


def decode(arch, mesh, out):
    cfg, (_, dec, _) = cells(arch, mesh)
    _, weights, batch = inputs(arch)
    toks = batch["tokens"]
    # decode from the reference's prefill cache and first token, which the test writes while the ranks run
    while not os.path.exists(f"{work}/{arch}.decode.npz"):
        time.sleep(0.05)
    z = dict(np.load(f"{work}/{arch}.decode.npz"))
    big = {k: torch.from_numpy(z["cache." + k]) for k in dec.args[1]}
    params, big = place(dec, (nest(weights), big, toks[:, 0].clone(), toks[:, 0].clone()))[:2]
    tok, pos = torch.from_numpy(z["first"]).long(), torch.full((B,), S + cfg.vision_tokens, dtype=torch.long)
    kept = []  # each cache leaf still at the cell's placements after each step
    for i in range(STEPS):
        step_logits, big = dec.fn(*place(dec, (params, big, tok.clone(), pos.clone())))
        kept += [tuple(v.placements) == tuple(dec.in_shardings[1][k]) for k, v in big.items()]
        step_logits = full_tensor(step_logits)
        out[f"decode_logits.{i}"], out[f"decode_tokens.{i}"] = step_logits.numpy(), tok.numpy()
        tok, pos = step_logits.argmax(-1), pos + 1
    out["decode_cache_placed"] = np.asarray(kept)
    out.update({"decode_cache." + k: v.numpy() for k, v in full_tensor(big).items()})


def cross(arch, mesh, out):
    # layer 1's cross attention alone, its weights and inputs placed as the prefill cell places them
    from torch.distributed.tensor import distribute_tensor

    cfg, (pre, _, _) = cells(arch, mesh)
    z, weights, _ = inputs(arch)
    params = place(pre, (nest(weights), {}))[0]["layers"]["1"]["cross"]
    rule = pre.in_shardings[1]["tokens"]
    enc, x = (distribute_tensor(torch.from_numpy(z[k]), mesh, rule) for k in ("cross_enc", "cross_x"))
    with activation_sharding(pre.plan.act_rules):
        kv = port_attention.cross_attn_kv(params, enc, cfg)
        seq = port_attention.cross_attn_apply(params, x, cfg, kv)
        tok = port_attention.cross_attn_apply(params, x[:, 0], cfg, kv)
    out.update({"cross.k": kv["k"], "cross.v": kv["v"], "cross.seq": seq, "cross.tok": tok})
    out.update({k: full_tensor(v).detach().numpy() for k, v in out.items() if k.startswith("cross.")})


@contextlib.contextmanager
def changed(what):
    # the controls, one change each: the prefix dropped from the local flash call; the cross attention given
    # the layer's self-attention K and V; the final SSM state zeroed on the heads of the ranks at model 1
    patches = []
    if what == "prefix":
        real = port_ops.flash_on_shards

        def no_prefix(fn, q, k, v, **kw):
            return real(fn, q, k, v, **{**kw, "prefix_len": 0})

        patches.append((port_ops, "flash_on_shards", no_prefix))
    elif what == "cross_kv":
        real_gqa, seen = port_transformer.gqa_apply, {}

        def keep(*a, **kw):
            out, seen["kv"] = real_gqa(*a, **kw)
            return out, seen["kv"]

        patches += [(port_transformer, "gqa_apply", keep),
                    (port_transformer, "cross_attn_kv", lambda params, enc_out, cfg: dict(seen["kv"]))]
    else:
        real = port_ops.ssd_on_shards

        def zeroed(fn, *a, **kw):
            y, h = real(fn, *a, **kw)
            mesh, part = h.device_mesh, h.to_local()
            if mesh.get_local_rank("model") == 1:
                part = torch.zeros_like(part)
            return y, from_shard(part, mesh, h.placements, h.shape)

        patches.append((port_ops, "ssd_on_shards", zeroed))
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, f in patches:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def sharded(out):
    for arch, (data, model) in cfg_in["cases"]:
        mesh = port_mesh.make_tiny_mesh(data=data, model=model, device_type="cpu")
        case = {}
        prefill(arch, mesh, case)
        train(arch, mesh, case)
        decode(arch, mesh, case)
        if get_smoke_config(arch).encdec:
            cross(arch, mesh, case)
        out.update({f"{arch}/{data}x{model}/{k}": v for k, v in case.items()})
    for what, arch, (data, model) in cfg_in["controls"]:
        mesh = port_mesh.make_tiny_mesh(data=data, model=model, device_type="cpu")
        case = {}
        with changed(what):
            prefill(arch, mesh, case)
        out.update({f"control/{what}/{arch}/{data}x{model}/{k}": v for k, v in case.items()})


def walk(a, b, path, pairs):
    if isinstance(a, dict):
        for k in a:
            walk(a[k], b[k], f"{path}.{k}", pairs)
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            walk(x, y, f"{path}[{i}]", pairs)
    elif isinstance(a, torch.Tensor):
        pairs[path] = bool(torch.equal(a, b))
    else:
        pairs[path] = float(a) == float(b)


def unit_head(mesh):
    # MQA's one kv head, sharded over a one-rank "model" dim as the plan shards it: DTensor's reshape refuses
    # it, attention._heads takes it and gives the plain product and gradient bit for bit
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    g = torch.Generator().manual_seed(0)
    w, x, cot = torch.randn(96, 1, 32, generator=g), torch.randn(4, 5, 96, generator=g), torch.randn(4, 5, 1, 32, generator=g)
    wd = distribute_tensor(w, mesh, [Shard(0), Shard(1)]).requires_grad_()
    xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    try:
        wd.reshape(96, 32)
        refused = False
    except RuntimeError:
        refused = True
    got = port_attention._heads(xd, wd)
    (grad,) = torch.autograd.grad(got, wd, distribute_tensor(cot, mesh, got.placements))
    wp = w.clone().requires_grad_()
    want = port_attention._heads(x, wp)
    (want_grad,) = torch.autograd.grad(want, wp, cot)
    return {"refused": refused, "product": bool(torch.equal(got.full_tensor(), want)),
            "grad": bool(torch.equal(grad.full_tensor(), want_grad)),
            "grad_placements": list(grad.placements) == list(wd.placements)}


def one_rank():
    mesh = port_mesh.make_tiny_mesh(data=1, model=1, device_type="cpu")
    equal = {"unit_head": unit_head(mesh)}
    for arch in cfg_in["archs"]:
        cfg, steps = cells(arch, mesh)
        for cell in steps:
            plain = cell.fn(*materialize(cell, "cpu", 0))
            placed = full_tensor(cell.fn(*place(cell, materialize(cell, "cpu", 0))))
            pairs = {}
            walk(plain, placed, cell.step_name, pairs)
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
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.steps import build_cell, full_tensor, place

rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg_in = json.loads(open(work + "/setup.json").read())
B, S = cfg_in["B"], cfg_in["S"]
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


out = {}
try:
    for arch in cfg_in["archs"]:
        z = np.load(f"{work}/{arch}.npz")
        flat = {k[2:]: torch.from_numpy(z[k]).double() for k in z.files if k.startswith("w.")}
        batch = {k: torch.from_numpy(z[k]).double() for k in ("enc_embeds", "vision_embeds") if k in z.files}
        batch["tokens"] = torch.from_numpy(z["tokens"]).long()
        cfg = dataclasses.replace(get_smoke_config(arch), n_layers=cfg_in["n_layers"].get(arch, get_smoke_config(arch).n_layers),
                                  param_dtype="float64", compute_dtype="float64")
        plain = None
        for data, model in cfg_in["witness_meshes"]:
            mesh = port_mesh.make_tiny_mesh(data=data, model=model, device_type="cpu")
            cell = build_cell(arch, cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
            if plain is None:  # the plain-tensor step
                plain = cell.fn(nest(flat), dict(batch))
            logits, cache = full_tensor(cell.fn(*place(cell, (nest(flat), dict(batch)))))
            for k, got, want in [("logits", logits, plain[0])] + [(k, cache[k], plain[1][k]) for k in cache]:
                gap = (got - want).abs().max() / want.abs().max()
                out[f"witness/{arch}/{data}x{model}/gap.{k}"] = np.asarray(float(gap))
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


def _ref_config(arch):
    cfg = ref_smoke(arch)
    return dataclasses.replace(cfg, n_layers=N_LAYERS[arch]) if arch in N_LAYERS else cfg


def _weights(arch):
    """The (cut) smoke config, the reference's init at ``WEIGHTS_KEY``, and
    those weights by the port's names."""
    cfg = _ref_config(arch)
    params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(WEIGHTS_KEY), cfg.param_jdtype())
    return cfg, params, flatten_jax_tree(jax.tree_util.tree_map(np.asarray, params), cfg)


def _batch(cfg, arch):
    """Tokens, labels and the family's stub embeddings from a numpy seed."""
    rng = np.random.default_rng(len(arch))
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
    if cfg.encdec:  # the prefill and train cells' frames (B, S, d_model), and the cross attention's own inputs
        batch["enc_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        batch["cross_enc"] = rng.standard_normal((B, CROSS_ENC, cfg.d_model)).astype(np.float32)
        batch["cross_x"] = rng.standard_normal((B, CROSS_ROWS, cfg.d_model)).astype(np.float32)
    if cfg.vision_tokens:
        batch["vision_embeds"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _ref_cache(cfg, cache):
    """The reference's cache (one stack per superblock position) in the
    port's layout: each leaf stacked over the layers of its kind in layer
    order (:func:`repro_torch.models.transformer.cache_rows`), the cross
    leaves as ``cross_k`` / ``cross_v``."""
    period, rows = cfg.superblock_period, {}
    for layer in range(cfg.n_layers):
        block = cache["blocks"][f"pos_{layer % period}"]
        for part, prefix in (("mixer", ""), ("cross", "cross_")):
            for k, v in block.get(part, {}).items():
                rows.setdefault(prefix + k, []).append(np.asarray(v)[layer // period])
    return {k: np.stack(v) for k, v in rows.items()}


def _reference(cfg, params, batch):
    """The reference's steps: prefill, greedy decode from its cache (the
    decode cell's: MAX_LEN rows after a VLM's vision rows, MAX_LEN cross
    rows) and one train step; whisper's layer-1 cross attention alone."""
    batch = {k: v for k, v in batch.items() if not k.startswith("cross_")}
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    logits, small = ref_prefill(cfg, params, inputs)
    out = dict(prefill_logits=np.asarray(logits), prefill_cache=_ref_cache(cfg, small))
    big = ref_transplant(ref_init_cache(cfg, B, MAX_LEN + cfg.vision_tokens, enc_len=MAX_LEN if cfg.encdec else 0,
                                        dtype=cfg.compute_jdtype()), small)
    out["big"] = _ref_cache(cfg, big)
    tok, pos = out["prefill_logits"].argmax(-1).astype(np.int32), np.full((B,), S + cfg.vision_tokens, np.int32)
    for i in range(DECODE_STEPS):
        logits, big = ref_decode_step(cfg, params, big, tok, pos)
        out[f"decode_logits.{i}"], out[f"decode_tokens.{i}"] = np.asarray(logits), tok
        tok, pos = np.asarray(logits).argmax(-1).astype(np.int32), pos + 1
    out["decode_cache"] = _ref_cache(cfg, big)
    step = jax.jit(ref_make_train_step(cfg, RefTrainConfig(schedule=RefScheduleConfig(**SCHEDULE), microbatches=2)))
    state = ref_adamw_init(params, jnp.dtype(cfg.opt_state_dtype))
    new, state, metrics = step(params, state, batch)
    out["train"] = {k: float(metrics[k]) for k in ("loss", "aux", "grad_norm", "lr", "tokens")}
    for key, tree in (("start", params), ("params", new), ("m", state["m"]), ("v", state["v"])):
        out[key] = flatten_jax_tree(jax.tree_util.tree_map(np.asarray, tree), cfg)
    return out


def _reference_cross(cfg, params, batch):
    """The reference's layer-1 cross attention alone: K and V of the
    frames, then the 9 rows' and the first row's attention over them."""
    p = jax.tree_util.tree_map(lambda a: a[1], params["blocks"]["pos_0"]["cross"])
    kv = ref_cross_kv(p, batch["cross_enc"], cfg)
    return {"k": np.asarray(kv["k"]), "v": np.asarray(kv["v"]),
            "seq": np.asarray(ref_cross_apply(p, batch["cross_x"], cfg, kv)),
            "tok": np.asarray(ref_cross_apply(p, np.ascontiguousarray(batch["cross_x"][:, 0]), cfg, kv))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs (four sharded ranks, one lone rank) and the
    reference's steps, computed while the ranks run."""
    work = tmp_path_factory.mktemp("sharded_families")
    setup = {"B": B, "S": S, "MAX_LEN": MAX_LEN, "DECODE_STEPS": DECODE_STEPS, "schedule": SCHEDULE,
             "n_layers": N_LAYERS, "cases": [[a, list(m)] for a, m in CASES], "archs": list(ARCHS),
             "controls": [[w, a, list(m)] for w, a, m in CONTROLS], "witness_meshes": [list(m) for m in WITNESS_MESHES]}
    (work / "setup.json").write_text(json.dumps(setup))
    procs = _start([[sys.executable, "-c", PORT, "0", "1", str(work / "store1"), str(work)]])
    weights = {}
    for arch in ARCHS:
        cfg, params, flat = _weights(arch)
        batch = _batch(cfg, arch)
        np.savez(work / f"{arch}.npz", **batch, **{"w." + k: v for k, v in flat.items()})
        weights[arch] = (cfg, params, batch)
    procs += _start([[sys.executable, "-c", PORT, str(r), str(WORLD), str(work / "store4"), str(work)]
                     for r in range(WORLD)])
    _float64_copy(work / "src64")
    procs += _start([[sys.executable, "-c", WITNESS, str(r), str(WORLD), str(work / "store64"), str(work)]
                     for r in range(WORLD)], src=work / "src64")
    try:
        reference = {}
        for arch, (cfg, params, batch) in weights.items():
            ref = reference[arch] = _reference(cfg, params, batch)
            if cfg.encdec:
                ref["cross"] = _reference_cross(cfg, params, batch)
            np.savez(work / "decode.tmp.npz", first=ref["prefill_logits"].argmax(-1),
                     **{"cache." + k: v for k, v in ref.pop("big").items()})
            os.replace(work / "decode.tmp.npz", work / f"{arch}.decode.npz")  # whole when the ranks see it
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


def _cache_gaps(port, ref):
    """Each leaf's largest gap to the reference's, of its largest magnitude."""
    assert sorted(port) == sorted(ref), (sorted(port), sorted(ref))
    gaps = {}
    for k, v in port.items():
        assert v.shape == ref[k].shape, (k, v.shape, ref[k].shape)
        gaps[k] = float(np.abs(v - ref[k]).max() / np.abs(ref[k]).max())
    return gaps


def _close_cache(what, port, ref):
    gaps = _cache_gaps(port, ref)
    assert max(gaps.values()) <= CACHE_REL, (what, gaps)


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_sharded_prefill_matches_reference(runs, arch, mesh):
    """The prefill's last-position logits and every cache leaf: the
    self-attention K and V, whisper's cross K and V, jamba's conv windows
    and SSM state; the stub embeddings placed at the batch rule."""
    reference, sharded, _ = runs
    ref, tag = reference[arch], _tag(arch, mesh)
    assert sharded[f"{tag}/embeds_placed"].all()
    got = sharded[f"{tag}/prefill_logits"]
    np.testing.assert_allclose(got, ref["prefill_logits"], atol=LOGITS_ATOL[arch], rtol=0)
    assert np.array_equal(got.argmax(-1), ref["prefill_logits"].argmax(-1))
    _close_cache(tag, _port(sharded, tag, "prefill_cache"), ref["prefill_cache"])


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_sharded_decode_steps_match_reference(runs, arch, mesh):
    """Two greedy steps of the serve cell from the prefill's cache: the
    tokens fed in equal, the logits close, the cache written in place on the
    shards (paligemma's K/V split over their sequence, jamba's conv windows
    slid and its state carried, whisper's cross cache only read) close to
    the reference's, and every leaf still at the serve cell's placements
    after each step."""
    reference, sharded, _ = runs
    ref, tag = reference[arch], _tag(arch, mesh)
    placed = sharded[f"{tag}/decode_cache_placed"]
    assert placed.size and placed.all()
    for i in range(DECODE_STEPS):
        assert np.array_equal(sharded[f"{tag}/decode_tokens.{i}"], ref[f"decode_tokens.{i}"])
        np.testing.assert_allclose(sharded[f"{tag}/decode_logits.{i}"], ref[f"decode_logits.{i}"],
                                   atol=LOGITS_ATOL[arch], rtol=0, err_msg=f"step {i}")
    _close_cache(tag, _port(sharded, tag, "decode_cache"), ref["decode_cache"])


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_sharded_train_step_matches_reference(runs, arch, mesh):
    """One step of the train cell as tests/test_torch_train.py holds step 1,
    and jamba's aux loss."""
    reference, sharded, _ = runs
    ref, tag = reference[arch], _tag(arch, mesh)
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


@pytest.mark.parametrize("mesh", WITNESS_MESHES, ids=[f"{d}x{m}" for d, m in WITNESS_MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_is_the_plain_function_in_float64(runs, arch, mesh):
    """The witness for the fp32 tolerances: the prefill run in float64
    throughout (a copy of the port with every fp32 cast a float64 one) on
    the mesh and as plain tensors, on this file's weights and inputs.  The
    sharded step computes the plain function: its logits and every cache
    leaf lie within ``FLOAT64_REL`` of the plain step's, where a wrong or
    missing term (a prefix dropped, a cross K from the wrong tensor, a
    state zeroed on some heads) shows at its own size."""
    _, sharded, _ = runs
    gaps = _port(sharded, f"witness/{_tag(arch, mesh)}", "gap")
    want = {"jamba-1.5-large-398b": ["conv_B", "conv_C", "conv_x", "h", "k", "logits", "v"],
            "whisper-medium": ["cross_k", "cross_v", "k", "logits", "v"], "paligemma-3b": ["k", "logits", "v"]}
    assert sorted(gaps) == want[arch]
    assert max(gaps.values()) <= FLOAT64_REL, gaps


@pytest.mark.parametrize("what,arch,mesh", CONTROLS, ids=CONTROL_IDS)
def test_one_change_misses_the_tolerance(runs, what, arch, mesh):
    """The controls: paligemma's prefill without its prefix on the local
    flash kernel misses the logits' tolerance; whisper's with each layer's
    self-attention K and V in place of the encoder's misses it too, and its
    cross cache is not the reference's; jamba's with the final SSM state
    zeroed on the heads of the ranks at ``model`` 1 misses the cache
    tolerance on ``h``, and only there."""
    reference, sharded, _ = runs
    ref = reference[arch]
    got = _port(sharded, f"control/{what}/{_tag(arch, mesh)}", "prefill_cache")
    logits = sharded[f"control/{what}/{_tag(arch, mesh)}/prefill_logits"]
    if what == "ssm_state":
        gaps = _cache_gaps(got, ref["prefill_cache"])
        assert gaps["h"] > CACHE_REL and max(g for k, g in gaps.items() if k != "h") <= CACHE_REL, gaps
        np.testing.assert_allclose(logits, ref["prefill_logits"], atol=LOGITS_ATOL[arch], rtol=0)
    else:
        assert np.abs(logits - ref["prefill_logits"]).max() > LOGITS_ATOL[arch]
    if what == "cross_kv":
        gaps = _cache_gaps(got, ref["prefill_cache"])
        assert min(gaps["cross_k"], gaps["cross_v"]) > CACHE_REL, gaps


@pytest.mark.parametrize("mesh", [m for a, m in CASES if a == "whisper-medium"], ids=["2x2", "1x4"])
def test_sharded_cross_attention_matches_reference(runs, mesh):
    """whisper's layer-1 cross attention alone on the mesh, as
    tests/test_torch_encdec.py holds it: ``cross_attn_kv`` over 40 frames,
    then ``cross_attn_apply`` for 9 rows (flash at (9, 40), non-causal, on
    the shards) and for one token (decode over the whole cross K and V)."""
    reference, sharded, _ = runs
    ref, got = reference["whisper-medium"]["cross"], _port(sharded, _tag("whisper-medium", mesh), "cross")
    assert sorted(got) == sorted(ref)
    for k, want in ref.items():
        assert got[k].shape == want.shape, k
        np.testing.assert_allclose(got[k], want, atol=CROSS_ATOL, rtol=0, err_msg=k)


def test_a_one_rank_head_dim_is_taken_as_replicated(runs):
    """MQA's one kv head sharded over a one-rank ``model`` dim (paligemma's
    ``wk`` on a (1, 1) mesh): DTensor's reshape refuses the sharded size-1
    dim; ``attention._heads`` gives the plain product and gradient bit for
    bit, the gradient at the weight's placements."""
    _, _, one = runs
    assert one["unit_head"] == {"refused": True, "product": True, "grad": True, "grad_placements": True}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", ["prefill_step", "serve_step", "train_step"])
def test_one_rank_mesh_is_the_plain_step_bit_for_bit(runs, arch, step):
    _, _, one = runs
    pairs = one[f"{arch}.{step}"]
    assert pairs and all(pairs.values()), [k for k, ok in pairs.items() if not ok]


def _stripped(spec) -> tuple:
    out = [tuple(e) if isinstance(e, list) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_cache_specs(cfg, shape, mesh_shape):
    """The reference's decode-cache specs by the port's keys (without the
    leading stack axis; every leaf of one kind agrees)."""
    stand_in = SimpleNamespace(axis_names=("data", "model"), devices=np.empty(mesh_shape, dtype=object))
    plan = ref_make_plan(cfg, shape, stand_in)
    cache = jax.eval_shape(lambda: ref_init_cache(cfg, shape.global_batch, shape.seq_len + (cfg.vision_tokens or 0),
                                                  enc_len=shape.seq_len if cfg.encdec else 0))
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(plan.cache_specs_fn(cache),
                                                           is_leaf=lambda x: isinstance(x, JP))[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        kind = f"cross_{keys[-1]}" if keys[-2] == "cross" else keys[-1]
        body = _stripped(tuple(spec)[1:])
        assert out.setdefault(kind, body) == body, (kind, out[kind], body)
    return out


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (1, 4)], ids=["1x1", "2x2", "1x4"])
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_placements_match_reference(arch, size, mesh_shape):
    """The serve cell's cache specs (K/V, the cross stack, the conv windows
    and the SSM state) as the reference's ``cache_specs_fn`` gives them, on
    torch's ``fake`` process group of the mesh's size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg, ref_cfg = (get_smoke_config(arch), ref_smoke(arch)) if size == "smoke" else (get_config(arch),
                                                                                      ref_get_config(arch))
    want = _ref_cache_specs(ref_cfg, RefShapeConfig("decode", MAX_LEN, B, "decode"), mesh_shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(np.prod(mesh_shape)))
    try:
        mesh = port_mesh.make_tiny_mesh(data=mesh_shape[0], model=mesh_shape[1], device_type="cpu")
        plan = make_plan(cfg, ShapeConfig("decode", MAX_LEN, B, "decode"), mesh)
        cache = init_cache(cfg, B, MAX_LEN + (cfg.vision_tokens or 0), enc_len=MAX_LEN if cfg.encdec else 0,
                           device="meta")
        specs = plan.cache_specs_fn(cache)
        plan.placements(specs)  # every spec has a DTensor counterpart
    finally:
        dist.destroy_process_group()
    assert sorted(specs) == sorted(want)
    got = {k: (s[0], _stripped(tuple(s)[1:])) for k, s in specs.items()}
    assert got == {k: (None, w) for k, w in want.items()}
