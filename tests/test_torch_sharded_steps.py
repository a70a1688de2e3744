"""``build_cell``'s steps run on a device mesh (``repro_torch.launch.steps.place``)
against the reference's steps, on the CPU.

The port's ranks are gloo processes (one subprocess each, a ``FileStore``
rendezvous under ``tmp_path``, killed after 120 s), as in
``tests/test_torch_pipeline.py``.  Four ranks run, on the same weights as
the reference (drawn by the port's seeded init, which keeps the
reference's recipes, and stacked into the reference's tree):

* deepseek-7b's and mamba2-130m's smoke configs on a (data 2, model 2)
  mesh, and qwen2-72b's (8 query heads on 2 kv heads) on (1, 4), where the
  kv heads do not divide ``model``: each rank's flash call reads the one kv
  head its two query heads share, and the decode cache is split over its
  sequence.  Each runs the prefill cell (4 × 32 tokens), two greedy decode
  steps of the serve cell (a 40-row cache) and one step of the train cell (4
  × 32 tokens in 2 microbatches, peak lr 1e-3 after 2 warm-up steps), its
  parameters, optimizer state, batch and cache DTensors at
  ``cell.in_shardings``.
* The vocab-parallel cross-entropy (``train.trainer.sharded_cross_entropy``)
  with masked labels and z-loss, on logits whose vocabulary is split 4 ways
  (1, 4) and 2 ways beside 2 batch shards (2, 2), and its gradient; and the
  padded vocabulary's mask (``logits_apply``) on a head split 4 ways.

The reference runs the same steps in this process.  The tolerances are the
parity tests' for these configs: prefill and decode logits within atol 5e-5
(deepseek-7b, mamba2-130m) or 1e-4 (qwen2-72b), each cache leaf within 5e-5
of its largest magnitude (``tests/test_torch_models.py``'s rule for K/V; on
these inputs the unsharded port itself is 6.8e-6 of the scale from the
reference on mamba2's conv windows and 1.04e-5 on its state, past the
absolute 1e-4 and relative 1e-5 that ``tests/test_torch_ssm.py`` holds its
own inputs to), greedy tokens equal; the train
step as ``tests/test_torch_train.py`` holds its first step: loss rtol 1e-6,
grad norm rtol 1e-3, each leaf's gradient (the first moment, and the square
root of the second) within 2e-3 and its parameter change within 1e-1 of the
reference's in relative L2; the cross-entropy rtol 1e-6.

One more rank runs alone, on a (1, 1) mesh: every step of deepseek-7b and
mamba2-130m placed on it is the plain-tensor step bit for bit (outputs,
cache, updated parameters and moments), and the int8-compressed train step
refuses DTensors.
"""

import dataclasses
import json
import os
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
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.models import prefill as ref_prefill
from repro.optim import ScheduleConfig as RefScheduleConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.serve.cache_utils import transplant as ref_transplant
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import cross_entropy as ref_cross_entropy
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import model_defs
from repro_torch.models.convert import flatten_jax_tree
from repro_torch.models.params import init_params as port_init_params
from repro_torch.models.params import iter_leaves

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
WORLD = 4
#: (config, (data, model)): the sharded cases
CASES = [("deepseek-7b", (2, 2)), ("mamba2-130m", (2, 2)), ("qwen2-72b", (1, 4))]
CASE_IDS = [f"{a}-{d}x{m}" for a, (d, m) in CASES]
#: the one-rank bit-for-bit cases
ONE_RANK = ["deepseek-7b", "mamba2-130m"]
B, S, MAX_LEN, DECODE_STEPS, N_LAYERS = 4, 32, 40, 2, 2
LOGITS_ATOL = {"deepseek-7b": 5e-5, "mamba2-130m": 5e-5, "qwen2-72b": 1e-4}
CACHE_REL = 5e-5  # of each cache leaf's largest magnitude
STEP1_TOL = dict(loss=1e-6, grad_norm=1e-3, grad=2e-3, change=1e-1)
SCHEDULE = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
CE_SHAPE, CE_VOCAB, CE_Z = (4, 6, 32), 30, 1e-4

PORT = """
import dataclasses, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.shardings import PlanOverrides
from repro_torch.launch.steps import build_cell, full_tensor, materialize, place
from repro_torch.optim import ScheduleConfig, adamw_init
from repro_torch.train import TrainConfig
from repro_torch.train.trainer import cross_entropy, sharded_cross_entropy

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
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=cfg_in["n_layers"])
    tcfg = TrainConfig(schedule=ScheduleConfig(**cfg_in["schedule"]), microbatches=2)
    return cfg, (build_cell(arch, cfg, ShapeConfig("prefill", S, B, "prefill"), mesh),
                 build_cell(arch, cfg, ShapeConfig("decode", MAX_LEN, B, "decode"), mesh),
                 build_cell(arch, cfg, ShapeConfig("train", S, B, "train"), mesh,
                            overrides=PlanOverrides(microbatches=2), tcfg=tcfg))


def sharded_case(arch, data, model, out):
    mesh = port_mesh.make_tiny_mesh(data=data, model=model, device_type="cpu")
    cfg, (pre, dec, tr) = cells(arch, mesh)
    z = dict(np.load(f"{work}/{arch}.npz"))
    weights = {k[2:]: v for k, v in z.items() if k.startswith("w.")}
    toks = torch.from_numpy(z["tokens"]).long()
    logits, cache = full_tensor(pre.fn(*place(pre, (nest(weights), {"tokens": toks.clone()}))))
    out["prefill_logits"] = logits.numpy()
    out.update({"prefill_cache." + k: v.numpy() for k, v in cache.items()})
    params = nest(weights)
    opt = adamw_init(flat(params))
    batch = {"tokens": toks.clone(), "labels": torch.from_numpy(z["labels"]).long()}
    new_params, opt, metrics = full_tensor(tr.fn(*place(tr, (params, opt, batch))))
    out.update({"train." + k: np.asarray(float(v)) for k, v in metrics.items()})
    out.update({"params." + k: v.detach().numpy() for k, v in flat(new_params).items()})
    out.update({"m." + k: v.numpy() for k, v in opt["m"].items()})
    out.update({"v." + k: v.numpy() for k, v in opt["v"].items()})
    # decode from the reference's prefill cache and first token (each step's gap is the step's own),
    # which the test writes while the ranks run
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


def ce_case(data, model, out):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = port_mesh.make_tiny_mesh(data=data, model=model, device_type="cpu")
    z = dict(np.load(f"{work}/ce.npz"))
    logits = distribute_tensor(torch.from_numpy(z["logits"]), mesh, [Shard(0), Shard(2)]).requires_grad_()
    labels = distribute_tensor(torch.from_numpy(z["labels"]).long(), mesh, [Shard(0), Replicate()])
    loss, n = sharded_cross_entropy(logits, labels, cfg_in["ce_z"])
    loss.backward()
    tag = f"ce.{data}x{model}"
    out[tag + ".loss"], out[tag + ".tokens"] = loss.detach().numpy(), np.asarray(float(n))
    out[tag + ".grad"] = logits.grad.full_tensor().numpy()


def vocab_mask_case(out):
    # logits_apply on a head sharded 4 ways over the vocabulary, of a config whose vocabulary (500) pads to
    # 512: the last rank's block holds the padded columns
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.layers import logits_apply

    mesh = port_mesh.make_tiny_mesh(data=1, model=4, device_type="cpu")
    cfg = dataclasses.replace(get_smoke_config("deepseek-7b"), vocab_size=500)
    g = torch.Generator().manual_seed(5)
    x, w = torch.randn(2, 3, cfg.d_model, generator=g), torch.randn(cfg.d_model, cfg.padded_vocab, generator=g)
    out["vocab_mask.want"] = logits_apply({}, {"w": w}, x, cfg).numpy()
    got = logits_apply({}, {"w": distribute_tensor(w, mesh, [Replicate(), Shard(1)])},
                       distribute_tensor(x, mesh, [Replicate(), Replicate()]), cfg)
    out["vocab_mask.vocab_sharded"] = np.asarray([isinstance(p, Shard) and p.dim == 2 for p in got.placements])
    out["vocab_mask.got"] = got.full_tensor().numpy()


def one_rank(out):
    mesh = port_mesh.make_tiny_mesh(data=1, model=1, device_type="cpu")
    equal = {}
    for arch in cfg_in["one_rank"]:
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
    cfg = get_smoke_config("deepseek-7b")
    compressed = build_cell("deepseek-7b", cfg, ShapeConfig("train", S, B, "train"), mesh,
                            tcfg=TrainConfig(compress_grads=True, microbatches=1))
    try:
        compressed.fn(*place(compressed, materialize(compressed, "cpu", 0)))
        equal["compress_grads"] = "ran"
    except NotImplementedError as e:
        equal["compress_grads"] = str(e)
    logits = torch.from_numpy(np.load(f"{work}/ce.npz")["logits"])
    labels = torch.from_numpy(np.load(f"{work}/ce.npz")["labels"]).long()
    from torch.distributed.tensor import Shard, distribute_tensor

    a = logits.clone().requires_grad_()
    want, n_want = cross_entropy(a, labels, cfg_in["ce_z"])
    want.backward()
    b = distribute_tensor(logits.clone(), mesh, [Shard(0), Shard(2)]).requires_grad_()
    got, n_got = sharded_cross_entropy(b, labels, cfg_in["ce_z"])
    got.backward()
    equal["ce"] = {"loss": bool(torch.equal(want, got)), "tokens": int(n_want) == int(n_got),
                   "grad": bool(torch.equal(a.grad, b.grad.full_tensor()))}
    with open(work + "/one_rank.json", "w") as f:
        json.dump(equal, f)


try:
    if world == 1:
        one_rank({})
    else:
        out = {}
        for arch, (data, model) in cfg_in["cases"]:
            case = {}
            sharded_case(arch, data, model, case)
            out.update({f"{arch}/{k}": v for k, v in case.items()})
        for data, model in ((1, 4), (2, 2)):
            ce_case(data, model, out)
        vocab_mask_case(out)
        if rank == 0:
            np.savez(work + "/sharded.npz", **out)
finally:
    dist.destroy_process_group()
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return env


def _start(cmds):
    return [subprocess.Popen(c, env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for c in cmds]


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
    """The config cut to N_LAYERS and its weights: the port's own seeded init
    (the reference's recipes, drawn by torch in milliseconds), as the
    reference's tree (each ``blocks/pos_0`` leaf the layers stacked) and as
    the port's names (``flatten_jax_tree`` of it)."""
    cfg = dataclasses.replace(ref_smoke(arch), n_layers=N_LAYERS)
    port_cfg = dataclasses.replace(get_smoke_config(arch), n_layers=N_LAYERS)
    drawn = port_init_params(model_defs(port_cfg), torch.Generator().manual_seed(3), torch.float32, "cpu")
    flat = {path.replace("/", "."): t.numpy() for path, t in iter_leaves(drawn)}
    shapes = jax.eval_shape(lambda: ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(0), cfg.param_jdtype()))

    def fill(tree, path):
        if isinstance(tree, dict):
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        if path[:2] == ("blocks", "pos_0"):
            rest = ".".join(path[2:])
            return jnp.asarray(np.stack([flat[f"layers.{i}.{rest}"] for i in range(N_LAYERS)]))
        return jnp.asarray(flat[".".join(path)])

    params = fill(shapes, ())
    assert flatten_jax_tree(jax.tree_util.tree_map(np.asarray, params), cfg).keys() == flat.keys()
    return cfg, params, flat


def _prefill(arch, cfg, params, toks, labels):
    """The reference's prefill: its logits and cache, and the decode cache it fills."""
    logits, cache = ref_prefill(cfg, params, {"tokens": toks})
    big = ref_transplant(ref_init_cache(cfg, B, MAX_LEN, dtype=cfg.compute_jdtype()), cache)
    return dict(cfg=cfg, params=params, tokens=toks, labels=labels, prefill_logits=np.asarray(logits),
                prefill_cache=cache["blocks"]["pos_0"]["mixer"], big=big)


def _reference(pre):
    """The rest of the reference's side: greedy decode steps from its
    prefill's cache, and one train step."""
    cfg, params = pre["cfg"], pre["params"]
    out = {k: pre[k] for k in ("prefill_logits", "prefill_cache")}
    big, tok = pre["big"], pre["prefill_logits"].argmax(-1).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    for i in range(DECODE_STEPS):
        logits, big = ref_decode_step(cfg, params, big, tok, pos)
        out[f"decode_logits.{i}"], out[f"decode_tokens.{i}"] = np.asarray(logits), tok
        tok, pos = np.asarray(logits).argmax(-1).astype(np.int32), pos + 1
    out["decode_cache"] = big["blocks"]["pos_0"]["mixer"]
    step = jax.jit(ref_make_train_step(cfg, RefTrainConfig(schedule=RefScheduleConfig(**SCHEDULE), microbatches=2)))
    state = ref_adamw_init(params, jnp.dtype(cfg.opt_state_dtype))
    new, state, metrics = step(params, state, {"tokens": pre["tokens"], "labels": pre["labels"]})
    out["train"] = {k: float(metrics[k]) for k in ("loss", "grad_norm", "lr", "tokens")}
    for key, tree in (("start", params), ("params", new), ("m", state["m"]), ("v", state["v"])):
        out[key] = flatten_jax_tree(jax.tree_util.tree_map(np.asarray, tree), cfg)
    return out


def _ce_inputs():
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal(CE_SHAPE) * 3).astype(np.float32)
    labels = rng.integers(0, CE_VOCAB, CE_SHAPE[:2])
    labels[rng.random(CE_SHAPE[:2]) < 0.25] = -1  # masked positions
    return logits, labels.astype(np.int64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs (four sharded ranks, one lone rank) and the
    reference's steps, computed while the ranks run."""
    work = tmp_path_factory.mktemp("sharded")
    setup = {"B": B, "S": S, "MAX_LEN": MAX_LEN, "DECODE_STEPS": DECODE_STEPS, "schedule": SCHEDULE,
             "n_layers": N_LAYERS, "cases": [[a, list(m)] for a, m in CASES], "one_rank": ONE_RANK, "ce_z": CE_Z}
    (work / "setup.json").write_text(json.dumps(setup))
    logits, labels = _ce_inputs()
    np.savez(work / "ce.npz", logits=logits, labels=labels)
    procs = _start([[sys.executable, "-c", PORT, "0", "1", str(work / "store1"), str(work)]])
    weights = {}
    for arch, _ in CASES:
        cfg, params, flat = _weights(arch)
        rng = np.random.default_rng(len(arch))
        toks, labels = (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32) for _ in range(2))
        weights[arch] = (cfg, params, toks, labels)
        np.savez(work / f"{arch}.npz", tokens=toks, labels=labels, **{"w." + k: v for k, v in flat.items()})
    procs += _start([[sys.executable, "-c", PORT, str(r), str(WORLD), str(work / "store4"), str(work)]
                     for r in range(WORLD)])
    try:
        prefills = {}
        for arch, args in weights.items():
            pre = prefills[arch] = _prefill(arch, *args)
            cache = {"cache." + k: np.asarray(v) for k, v in pre["big"]["blocks"]["pos_0"]["mixer"].items()}
            np.savez(work / "decode.tmp.npz", first=pre["prefill_logits"].argmax(-1), **cache)
            os.replace(work / "decode.tmp.npz", work / f"{arch}.decode.npz")  # whole when the ranks see it
        reference = {arch: _reference(pre) for arch, pre in prefills.items()}
    finally:
        results = _wait(procs)
    for rc, err in results:
        assert rc == 0, err[-3000:]
    sharded = dict(np.load(work / "sharded.npz"))
    one = json.loads((work / "one_rank.json").read_text())
    return reference, sharded, one


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port(sharded, arch, prefix):
    head = f"{arch}/{prefix}."
    return {k[len(head):]: v for k, v in sharded.items() if k.startswith(head)}


def _close_cache(arch, port, ref):
    assert sorted(port) == sorted(ref), (sorted(port), sorted(ref))
    for k, v in port.items():
        r = np.asarray(ref[k])
        assert v.shape == r.shape, k
        np.testing.assert_allclose(v, r, atol=CACHE_REL * np.abs(r).max(), rtol=0, err_msg=f"{arch} cache {k}")


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_sharded_prefill_matches_reference(runs, arch, mesh):
    reference, sharded, _ = runs
    ref = reference[arch]
    got = sharded[f"{arch}/prefill_logits"]
    np.testing.assert_allclose(got, ref["prefill_logits"], atol=LOGITS_ATOL[arch], rtol=0)
    assert np.array_equal(got.argmax(-1), ref["prefill_logits"].argmax(-1))
    _close_cache(arch, _port(sharded, arch, "prefill_cache"), ref["prefill_cache"])


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_sharded_decode_steps_match_reference(runs, arch, mesh):
    """Two greedy steps of the serve cell from the prefill's cache: the
    tokens fed in equal, the logits close, the cache written in place on
    the shards close to the reference's (on (1, 4) qwen2's is split over
    its sequence, so each step's row lies on one rank)."""
    reference, sharded, _ = runs
    ref = reference[arch]
    for i in range(DECODE_STEPS):
        assert np.array_equal(sharded[f"{arch}/decode_tokens.{i}"], ref[f"decode_tokens.{i}"])
        np.testing.assert_allclose(sharded[f"{arch}/decode_logits.{i}"], ref[f"decode_logits.{i}"],
                                   atol=LOGITS_ATOL[arch], rtol=0, err_msg=f"step {i}")
    _close_cache(arch, _port(sharded, arch, "decode_cache"), ref["decode_cache"])


@pytest.mark.parametrize("arch,mesh", CASES, ids=CASE_IDS)
def test_sharded_train_step_matches_reference(runs, arch, mesh):
    reference, sharded, _ = runs
    ref = reference[arch]
    metrics = _port(sharded, arch, "train")
    np.testing.assert_allclose(float(metrics["loss"]), ref["train"]["loss"], rtol=STEP1_TOL["loss"])
    np.testing.assert_allclose(float(metrics["grad_norm"]), ref["train"]["grad_norm"], rtol=STEP1_TOL["grad_norm"])
    np.testing.assert_allclose(float(metrics["lr"]), ref["train"]["lr"], rtol=1e-6)
    assert int(metrics["tokens"]) == int(ref["train"]["tokens"]) == B * S
    params, m, v = (_port(sharded, arch, k) for k in ("params", "m", "v"))
    assert sorted(params) == sorted(m) == sorted(v) == sorted(ref["params"])
    grad = {k: _rel(m[k], ref["m"][k]) for k in m}
    assert max(grad.values()) <= STEP1_TOL["grad"], grad
    size = {k: _rel(np.sqrt(v[k]), np.sqrt(ref["v"][k])) for k in v}
    assert max(size.values()) <= STEP1_TOL["grad"], size
    change = {k: _rel(params[k] - ref["start"][k], ref["params"][k] - ref["start"][k]) for k in params}
    assert max(change.values()) <= STEP1_TOL["change"], change


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_vocab_parallel_cross_entropy(runs, mesh):
    """The loss, token count and logits gradient of the vocab-parallel
    cross-entropy (vocabulary sharded over ``model``, rows over ``data``;
    a quarter of the labels masked, z-loss on) against the reference's
    ``cross_entropy`` and its ``jax.grad``."""
    _, sharded, _ = runs
    logits, labels = _ce_inputs()
    f = lambda x: ref_cross_entropy(x, jnp.asarray(labels), CE_Z)  # noqa: E731
    (want, n), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    tag = f"ce.{mesh}"
    np.testing.assert_allclose(sharded[tag + ".loss"], float(want), rtol=1e-6)
    assert int(sharded[tag + ".tokens"]) == int(n) == int((labels >= 0).sum())
    np.testing.assert_allclose(sharded[tag + ".grad"], np.asarray(grad), rtol=1e-6, atol=1e-9)


def test_padded_vocabulary_masked_on_vocab_shards(runs):
    """The padded columns (>= vocab_size) at -1e9 on the rank whose block
    holds them, the rest the plain head's logits (fp32; the shards' products
    within 1e-6)."""
    _, sharded, _ = runs
    got, want = sharded["vocab_mask.got"], sharded["vocab_mask.want"]
    assert sharded["vocab_mask.vocab_sharded"].tolist() == [False, True]  # the logits' vocabulary on "model"
    assert got.shape == want.shape == (2, 3, 512)
    assert (got[..., 500:] == -1e9).all() and (want[..., 500:] == -1e9).all()
    np.testing.assert_allclose(got[..., :500], want[..., :500], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ONE_RANK)
@pytest.mark.parametrize("step", ["prefill_step", "serve_step", "train_step"])
def test_one_rank_mesh_is_the_plain_step_bit_for_bit(runs, arch, step):
    _, _, one = runs
    pairs = one[f"{arch}.{step}"]
    assert pairs and all(pairs.values()), [k for k, ok in pairs.items() if not ok]


def test_one_rank_vocab_parallel_cross_entropy_is_the_plain_one_bit_for_bit(runs):
    _, _, one = runs
    assert one["ce"] == {"loss": True, "tokens": True, "grad": True}


def test_compressed_step_refuses_dtensors(runs):
    _, _, one = runs
    assert "plain tensors" in one["compress_grads"], one["compress_grads"]


@pytest.mark.parametrize("path", ["autograd", "op"])
def test_ssd_gradients_come_back_in_their_inputs_layouts(path):
    """The SSD scan hands each gradient back in its input's strides: the
    card's ``SSDScan`` backward (run here on its plain version) and the
    op's CPU path through the chunked form, on x, dt, B and C cut from one
    projection (strided views, as mamba's in-projection gives them), with
    the same values on both paths: so a plain step and a sharded one sum
    them in one order."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_autograd

    B, S, H, P, N = 2, 16, 4, 8, 8
    gen = torch.Generator().manual_seed(0)
    proj = torch.randn(B, S, H * P + H + 2 * N, generator=gen, requires_grad=True)
    A, D = -torch.rand(H, generator=gen), torch.rand(H, generator=gen)

    def grads(run):
        x = proj[..., :H * P].reshape(B, S, H, P)
        dt = torch.nn.functional.softplus(proj[..., H * P:H * P + H])
        Bm = proj[..., H * P + H:H * P + H + N].reshape(B, S, 1, N)
        Cm = proj[..., H * P + H + N:].reshape(B, S, 1, N)
        y, h = run(x, dt, A, Bm, Cm, D, None)
        return (x, dt, Bm, Cm), torch.autograd.grad(y.square().sum() + h.sum(), (x, dt, Bm, Cm))

    op = lambda *a: ops.ssd_scan(*a, chunk=8)  # noqa: E731
    inputs, got = grads((lambda *a: ssd_scan_autograd(*a, chunk=8)) if path == "autograd" else op)
    assert [g.stride() for g in got] == [t.stride() for t in inputs]
    assert inputs[2].stride() != torch.empty(inputs[2].shape).stride()  # B is a strided view
    _, want = grads(op)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
