"""The port's sharding plan, meshes and activation constraints against the
reference's, on the CPU.

* The plan: for each of the 10 configs × the 4 ``SHAPES`` × the tiny (2, 2),
  production (16, 16) and multi-pod (2, 16, 16) meshes, the port's
  ``make_plan`` runs on a ``DeviceMesh`` over torch's ``fake`` process-group
  backend (one process, any world size) and the reference's on a stand-in
  mesh (``axis_names`` and a ``devices`` array of the mesh's shape: its
  ``make_plan`` reads nothing else).  Compared as tuples with trailing
  ``None``s stripped (JAX's ``PartitionSpec`` keeps them): every parameter's
  spec (the reference's stacked ``blocks`` leaves carry a leading
  replicated layer axis the port's per-layer leaves do not), the activation
  rules, the batch rule, and the cache specs over ``init_cache`` shapes (the
  reference's under ``jax.eval_shape``, the port's on the ``meta`` device).
* Each rank's block: on the tiny meshes, every rank's local offsets and
  shape from the port's placements (DTensor's own
  ``compute_local_shape_and_global_offset`` at that rank) against the
  reference's ``NamedSharding.devices_indices_map``, computed in one
  subprocess with 8 forced host devices.
* ``constrain`` with and without rules, and the refusal of a dim split over
  mesh axes out of the mesh's order.
"""

import contextlib
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS, SHAPES as REF_SHAPES, get_config as ref_get_config
from repro.launch.shardings import make_plan as ref_make_plan
from repro.models import init_cache as ref_init_cache
from repro.models.act_sharding import activation_sharding as ref_activation_sharding
from repro.models.act_sharding import constrain as ref_constrain
from repro.models.params import DEFAULT_RULES as REF_DEFAULT_RULES
from repro.models.params import logical_to_pspec as ref_logical_to_pspec
from repro.models.transformer import num_layers_in_stack
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.shardings import PlanOverrides, make_plan
from repro_torch.models import Transformer, activation_sharding, constrain, init_cache, model_defs
from repro_torch.models.act_sharding import current_rules, logical_spec
from repro_torch.models.params import DEFAULT_RULES, PartitionSpec, iter_leaves, logical_to_pspec, spec_placements

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"tiny": (2, 2), "production": (16, 16), "multi_pod": (2, 16, 16)}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """torch's ``fake`` process group of ``size`` ranks, this process as
    ``rank``, for the duration of the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def port_mesh_of(shape):
    """The port's mesh function for ``shape`` (its tiny or production mesh) on the CPU."""
    if shape == (16, 16):
        return port_mesh.make_production_mesh(device_type="cpu")
    if shape == (2, 16, 16):
        return port_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    return port_mesh.make_tiny_mesh(multi_pod=len(shape) == 3, data=shape[-2], model=shape[-1], device_type="cpu")


def stripped(spec) -> tuple:
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(tuple(e) if isinstance(e, list) else e for e in out)


def ref_param_specs_by_port_name(cfg, specs) -> dict:
    """The reference's spec tree as ``{port parameter name: spec tuple}``:
    a stacked leaf (``blocks/pos_<p>``, ``encoder/blocks``) gives each of its
    layers its spec without the leading layer axis."""
    n_prefix, period, repeats = num_layers_in_stack(cfg)
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[0] == "blocks" and keys[1].startswith("pos_"):
            p = int(keys[1][len("pos_"):])
            assert spec == JP() or tuple(spec)[0] is None, (keys, spec)  # the layer axis stays replicated
            for r in range(repeats):
                out[f"layers.{n_prefix + r * period + p}." + ".".join(keys[2:])] = stripped(tuple(spec)[1:])
        elif keys[:2] == ["encoder", "blocks"]:
            for r in range(cfg.n_enc_layers):
                out[f"encoder.layers.{r}." + ".".join(keys[2:])] = stripped(tuple(spec)[1:])
        elif keys[0].startswith("prefix_"):
            out[f"layers.{int(keys[0][len('prefix_'):])}." + ".".join(keys[1:])] = stripped(spec)
        else:
            out[".".join(keys)] = stripped(spec)
    return out


def ref_cache_specs_by_kind(specs) -> dict:
    """The reference's cache spec tree as ``{port cache key: spec tuple}``
    (each without the leading stack axis where the leaf is stacked); every
    leaf of one kind must agree."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        kind = f"cross_{keys[-1]}" if keys[-2] == "cross" else keys[-1]
        body = stripped(tuple(spec)[1:]) if "blocks" in keys else stripped(spec)
        assert out.setdefault(kind, body) == body, (kind, out[kind], body)
    return out


@lru_cache(maxsize=None)
def reference_plan(arch: str, shape_name: str, mesh_shape: tuple):
    cfg = ref_get_config(arch)
    shape = REF_SHAPES[shape_name]
    stand_in = SimpleNamespace(axis_names=AXES[len(mesh_shape)], devices=np.empty(mesh_shape, dtype=object))
    plan = ref_make_plan(cfg, shape, stand_in)
    B, max_len, enc_len = _cache_dims(cfg, shape)
    cache = jax.eval_shape(lambda: ref_init_cache(cfg, B, max_len, enc_len=enc_len))
    return (ref_param_specs_by_port_name(cfg, plan.param_specs), plan.act_rules, stripped(plan.batch_rule),
            ref_cache_specs_by_kind(plan.cache_specs_fn(cache)), plan.long_context)


def _cache_dims(cfg, shape):
    """The reference's decode cells' cache: the global batch, the sequence
    (after a VLM's image tokens) and the encoder's frames (``launch/steps.py``)."""
    return shape.global_batch, shape.seq_len + (cfg.vision_tokens or 0), shape.seq_len if cfg.encdec else 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_matches_reference(arch, shape_name, mesh_name):
    mesh_shape = MESHES[mesh_name]
    want_params, want_act, want_batch, want_cache, want_long = reference_plan(arch, shape_name, mesh_shape)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    with fake_world(int(np.prod(mesh_shape))):
        mesh = port_mesh_of(mesh_shape)
        assert tuple(mesh.mesh.shape) == mesh_shape and tuple(mesh.mesh_dim_names) == AXES[len(mesh_shape)]
        plan = make_plan(cfg, shape, mesh)
        placements = plan.placements(plan.param_specs)  # every spec has a DTensor counterpart
    got = {path.replace("/", "."): spec for path, spec in iter_leaves(plan.param_specs)}
    assert all(isinstance(s, PartitionSpec) and s == stripped(s) for s in got.values())
    assert sorted(got) == sorted(want_params)
    bad = {k: (got[k], want_params[k]) for k in got if tuple(got[k]) != want_params[k]}
    assert not bad, bad
    assert all(len(pl) == len(mesh_shape) for _, pl in iter_leaves(placements))  # a list a parameter
    assert plan.act_rules == want_act
    assert stripped(plan.batch_rule) == want_batch and plan.long_context == want_long
    B, max_len, enc_len = _cache_dims(cfg, shape)
    cache = init_cache(cfg, B, max_len, enc_len=enc_len, device="meta")
    specs = plan.cache_specs_fn(cache)
    assert sorted(specs) == sorted(want_cache)
    for key, spec in specs.items():
        assert spec[0] is None and stripped(spec[1:]) == want_cache[key], (key, spec, want_cache[key])


def test_production_plans_shard_what_the_reference_counts():
    """deepseek-7b, qwen2-72b and jamba at train_4k on (16, 16): the
    reference's 12 / 15 / 142 distinct parameter specs (stacked), and every
    port leaf sharded somewhere where its reference leaf is."""
    counts = {}
    for arch in ("deepseek-7b", "qwen2-72b", "jamba-1.5-large-398b"):
        cfg = ref_get_config(arch)
        stand_in = SimpleNamespace(axis_names=("data", "model"), devices=np.empty((16, 16), dtype=object))
        specs = ref_make_plan(cfg, REF_SHAPES["train_4k"], stand_in).param_specs
        counts[arch] = len(jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP)))
    assert counts == {"deepseek-7b": 12, "qwen2-72b": 15, "jamba-1.5-large-398b": 142}


# --------------------------------------------------------------------------- logical_to_pspec
SIZES = {"data": 16, "model": 16, "pod": 2}
PSPEC_CASES = [
    (("embed", "heads", None), (4096, 64, 128), {}),  # divisible dims shard
    (("embed", "heads", None), (5120, 40, 128), {}),  # phi3: 40 heads fall back
    (("vocab", "mlp"), (1600, 1600), {"vocab": "model", "mlp": "model"}),  # first claim wins
    (("batch", None), (256, 10), {}),  # multi-axis batch
    (("batch", "embed", "expert_mlp"), (64, 4096, 1408), {}),
    (("layers", "embed", "kv_heads", "qk_dim"), (30, 4096, 8, 128), {}),
    ((None, None), (3, 5), {}),
]


@pytest.mark.parametrize("sizes", [SIZES, {"data": 16, "model": 16}, {"data": 3}], ids=["pod", "no_pod", "odd"])
@pytest.mark.parametrize("axes,shape,rules", PSPEC_CASES)
def test_logical_to_pspec_matches_reference(axes, shape, rules, sizes):
    got = logical_to_pspec(axes, shape, {**DEFAULT_RULES, **rules}, sizes)
    want = ref_logical_to_pspec(axes, shape, {**REF_DEFAULT_RULES, **rules}, sizes)
    assert isinstance(got, PartitionSpec) and tuple(got) == stripped(want)


def test_default_rules_are_the_reference_rules():
    assert DEFAULT_RULES == REF_DEFAULT_RULES


def test_partition_spec_is_a_tuple_that_pickles():
    import pickle

    spec = PartitionSpec(("pod", "data"), None, "model")
    assert spec == (("pod", "data"), None, "model") and len(PartitionSpec()) == 0
    for entry in (("data",), (), ["pod", "data"]):  # normalised as the reference's
        assert tuple(PartitionSpec(entry)) == tuple(JP(entry))
    assert pickle.loads(pickle.dumps(spec)) == spec and type(pickle.loads(pickle.dumps(spec))) is PartitionSpec
    assert repr(PartitionSpec("data")) == "PartitionSpec('data',)"


# --------------------------------------------------------------------------- meshes and placements
def test_mesh_functions_need_a_process_group_of_the_mesh_size():
    with pytest.raises(RuntimeError, match="world_size=4.*no process group"):
        port_mesh.make_tiny_mesh(device_type="cpu")
    with fake_world(3):
        with pytest.raises(RuntimeError, match="world_size=256.*world_size=3"):
            port_mesh.make_production_mesh(device_type="cpu")
    with fake_world(8):
        mesh = port_mesh.make_tiny_mesh(multi_pod=True, device_type="cpu")
        assert port_mesh.mesh_axis_sizes(mesh) == {"pod": 2, "data": 2, "model": 2}
        assert port_mesh.dp_axes(mesh) == ("pod", "data")
    with fake_world(2):
        mesh = port_mesh.make_tiny_mesh(data=2, model=1, device_type="cpu")
        assert port_mesh.mesh_axis_sizes(mesh) == {"data": 2, "model": 1} and port_mesh.dp_axes(mesh) == ("data",)


def test_mesh_functions_default_to_the_card():
    import inspect

    for fn in (port_mesh.make_production_mesh, port_mesh.make_tiny_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda"


def test_placements_nest_multi_axis_dims_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(8):
        mesh = port_mesh.make_tiny_mesh(multi_pod=True, device_type="cpu")
        assert spec_placements(PartitionSpec(("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0), Shard(2)]
        assert spec_placements(PartitionSpec(None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
        assert spec_placements(PartitionSpec(), mesh) == [Replicate()] * 3


@pytest.mark.parametrize("spec,match", [
    (PartitionSpec(("data", "pod")), "not in the mesh's order"),
    (PartitionSpec(("model", "data"), None), "not in the mesh's order"),
    (PartitionSpec("data", "data"), "named twice"),
    (PartitionSpec("stage"), "not 'stage'"),
])
def test_placements_refuse_what_dtensor_cannot_say(spec, match):
    with fake_world(8):
        mesh = port_mesh.make_tiny_mesh(multi_pod=True, device_type="cpu")
        with pytest.raises(ValueError, match=match):
            spec_placements(spec, mesh)


BLOCKS = """
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch.mesh import make_tiny_mesh
from repro.launch.shardings import make_plan
from repro.models import init_cache, model_defs
from repro.models.params import ParamDef

def blocks(mesh, spec, shape):
    by_device = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out = []
    for idx in np.ndindex(mesh.devices.shape):
        sl = by_device[mesh.devices[idx]]
        starts = [s.start or 0 for s in sl]
        stops = [n if s.stop is None else s.stop for s, n in zip(sl, shape)]
        out.append([list(idx), starts, [b - a for a, b in zip(starts, stops)]])
    return out

out = {}
for multi_pod in (False, True):
    mesh = make_tiny_mesh(multi_pod=multi_pod)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        plan = make_plan(cfg, SHAPES["train_4k"], mesh)
        leaves = jax.tree_util.tree_flatten_with_path(model_defs(cfg), is_leaf=lambda x: isinstance(x, ParamDef))[0]
        specs = jax.tree_util.tree_leaves(plan.param_specs, is_leaf=lambda x: isinstance(x, P))
        rows = {"/".join(str(getattr(p, "key", p)) for p in path): [d.shape, blocks(mesh, s, d.shape)]
                for (path, d), s in zip(leaves, specs)}
        for shape_name in ("decode_32k", "long_500k"):
            dplan = make_plan(cfg, SHAPES[shape_name], mesh)
            shp = SHAPES[shape_name]
            cache = jax.eval_shape(lambda: init_cache(cfg, shp.global_batch, shp.seq_len + (cfg.vision_tokens or 0),
                                                      enc_len=shp.seq_len if cfg.encdec else 0))
            cspecs = dplan.cache_specs_fn(cache)
            for (path, leaf), s in zip(jax.tree_util.tree_flatten_with_path(cache)[0],
                                       jax.tree_util.tree_leaves(cspecs, is_leaf=lambda x: isinstance(x, P))):
                rows[shape_name + ":" + "/".join(str(getattr(p, "key", p)) for p in path)] = [
                    leaf.shape, blocks(mesh, s, leaf.shape)]
        out[f"{int(multi_pod)}:{arch}"] = rows
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference_blocks(tmp_path_factory):
    """Every tiny-mesh device's block of every parameter (train_4k) and
    cache leaf (decode_32k, long_500k) under the reference's plan."""
    path = tmp_path_factory.mktemp("blocks") / "blocks.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", BLOCKS, str(path)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(path.read_text())


def _ref_name(cfg, key: str):
    """A reference leaf path → ``[(port name, stacked)]`` (the port's cache:
    its kind's key, always stacked)."""
    n_prefix, period, repeats = num_layers_in_stack(cfg)
    if ":" in key:
        shape_name, path = key.split(":")
        keys = path.split("/")
        kind = f"cross_{keys[-1]}" if keys[-2] == "cross" else keys[-1]
        return [(f"{shape_name}:{kind}", "blocks" in keys)]
    keys = key.split("/")
    rest = ".".join(keys[2:])
    if keys[0] == "blocks":
        p = int(keys[1][len("pos_"):])
        return [(f"layers.{n_prefix + r * period + p}.{rest}", True) for r in range(repeats)]
    if keys[:2] == ["encoder", "blocks"]:
        return [(f"encoder.layers.{r}.{rest}", True) for r in range(cfg.n_enc_layers)]
    if keys[0].startswith("prefix_"):
        return [(f"layers.{int(keys[0][len('prefix_'):])}." + ".".join(keys[1:]), False)]
    return [(".".join(keys), False)]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["tiny", "tiny_multi_pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_each_rank_holds_the_reference_block(reference_blocks, arch, multi_pod):
    """Every rank of the tiny mesh: the offsets and shape of its block of each
    parameter and cache leaf, from the port's placements, equal the
    reference device's at the same mesh coordinate (a stacked reference leaf
    without its leading layer axis, which every device holds whole)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    cfg = get_config(arch)
    rows = reference_blocks[f"{int(multi_pod)}:{arch}"]
    mesh_shape = (2, 2, 2) if multi_pod else (2, 2)
    world = int(np.prod(mesh_shape))
    want = {}
    for key, (shape, blocks) in rows.items():
        for name, stacked in _ref_name(cfg, key):
            body = shape[1:] if stacked else shape
            per_rank = {}
            for coord, starts, sizes in blocks:
                if stacked:
                    assert starts[0] == 0 and sizes[0] == shape[0], (key, starts, sizes)
                    starts, sizes = starts[1:], sizes[1:]
                per_rank[tuple(coord)] = (tuple(starts), tuple(sizes))
            assert want.setdefault(name, (tuple(body), per_rank)) == (tuple(body), per_rank), name
    checked = 0
    for rank in range(world):
        with fake_world(world, rank):
            mesh = port_mesh_of(mesh_shape)
            coord = tuple(mesh.get_coordinate())
            plan = make_plan(cfg, SHAPES["train_4k"], mesh)
            leaves = {p.replace("/", "."): (spec, tuple(d.shape)) for (p, spec), (_, d) in
                      zip(iter_leaves(plan.param_specs), iter_leaves(model_defs(cfg)))}
            for shape_name in ("decode_32k", "long_500k"):
                shp = SHAPES[shape_name]
                B, max_len, enc_len = _cache_dims(cfg, shp)
                cache = init_cache(cfg, B, max_len, enc_len=enc_len, device="meta")
                dplan = make_plan(cfg, shp, mesh)
                for key, spec in dplan.cache_specs_fn(cache).items():
                    leaves[f"{shape_name}:{key}"] = (spec, tuple(cache[key].shape))
            assert sorted(leaves) == sorted(want)
            for name, (spec, shape) in leaves.items():
                body, per_rank = want[name]
                stack = 1 if ":" in name else 0  # the port's cache leaves carry their layer stack first
                assert shape[stack:] == body, (name, shape, body)
                size, offset = compute_local_shape_and_global_offset(shape, mesh, spec_placements(spec, mesh))
                if stack:
                    assert size[0] == shape[0] and offset[0] == 0, (name, size, offset)
                assert (tuple(offset[stack:]), tuple(size[stack:])) == per_rank[coord], (name, coord)
                checked += 1
    assert checked == world * len(want)


# --------------------------------------------------------------------------- constrain
LOGICAL = [
    ((4, 16, 8, 32), ("batch", "seq", "act_heads", None)),
    ((4, 16, 3, 32), ("batch", "seq", "act_kv_heads", None)),  # 3 heads: model dropped
    ((3, 16, 64), ("batch", "seq", "act_mlp")),  # an odd batch: dp dropped
    ((4, 16, 512), ("batch", "seq", "vocab_logits")),
    ((4, 16, 64), ("batch", "seq", "act_embed")),
]


@pytest.mark.parametrize("shape,logical", LOGICAL)
def test_constrain_asks_for_the_reference_spec(monkeypatch, shape, logical):
    """Under one plan's activation rules, the spec the port's constrain
    redistributes to is the one the reference's passes to
    ``with_sharding_constraint`` (recorded by a stand-in)."""
    asked = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: asked.append(spec) or x)
    for mesh_shape in ((2, 2), (2, 2, 2)):
        stand_in = SimpleNamespace(axis_names=AXES[len(mesh_shape)], devices=np.empty(mesh_shape, dtype=object))
        rules = ref_make_plan(ref_get_config("deepseek-7b"), REF_SHAPES["train_4k"], stand_in).act_rules
        with ref_activation_sharding(rules):
            ref_constrain(jax.numpy.zeros(shape), *logical)
        with fake_world(int(np.prod(mesh_shape))):
            plan = make_plan(get_config("deepseek-7b"), SHAPES["train_4k"], port_mesh_of(mesh_shape))
        assert plan.act_rules == rules
        assert tuple(logical_spec(shape, logical, plan.act_rules)) == tuple(asked[-1])


def test_constrain_redistributes_a_dtensor_and_passes_plain_tensors():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.randn(4, 16, 8, 32)
    assert current_rules() is None and constrain(x, "batch", "seq", "act_heads", None) is x
    with fake_world(4):
        mesh = port_mesh.make_tiny_mesh(device_type="cpu")
        plan = make_plan(get_config("deepseek-7b"), SHAPES["train_4k"], mesh)
        dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        assert constrain(dx, "batch", "seq", "act_heads", None) is dx  # outside any rules: a no-op
        with activation_sharding(plan.act_rules):
            assert current_rules() is plan.act_rules
            assert constrain(x, "batch", "seq", "act_heads", None) is x  # a plain tensor as it is
            out = constrain(dx, "batch", "seq", "act_heads", None)
            assert out.placements == (Shard(0), Shard(2)) and out.to_local().shape == (2, 16, 4, 32)
            odd = constrain(distribute_tensor(torch.randn(3, 16, 3, 32), mesh, [Replicate(), Replicate()]),
                            "batch", "seq", "act_heads", None)
            assert odd.placements == (Replicate(), Replicate())  # nothing divides: replicated
        assert current_rules() is None


def test_rules_leave_the_model_bit_for_bit_as_it_was():
    """The deepseek-7b smoke forward under a plan's rules (plain tensors, as
    every model path passes) equals the forward without them, bit for bit."""
    cfg = get_smoke_config("deepseek-7b")
    model = Transformer(cfg, device="cpu", seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain, aux = model(tokens)
        with fake_world(4):
            plan = make_plan(cfg, SHAPES["train_4k"], port_mesh.make_tiny_mesh(device_type="cpu"))
        with activation_sharding(plan.act_rules):
            ruled, aux2 = model(tokens)
    assert torch.equal(plain, ruled) and torch.equal(aux, aux2)


def test_plan_overrides_reach_the_rules():
    with fake_world(4):
        mesh = port_mesh.make_tiny_mesh(device_type="cpu")
        cfg, shape = get_config("deepseek-7b"), SHAPES["train_4k"]
        plan = make_plan(cfg, shape, mesh, PlanOverrides(fsdp=False, act_rules={"act_embed": "model"}))
    assert plan.param_specs["embed"]["embedding"] == ("model",)  # vocab on model, embed no longer on data
    assert plan.act_rules["act_embed"] == "model"
