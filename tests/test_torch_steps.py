"""The port's step factory and dry run (``repro_torch.launch.steps``,
``repro_torch.launch.dryrun``) against the reference's ``launch/steps.py``.

For every config × applicable shape × mesh ((2, 2), (16, 16), (2, 16, 16)):
the step name, donation, chips, model FLOPs, the train cells' microbatches
and every abstract input (shape and dtype) equal the reference's.  The
port's cells are built on a ``DeviceMesh`` over torch's ``fake`` process
group (any world size in one process); the reference's on a stand-in mesh
(axis names and a devices array), as ``tests/test_torch_distribution.py``
holds ``make_plan``, with ``NamedSharding`` stubbed where its
``_batch_struct`` wraps the batch rule (the abstract shapes do not depend
on it).  The port keeps one parameter a layer where the reference stacks
the layers of its decoder (and encoder) on a leading axis, and one cache
stack per kind of layer where the reference keeps one per superblock
position: parameters are held leaf for leaf after stacking, the cache and
the optimizer state by the elements they hold of each dtype.  Exact
equality everywhere (no tolerance: shapes, dtypes and counts).

The dry run runs as ``python -m repro_torch.launch.dryrun`` in a
subprocess, as ``tests/test_dryrun_subprocess.py`` runs the reference's.
"""

import contextlib
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.steps as ref_steps
from repro.configs import SHAPES as REF_SHAPES, applicable_shapes, get_config as ref_get_config
from repro.models.transformer import num_layers_in_stack
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config, get_smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps
from repro_torch.launch.shardings import PlanOverrides

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"tiny": (2, 2), "production": (16, 16), "multi_pod": (2, 16, 16)}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
CELLS = [(a, s, m) for a in ARCH_IDS for s in applicable_shapes(ref_get_config(a)) for m in MESHES]


@contextlib.contextmanager
def fake_world(size: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def port_mesh_of(shape):
    if shape == (16, 16):
        return port_mesh.make_production_mesh(device_type="cpu")
    if shape == (2, 16, 16):
        return port_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    return port_mesh.make_tiny_mesh(multi_pod=len(shape) == 3, data=shape[-2], model=shape[-1], device_type="cpu")


def port_cell(arch, shape, mesh_shape, **kw):
    with fake_world(int(np.prod(mesh_shape))):
        return steps.build_cell(arch, get_config(arch), shape, port_mesh_of(mesh_shape), **kw)


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "")


def _leaves(tree, prefix=""):
    """``{dotted path: leaf}`` of a nested dict (a jax pytree's dicts too)."""
    if isinstance(tree, dict):
        out = {}
        for k, sub in tree.items():
            out.update(_leaves(sub, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _by_dtype(leaves) -> dict:
    """Elements of each dtype among ``leaves``."""
    out = {}
    for t in leaves:
        name = _dtype_name(t.dtype)
        out[name] = out.get(name, 0) + int(np.prod(t.shape))
    return out


def ref_params_by_port_name(cfg, params) -> dict:
    """The reference's abstract parameters as ``{port name: (shape, dtype)}``:
    a stacked leaf gives each of its layers its shape without the layer axis."""
    n_prefix, period, repeats = num_layers_in_stack(cfg)
    out = {}
    for path, leaf in _leaves(params).items():
        keys = path.split(".")
        shape, dtype = tuple(leaf.shape), _dtype_name(leaf.dtype)
        if keys[0] == "blocks" and keys[1].startswith("pos_"):
            p = int(keys[1][len("pos_"):])
            assert shape[0] == repeats, (path, shape)
            for r in range(repeats):
                out[f"layers.{n_prefix + r * period + p}." + ".".join(keys[2:])] = (shape[1:], dtype)
        elif keys[:2] == ["encoder", "blocks"]:
            for r in range(cfg.n_enc_layers):
                out[f"encoder.layers.{r}." + ".".join(keys[2:])] = (shape[1:], dtype)
        elif keys[0].startswith("prefix_"):
            out[f"layers.{int(keys[0][len('prefix_'):])}." + ".".join(keys[1:])] = (shape, dtype)
        else:
            out[path] = (shape, dtype)
    return out


@lru_cache(maxsize=None)
def reference_cell(arch: str, shape_name: str, mesh_shape: tuple):
    """The reference's cell on a stand-in mesh, and its data-parallel size."""
    stand_in = SimpleNamespace(axis_names=AXES[len(mesh_shape)], devices=np.empty(mesh_shape, dtype=object))
    patched = ref_steps.NamedSharding
    ref_steps.NamedSharding = lambda mesh, spec: None  # the abstract batch's sharding; shapes do not read it
    try:
        cell = ref_steps.build_cell(arch, ref_get_config(arch), REF_SHAPES[shape_name], stand_in)
    finally:
        ref_steps.NamedSharding = patched
    sizes = dict(zip(stand_in.axis_names, mesh_shape))
    dp = int(np.prod([sizes[a] for a in cell.plan.dp]))
    return cell, dp


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELLS, ids=["-".join(c) for c in CELLS])
def test_cell_matches_reference(arch, shape_name, mesh_name):
    mesh_shape = MESHES[mesh_name]
    ref, dp = reference_cell(arch, shape_name, mesh_shape)
    cell = port_cell(arch, SHAPES[shape_name], mesh_shape)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert (cell.step_name, cell.donate_argnums, cell.chips) == (ref.step_name, ref.donate_argnums, ref.chips)
    assert cell.model_flops == ref.model_flops == ref_steps.model_flops_for_cell(ref_cfg, REF_SHAPES[shape_name])
    assert steps.model_flops_for_cell(cfg, SHAPES[shape_name]) == ref.model_flops
    assert steps.default_microbatches(cfg, SHAPES[shape_name], dp) == ref_steps.default_microbatches(
        ref_cfg, REF_SHAPES[shape_name], dp)
    assert len(cell.args) == len(ref.args) == len(cell.in_shardings)
    # parameters, leaf for leaf
    got = {name: (tuple(t.shape), _dtype_name(t.dtype)) for name, t in _leaves(cell.args[0]).items()}
    assert got == ref_params_by_port_name(ref_cfg, ref.args[0])
    assert all(t.device.type == "meta" for t in _leaves(cell.args[0]).values())
    if cell.step_name == "train_step":
        assert cell.tcfg.microbatches == ref_steps.default_microbatches(ref_cfg, REF_SHAPES[shape_name], dp)
        ref_opt, opt = ref.args[1], cell.args[1]
        for key in ("m", "v"):
            assert _by_dtype(opt[key].values()) == _by_dtype(jax.tree_util.tree_leaves(ref_opt[key]))
            assert sorted(opt[key]) == sorted(got)
        # the step counter: a scalar in both; the port's AdamW keeps it as an int64 CPU tensor
        # (optim/adamw.py adamw_init), the reference's as int32 — the one dtype that differs
        assert tuple(opt["step"].shape) == tuple(ref_opt["step"].shape) == ()
        assert (_dtype_name(opt["step"].dtype), _dtype_name(ref_opt["step"].dtype)) == ("int64", "int32")
    if cell.step_name in ("train_step", "prefill_step"):
        batch, ref_batch = cell.args[-1], ref.args[-1]
        assert {k: (tuple(t.shape), _dtype_name(t.dtype)) for k, t in batch.items()} == {
            k: (tuple(t.shape), _dtype_name(t.dtype)) for k, t in ref_batch.items()}
    else:
        cache, ref_cache = cell.args[1], ref.args[1]
        assert _by_dtype(cache.values()) == _by_dtype(jax.tree_util.tree_leaves(ref_cache))
        for got_io, want_io in zip(cell.args[2:], ref.args[2:]):
            assert (tuple(got_io.shape), _dtype_name(got_io.dtype)) == (tuple(want_io.shape),
                                                                         _dtype_name(want_io.dtype))


def test_levers_carry_and_a_foreign_one_raises():
    """The reference's levers the port honours reach the cell's config and
    train config; a decode loop the port does not run raises, naming it."""
    shape = ShapeConfig("train_small", 64, 8, "train")
    cell = port_cell("mamba2-130m", shape, (2, 2), overrides=PlanOverrides(
        remat="full", microbatches=2, ssd_chunk=64, accum_dtype="bfloat16", kv_cache_dtype="float32"))
    assert (cell.cfg.remat, cell.cfg.ssm.chunk, cell.cfg.kv_cache_dtype) == ("full", 64, "float32")
    assert (cell.tcfg.microbatches, cell.tcfg.accum_dtype) == (2, "bfloat16")
    assert port_cell("deepseek-7b", shape, (2, 2), overrides=PlanOverrides(decode_loop="inplace")).cfg.decode_loop \
        == "inplace"
    with pytest.raises(ValueError, match="decode_loop"):
        port_cell("deepseek-7b", shape, (2, 2), overrides=PlanOverrides(decode_loop="scan"))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_materialize_gives_the_abstract_inputs_and_the_model_init(kind):
    """``materialize`` fills every abstract input with a real tensor of its
    shape and dtype; the parameters are the ones ``Transformer`` draws from
    the same seed; the cell's step runs on them."""
    from repro_torch.models import Transformer, param_tree

    arch = "deepseek-7b"
    with fake_world(1):
        mesh = port_mesh.make_tiny_mesh(data=1, model=1, device_type="cpu")
        cell = steps.build_cell(arch, get_smoke_config(arch), ShapeConfig("s", 16, 2, kind), mesh)
    real = steps.materialize(cell, "cpu", seed=5)
    flat = lambda tree: _leaves(tree) if isinstance(tree, dict) else {"": tree}  # noqa: E731
    for abstract, got in zip(cell.args, real):
        a, g = flat(abstract), flat(got)
        assert sorted(a) == sorted(g)
        assert all(tuple(a[k].shape) == tuple(g[k].shape) and a[k].dtype == g[k].dtype for k in a)
    want = _leaves(param_tree(Transformer(cell.cfg, device="cpu", seed=5)))
    assert all(torch.equal(t, want[name]) for name, t in _leaves(real[0]).items())
    out = cell.fn(*real)
    logits = out[2]["loss"] if kind == "train" else out[0]
    assert torch.isfinite(logits).all()


ENV = {
    "PYTHONPATH": "src",
    "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
    "HOME": os.environ.get("HOME", "/root"),
}


@pytest.mark.parametrize("arch,mesh,chips,step", [("deepseek-7b", "tiny", 4, "serve_step"),
                                                  ("mamba2-130m", "tiny2", 8, "serve_step")])
def test_dryrun_subprocess_writes_the_record(tmp_path, arch, mesh, chips, step):
    """``python -m repro_torch.launch.dryrun`` on the CPU, as the reference's
    ``tests/test_dryrun_subprocess.py`` runs its own: the record's keys,
    status, step, chips, counted FLOPs and per-rank memory."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", "decode_32k",
         "--mesh", mesh, "--out", str(tmp_path), "--quiet"],
        capture_output=True, text=True, timeout=300, env=ENV, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    art = json.load(open(tmp_path / f"{arch}__decode_32k__{mesh}.json"))
    assert {"arch", "shape", "mesh", "step", "status", "chips", "model_flops_total", "lower_s", "compile_s",
            "summary", "loop_aware", "memory", "wall_s"} <= set(art)
    assert art["status"] == "ok" and art["step"] == step and art["chips"] == chips
    assert art["summary"]["flops_per_device"] > 0 and art["loop_aware"]["flops"] > 0
    assert art["memory"]["peak_bytes_est"] > 0 and art["memory"]["temp_bytes"] == "not counted"
    assert "XLA_FLAGS" not in proc.stdout + proc.stderr
