"""The port's GPipe pipeline (``repro_torch.train.pipeline``) against the
reference's, on the CPU.

The reference runs its 4-stage pipeline on 4 forced host devices in a
subprocess (as ``tests/test_pipeline.py`` does), with that test's inputs
(``jax.random`` weights and microbatches: 8 layers of a 16-wide tanh layer,
6 microbatches of 4), and writes the inputs, its output and the gradient of
``sum(out ** 2)`` by the stage parameters.  The port runs the same inputs
on 4 gloo ranks (one process each, a ``FileStore`` rendezvous under
``tmp_path``), each rank returning the replicated output and its stage's
gradient.  Outputs and gradients agree within 2e-5 (fp32), and both
packages equal the sequential stack within 2e-5.  Every subprocess is given
at most 120 s and killed after.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
TOL = dict(rtol=2e-5, atol=2e-5)
STAGES = 4

REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.train.pipeline import pipeline_forward, split_stages

mesh = jax.make_mesh((4,), ("stage",))
L, D, M, MB = 8, 16, 6, 4
key = jax.random.PRNGKey(0)
W = jax.random.normal(key, (L, D, D)) * (D ** -0.5)
b = jax.random.normal(jax.random.fold_in(key, 1), (L, D)) * 0.1
params = {"w": W, "b": b}

def layer_fn(lp, x):
    return jnp.tanh(x @ lp["w"] + lp["b"])

xs = jax.random.normal(jax.random.fold_in(key, 2), (M, MB, D))

def seq(p, x):
    for i in range(L):
        x = layer_fn({"w": p["w"][i], "b": p["b"][i]}, x)
    return x

stage_params = split_stages(params, 4)
run = lambda p, x: pipeline_forward(p, x, layer_fn, mesh, "stage")
with mesh:
    out = jax.jit(run)(stage_params, xs)
    g = jax.jit(jax.grad(lambda p, x: jnp.sum(run(p, x) ** 2)))(stage_params, xs)
ref = jax.vmap(lambda x: seq(params, x))(xs)
np.savez(sys.argv[1], w=np.asarray(W), b=np.asarray(b), xs=np.asarray(xs), out=np.asarray(out),
         sequential=np.asarray(ref), gw=np.asarray(g["w"]), gb=np.asarray(g["b"]))
"""

PORT = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.train.pipeline import pipeline_forward, split_stages

rank, world, store, inputs, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
try:
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    z = np.load(inputs)
    params = {"w": torch.from_numpy(z["w"]).requires_grad_(), "b": torch.from_numpy(z["b"]).requires_grad_()}
    xs = torch.from_numpy(z["xs"])

    def layer_fn(lp, x):
        return torch.tanh(x @ lp["w"] + lp["b"])

    stage_params = split_stages(params, world)
    out = pipeline_forward(stage_params, xs, layer_fn, mesh, "stage")
    (out ** 2).sum().backward()
    s = mesh.get_local_rank("stage")
    per = z["w"].shape[0] // world
    np.savez(out_path, out=out.detach().numpy(), stage=s, gw=params["w"].grad[s * per:(s + 1) * per].numpy(),
             gb=params["b"].grad[s * per:(s + 1) * per].numpy(),
             gw_elsewhere=np.delete(params["w"].grad.numpy(), np.s_[s * per:(s + 1) * per], axis=0))
finally:
    dist.destroy_process_group()
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", **extra)
    return env


def _run_all(cmds, env):
    """Start every command, wait for all within TIMEOUT_S, kill the rest;
    returns their (returncode, stderr)."""
    procs = [subprocess.Popen(c, env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run (4 forced host devices) and the port's 4 gloo ranks."""
    tmp = tmp_path_factory.mktemp("pipeline")
    ref_path = tmp / "reference.npz"
    [(rc, err)] = _run_all([[sys.executable, "-c", REFERENCE, str(ref_path)]],
                           _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={STAGES}"))
    assert rc == 0, err[-3000:]
    cmds = [[sys.executable, "-c", PORT, str(r), str(STAGES), str(tmp / "store"), str(ref_path),
             str(tmp / f"rank{r}.npz")] for r in range(STAGES)]
    for rc, err in _run_all(cmds, _env()):
        assert rc == 0, err[-3000:]
    ref = dict(np.load(ref_path))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(STAGES)]
    return ref, ranks


def test_reference_pipeline_equals_the_sequential_stack(runs):
    ref, _ = runs
    np.testing.assert_allclose(ref["out"], ref["sequential"], **TOL)


def test_four_gloo_stages_match_the_reference_output(runs):
    ref, ranks = runs
    for r in ranks:  # replicated: every rank holds the whole output
        np.testing.assert_allclose(r["out"], ref["out"], **TOL)
        np.testing.assert_allclose(r["out"], ref["sequential"], **TOL)


def test_four_gloo_stages_match_the_reference_gradients(runs):
    ref, ranks = runs
    assert sorted(int(r["stage"]) for r in ranks) == list(range(STAGES))
    for r in ranks:
        s = int(r["stage"])
        np.testing.assert_allclose(r["gw"], ref["gw"][s], **TOL)
        np.testing.assert_allclose(r["gb"], ref["gb"][s], **TOL)
        assert not r["gw_elsewhere"].any()  # a rank's gradient reaches only its own stage's rows


def test_pipeline_gradients_equal_the_sequential_stack(runs):
    """The reference's gradient (and so the port's) is the sequential
    stack's: autograd through the plain loop, in torch, on the same inputs."""
    ref, ranks = runs
    w = torch.from_numpy(ref["w"]).requires_grad_()
    b = torch.from_numpy(ref["b"]).requires_grad_()
    x = torch.from_numpy(ref["xs"])
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i] + b[i])
    (x ** 2).sum().backward()
    per = w.shape[0] // STAGES
    np.testing.assert_allclose(ref["gw"].reshape(w.shape), w.grad.numpy(), **TOL)
    for r in ranks:
        s = int(r["stage"])
        np.testing.assert_allclose(r["gw"], w.grad[s * per:(s + 1) * per].numpy(), **TOL)
        np.testing.assert_allclose(r["gb"], b.grad[s * per:(s + 1) * per].numpy(), **TOL)


def test_split_stages_matches_the_reference():
    from repro.train.pipeline import split_stages as ref_split
    from repro_torch.train.pipeline import split_stages

    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    got = split_stages({"w": torch.from_numpy(x)}, 4)["w"]
    assert got.shape == (4, 2, 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_split({"w": x}, 4)["w"]))
    with pytest.raises(ValueError, match="do not split"):
        split_stages({"w": torch.from_numpy(x)}, 3)


def test_one_stage_pipeline_is_the_sequential_stack_bit_for_bit(tmp_path):
    """A one-rank gloo group: one stage sends nothing, and the output is the
    layers applied microbatch by microbatch, bit for bit."""
    code = """
import sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.train.pipeline import pipeline_forward, split_stages
dist.init_process_group("gloo", init_method="file://" + sys.argv[1], rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
g = torch.Generator().manual_seed(0)
w, b, xs = torch.randn(3, 8, 8, generator=g) / 3, torch.randn(3, 8, generator=g), torch.randn(5, 2, 8, generator=g)
fn = lambda lp, x: torch.tanh(x @ lp["w"] + lp["b"])
out = pipeline_forward(split_stages({"w": w, "b": b}, 1), xs, fn, mesh, "stage")
want = []
for x in xs:
    for i in range(3):
        x = fn({"w": w[i], "b": b[i]}, x)
    want.append(x)
assert torch.equal(out, torch.stack(want)), (out - torch.stack(want)).abs().max()
dist.destroy_process_group()
print("ONE_STAGE_OK")
"""
    [(rc, err)] = _run_all([[sys.executable, "-c", code, str(tmp_path / "store")]], _env())
    assert rc == 0, err[-3000:]
