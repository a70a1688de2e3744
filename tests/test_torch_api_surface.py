"""The port's public facade (``repro_torch``, ``repro_torch.api``) against the
reference's (``repro``, ``repro.api``), as ``tests/test_api_surface.py``
snapshots the reference's surface: the same ``__all__``, the same lazy
names kept out of an eager import, the same signatures and per-stream
counts from ``simulate`` and ``sweep`` (the port's landings on
``array_backend="torch:cpu"``, the kernels' plain versions, the
reference's on NumPy), exactly.  Then each ``examples/torch_*.py`` runs
with ``--device cpu`` at smoke size in a subprocess under its own timeout;
``torch_quickstart`` and ``torch_sim_paper_repro`` print the per-stream
counts the reference's examples print.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro
import repro.api
import repro_torch
import repro_torch.api
from repro.sim.batch import BatchJob as RefBatchJob
from repro_torch.sim.batch import BatchJob

ROOT = Path(__file__).resolve().parents[1]
CPU = {"array_backend": "torch:cpu"}
ENV = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/root"),
       "JAX_PLATFORMS": "cpu"}


@pytest.mark.parametrize("port,ref", [(repro_torch, repro), (repro_torch.api, repro.api)],
                         ids=["package", "api"])
def test_surface_is_the_references(port, ref):
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__ if name not in port.__dict__.get("_LAZY", {}))


def test_lazy_names_stay_out_of_an_eager_import():
    code = ("import sys, repro_torch, repro_torch.api as api\n"
            "heavy = ('repro_torch.train.trainer', 'repro_torch.serve.engine', 'repro_torch.serve.loadgen',\n"
            "         'repro_torch.models')\n"
            "print(sorted(m for m in heavy if m in sys.modules), sorted(n for n in api._LAZY if n in vars(api)))\n"
            "from repro_torch.api import Trainer, ServeEngine, LoadSpec\n"
            "print(Trainer.__module__, ServeEngine.__name__, LoadSpec.__module__)\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout.splitlines()
    assert out[0] == "[] []"
    assert out[1] == "repro_torch.train.trainer Engine repro_torch.serve.loadgen"
    assert sorted(repro_torch.api._LAZY) == sorted(repro.api._LAZY)


def _per_stream(frame):
    rows, cols, table = frame.filter(access_type="GLOBAL_ACC_R").pivot(rows="stream", cols="outcome")
    return [(str(r), dict(zip(cols, map(int, row)))) for r, row in zip(rows, table)]


@pytest.mark.parametrize("params", [dict(n_streams=4, n_loads=256), dict(n_streams=4, n_loads=64, serialize=True)],
                         ids=["concurrent", "serialized"])
def test_simulate_gives_the_references_counts(params):
    got = repro_torch.simulate("l2_lat", config=CPU, **params)
    want = repro.simulate("l2_lat", **params)
    assert got.signature() == want.signature()
    assert _per_stream(got.frame) == _per_stream(want.frame)
    assert got.check_oracle()["ok"] and want.check_oracle()["ok"]


def test_session_gives_the_references_counts():
    def drive(api, **cfg):
        s = api.Session(**cfg)
        s.stream("prefetch", priority=1)
        s.launch("prefetch", rd_bytes=1 << 16, record="chunk0")
        s.launch("compute", flops=2e6, wr_bytes=1 << 12, wait="chunk0")
        return s.run()

    got, want = drive(repro_torch.api, **CPU), drive(repro.api)
    assert got.signature() == want.signature() and got.stream_ids == want.stream_ids


def test_sweep_gives_the_references_signature():
    draws = [("l2_lat", {"n_streams": 2, "n_loads": 32}), ("deepbench", {"n_streams": 2, "repeats": 2})]
    got = repro_torch.sweep(jobs=[BatchJob.make(s, p, config=dict(CPU)) for s, p in draws], parallel=False)
    want = repro.sweep(jobs=[RefBatchJob.make(s, p) for s, p in draws], parallel=False)
    assert got.signature() == want.signature()
    assert got.failures() == want.failures() == []


def _example(name, *args, timeout):
    return subprocess.run([sys.executable, f"examples/{name}", *args], env=ENV, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def test_sim_paper_repro_prints_the_references_output():
    got = _example("torch_sim_paper_repro.py", "--device", "cpu", timeout=120)
    want = _example("sim_paper_repro.py", timeout=120)
    assert got.returncode == want.returncode == 0, got.stderr[-2000:]
    assert got.stdout == want.stdout


def test_quickstart_prints_the_references_lanes():
    """The per-stream lanes (steps and tokens of the train and eval streams)
    are the reference's; the losses (other weights) and the bytes (the
    port's unfused dispatch count against XLA's compiled one) are not
    compared."""
    args = ("--steps", "5", "--batch", "2", "--seq", "16")
    got = _example("torch_quickstart.py", *args, "--device", "cpu", timeout=240)
    want = _example("quickstart.py", *args, timeout=240)
    assert got.returncode == want.returncode == 0, got.stderr[-2000:]
    lanes = lambda out: re.findall(r"stream (\d+): steps=(\d+) tokens=(\d+)", out)  # noqa: E731
    assert lanes(got.stdout) == lanes(want.stdout) == [("1", "5", "160"), ("2", "1", "0")]
    assert "per-lane HBM bytes" in got.stdout


def test_multistream_serve_runs_and_its_two_read_paths_agree():
    got = _example("torch_multistream_serve.py", "--device", "cpu", "--requests", "4", timeout=240)
    assert got.returncode == 0, got.stderr[-2000:]
    assert "invariant Σ per-stream (legacy accessors) == aggregate (frame): True" in got.stdout
    assert len(re.findall(r"^  req\d ", got.stdout, re.M)) == 4
