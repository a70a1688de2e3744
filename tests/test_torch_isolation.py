"""The port stands alone: it imports neither JAX nor the reference package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "scripts" / "profile_serve_port.py",
    ROOT / "examples" / "torch_quickstart.py",
    ROOT / "examples" / "torch_multistream_serve.py",
    ROOT / "examples" / "torch_sim_paper_repro.py",
]
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro\b(?!_torch))", re.M)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.configs, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.flash_attention, repro_torch.kernels.build\n"
        "import repro_torch.models, repro_torch.models.convert, repro_torch.serve, repro_torch.serve.loadgen\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.models.mamba, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.ckpt, repro_torch.train, repro_torch.train.__main__\n"
        "import repro_torch.sim, repro_torch.sim.scenarios, repro_torch.sim.batch, repro_torch.sim.batched\n"
        "import repro_torch.launch, repro_torch.launch.mesh_shapes, repro_torch.kernels.segment_scatter\n"
        "import repro_torch.launch.mesh, repro_torch.launch.shardings, repro_torch.models.act_sharding\n"
        "import repro_torch.optim.grad_compress, repro_torch.train.pipeline\n"
        "import repro_torch.api, repro_torch.perf, repro_torch.perf.hw, repro_torch.perf.cost\n"
        "import repro_torch.perf.roofline, repro_torch.launch.steps, repro_torch.launch.dryrun\n"
        "import repro_torch.sim.hlo_costs\n"
        "from repro_torch.api import Trainer, ServeEngine, LoadSpec\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120, check=True
    )
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    assert path.exists()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert hits == []


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import repro.core", "from repro.serve import x",
                 "    import jax.numpy as jnp", "from repro import api"):
        assert FORBIDDEN.search(line), line
    for line in ("from repro_torch.core import x", "import repro_torch", "from .jax_free import y"):
        assert not FORBIDDEN.search(line), line
