"""repro_torch — the PyTorch/CUDA port of per-stream stat tracking, for NVIDIA Hopper.

Reproduction of "Integrating Per-Stream Stat Tracking into Accel-Sim"
(Qiao, Su, Sinclair; 2023) as production observability infrastructure,
ported from the JAX package ``repro`` (the reference, which tests hold the
port against on the CPU).  Subpackages mirror the reference's module names:

* :mod:`repro_torch.core` — the paper's contribution: the per-stream stats
  core, its query layer and report sinks;
* :mod:`repro_torch.sim` — the discrete-event simulator it instruments, with
  its scenario registry and batch runner, whose stat landings run through
  the CUDA segment-scatter kernel (``SimConfig.array_backend = "torch"``),
  and simulator kernels from a real counted step (``sim.hlo_costs``);
* :mod:`repro_torch.configs` — the ten assigned architectures and their
  reduced smoke configs, with torch dtypes;
* :mod:`repro_torch.kernels` — hand-written CUDA kernels for ``sm_90a``
  (flash attention forward and backward, the SSD scan, the segment
  scatter) beside their plain versions;
* :mod:`repro_torch.models` — every family's model (dense GQA, MoE with GQA
  or MLA, pure SSM, the hybrid, enc-dec, prefix-LM), its sharding specs and
  activation rules, and weight conversion from the reference;
* :mod:`repro_torch.serve` — the continuous-batching server and its load
  generator;
* :mod:`repro_torch.optim`, :mod:`repro_torch.data`, :mod:`repro_torch.ckpt`,
  :mod:`repro_torch.train` — AdamW, the schedule and int8 gradient
  compression, the data pipeline, checkpoints, the training loop
  (``python -m repro_torch.train``) and the GPipe pipeline;
* :mod:`repro_torch.launch` — meshes over ``torch.distributed``, the
  sharding plan, the step factory (``build_cell``) and the dry run
  (``python -m repro_torch.launch.dryrun``);
* :mod:`repro_torch.perf` — the H100's constants, a step's counted cost and
  device profile, and the roofline.

Public API — the stable facade lives in :mod:`repro_torch.api`::

    from repro_torch import simulate, sweep, Session, StatsFrame

    res = simulate("l2_lat", n_streams=4, n_loads=256)
    res.frame.filter(stream="stream_2", outcome="MSHR_HIT").sum()

Names in this module's ``__all__`` (and ``repro_torch.api.__all__``) are the
reference's and follow its semantic versioning against :data:`__version__`;
``tests/test_torch_api_surface.py`` snapshots the surface against the
reference's.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (the simulator: ``array_backend="torch:cpu"`` or
``"numpy"``).  Importing the package builds no kernel and imports neither
JAX nor the reference package.
"""

from . import api
from .api import RunResult, Session, simulate, sweep
from .core.query import EventJournal, QueryError, StatsFrame

__all__ = [
    "__version__",
    "api",
    "simulate",
    "sweep",
    "Session",
    "RunResult",
    "StatsFrame",
    "EventJournal",
    "QueryError",
]

__version__ = "1.1.0"
