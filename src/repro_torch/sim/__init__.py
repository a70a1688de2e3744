"""Discrete-event TPU timing simulator — the GPGPU-Sim analog.

Hosts the paper's per-stream stat tracking at cycle granularity: concurrent
streams of kernels share VMEM/HBM/ICI/MXU models, every access event carries
its stream id, and the executor maintains the per-stream ("tip") and
baseline ("clean", with the same-cycle undercount) stat views side by side.

A copy of the reference package's simulator, file for file with only its
imports changed, except that ``SimConfig.array_backend`` defaults to
``"torch"`` (the stat landings run through the CUDA kernels of
:mod:`repro_torch.kernels.segment_scatter`), the batch runner's pool spawns
its workers once CUDA is initialised, its pooled sweep maps one job per
chunk (the reference's larger chunks make ``imap`` return a generator with
no ``next(timeout=...)``, so its pooled sweep fails its first job), and
``hlo_costs`` makes KernelDescs from a real step counted by
:mod:`repro_torch.perf.cost` (``kernels_from_step``, in place of the
reference's ``kernels_from_compiled``).
"""

from .kernel_desc import Access, KernelDesc, LINE_SIZE, pointer_chase_trace, streaming_trace
from .resources import Bandwidth, Compute, HW_V5E, VMEMCache
from .executor import SimConfig, SimResult, TPUSimulator
from .scenarios import (
    Launch,
    ORACLE_KEYS,
    ScenarioInstance,
    ScenarioSpec,
    build,
    divergent_draws,
    get_spec,
    list_scenarios,
    scenario,
    space_draws,
    value_only_draws,
)
from .batch import BatchJob, BatchResult, BatchRunner, run_job, same_shape_jobs, sweep_jobs
from .topology import (
    DeviceTopology,
    all_reduce_ring,
    all_reduce_tree,
    all_to_all,
    expected_link_bytes,
    pipeline_send,
)
from .microbench import (
    deepbench_like_workload,
    l2_lat_expected_counts,
    l2_lat_multistream,
    mixed_stream_workload,
)
from .hlo_costs import kernels_from_step, kernels_from_summary

__all__ = [
    "Access",
    "KernelDesc",
    "LINE_SIZE",
    "pointer_chase_trace",
    "streaming_trace",
    "Bandwidth",
    "Compute",
    "HW_V5E",
    "VMEMCache",
    "SimConfig",
    "SimResult",
    "TPUSimulator",
    "Launch",
    "ORACLE_KEYS",
    "ScenarioInstance",
    "ScenarioSpec",
    "scenario",
    "build",
    "get_spec",
    "list_scenarios",
    "space_draws",
    "divergent_draws",
    "value_only_draws",
    "DeviceTopology",
    "all_reduce_ring",
    "all_reduce_tree",
    "all_to_all",
    "pipeline_send",
    "expected_link_bytes",
    "BatchJob",
    "BatchResult",
    "BatchRunner",
    "run_job",
    "same_shape_jobs",
    "sweep_jobs",
    "deepbench_like_workload",
    "l2_lat_expected_counts",
    "l2_lat_multistream",
    "mixed_stream_workload",
    "kernels_from_step",
    "kernels_from_summary",
]
