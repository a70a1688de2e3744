"""KernelDescs from a real counted step — the §5.3 "DeepBench" path.

The paper validates its stat plumbing on a real DeepBench inference trace:
large kernels whose exact counts are impractical to hand-derive, used as a
sanity check ("our changes do not significantly affect results in larger
benchmarks").  The reference's analog lowers a *real* step of one of the
assigned architectures and reads its compiled cost; the port's counts one
call of a real step (:func:`repro_torch.perf.cost.count_step`: FLOPs and
bytes on fake tensors, the hand-written kernels by formula) and emits
simulator kernels whose aggregate HBM/ICI traffic matches it.  The
multi-stream simulator then runs several copies concurrently — per-stream
counts must sum to the single-stream aggregate × n_streams.

:func:`kernels_from_summary` is the reference's, with only its import
changed; :func:`kernels_from_step` takes the place of its
``kernels_from_compiled``.
"""

from __future__ import annotations

from typing import Callable, List

from ..perf.cost import StepCostSummary, count_step

from .kernel_desc import KernelDesc

__all__ = ["kernels_from_summary", "kernels_from_step"]


def kernels_from_summary(
    summary: StepCostSummary,
    name: str = "hlo_step",
    n_kernels: int = 1,
    addr_base: int = 1 << 30,
) -> List[KernelDesc]:
    """Split one counted step into ``n_kernels`` equal simulator kernels.

    HBM read/write split: the count gives total bytes accessed; we
    attribute output bytes as writes and the rest as reads (arguments +
    intermediate re-reads), which is exact for the streaming model.
    """
    wr = min(summary.output_bytes, summary.hbm_bytes_per_device)
    rd = max(summary.hbm_bytes_per_device - wr, 0.0)
    out: List[KernelDesc] = []
    for i in range(n_kernels):
        out.append(
            KernelDesc(
                name=f"{name}_{i}" if n_kernels > 1 else name,
                flops=summary.flops_per_device / n_kernels,
                hbm_rd_bytes=int(rd / n_kernels),
                hbm_wr_bytes=int(wr / n_kernels),
                ici_bytes=int(summary.collective_wire_bytes_per_device / n_kernels),
                addr_base=addr_base + i * (1 << 28),
            )
        )
    return out


def kernels_from_step(
    fn: Callable,
    *args,
    name: str = "hlo_step",
    n_kernels: int = 1,
) -> List[KernelDesc]:
    """:func:`kernels_from_summary` of one call ``fn(*args)`` counted by
    :func:`~repro_torch.perf.cost.count_step` (on fake copies of ``args``)."""
    return kernels_from_summary(count_step(fn, *args), name, n_kernels)
