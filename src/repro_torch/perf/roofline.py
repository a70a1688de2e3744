"""Three-term roofline model from a step's counted cost.

The reference's ``perf/roofline.py`` over :class:`~.cost.StepCostSummary`
and the H100 (:mod:`.hw`).  Per (architecture × shape × mesh):

    compute term    = flops_per_device            / peak_FLOP/s
    memory term     = hbm_bytes_per_device        / HBM_bw
    collective term = collective_wire_bytes_per_device / link_bw

The *dominant* term lower-bounds step time.  ``useful_flops_ratio`` is
MODEL_FLOPS / counted FLOPs; ``roofline_fraction`` is the useful model
compute time over the dominant term, on the chip the terms were built
with (the reference's hard-codes its TPU's peak there, whatever chip it
was given: a stated difference).
"""

from __future__ import annotations

from dataclasses import dataclass

from .cost import StepCostSummary
from .hw import H100_SXM, Chip

__all__ = ["RooflineTerms", "roofline_from_summary", "model_flops"]


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_total: float  # 6·N·D (train) or 2·N·D (inference), all chips
    hlo_flops_total: float  # the counted FLOPs, all chips (the reference's name kept)
    chip: Chip = H100_SXM

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundancy waste."""
        if self.hlo_flops_total <= 0:
            return 0.0
        return self.model_flops_total / self.hlo_flops_total

    @property
    def roofline_fraction(self) -> float:
        """useful model compute time / achievable step time (≤ 1), at the
        peak of :attr:`chip`."""
        if self.bound_s <= 0:
            return 0.0
        chips_peak = self.chips * self.chip.peak_bf16_flops
        return (self.model_flops_total / chips_peak) / self.bound_s

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_total": self.model_flops_total,
            "hlo_flops_total": self.hlo_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_from_summary(
    summary: StepCostSummary,
    *,
    arch: str,
    shape: str,
    mesh: str,
    chips: int,
    model_flops_total: float,
    chip: Chip = H100_SXM,
) -> RooflineTerms:
    return RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh,
        chips=chips,
        compute_s=summary.flops_per_device / chip.peak_bf16_flops,
        memory_s=summary.hbm_bytes_per_device / chip.hbm_bw,
        collective_s=summary.collective_wire_bytes_per_device / chip.ici_link_bw,
        model_flops_total=model_flops_total,
        hlo_flops_total=summary.flops_per_device * chips,
        chip=chip,
    )


def model_flops(n_active_params: float, tokens: float, *, train: bool) -> float:
    """6·N·D for training, 2·N·D for inference forward (N = *active* params
    for MoE — experts not routed to do no useful work)."""
    return (6.0 if train else 2.0) * n_active_params * tokens
