"""Cost and roofline tooling of the port: the H100's constants (:mod:`.hw`),
a step's counted cost and its device profile (:mod:`.cost`, the counterpart
of the reference's ``perf/hlo.py`` and ``perf/hlo_cost_model.py``), and the
three-term roofline (:mod:`.roofline`)."""

from .cost import StepCostSummary, count_cell, count_step, device_profile, kernel_costs
from .hw import H100_PCIE, H100_SXM, Chip, chip_for
from .roofline import RooflineTerms, model_flops, roofline_from_summary

__all__ = [
    "Chip", "H100_SXM", "H100_PCIE", "chip_for",
    "StepCostSummary", "count_step", "count_cell", "kernel_costs", "device_profile",
    "RooflineTerms", "roofline_from_summary", "model_flops",
]
