"""Hardware constants for the roofline — NVIDIA H100 (the port's target).

The reference's ``perf/hw.py`` holds one part, the TPU v5e its harness
targets; the port runs on an H100 and holds its two boards, each from
NVIDIA's H100 datasheet (dense tensor-core rates, without sparsity):

* SXM5: 989 TFLOP/s bf16, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s of
  HBM3, 80 GB, NVLink 900 GB/s a GPU over 18 links;
* PCIe: 756 TFLOP/s bf16, 51 TFLOP/s fp32, 2.0 TB/s of HBM2e, 80 GB,
  NVLink bridge 600 GB/s a GPU (the datasheet's figure for a pair).

:func:`chip_for` picks the board from the name ``nvidia-smi`` gives.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Chip", "H100_SXM", "H100_PCIE", "chip_for"]


@dataclass(frozen=True)
class Chip:
    name: str
    peak_bf16_flops: float  # FLOP/s, dense tensor cores
    hbm_bw: float  # B/s
    ici_link_bw: float  # B/s per link (NVLink on an H100)
    hbm_bytes: int  # capacity per chip
    peak_fp32_flops: float = 0.0  # FLOP/s on the CUDA cores (no tensor cores, no TF32)


H100_SXM = Chip(
    name="h100_sxm",
    peak_bf16_flops=989e12,
    hbm_bw=3.35e12,
    # NVLink 4: 900 GB/s a GPU (both directions) over 18 links, 50 GB/s a link (H100 datasheet)
    ici_link_bw=900e9 / 18,
    hbm_bytes=80 * 10**9,
    peak_fp32_flops=67e12,
)

H100_PCIE = Chip(
    name="h100_pcie",
    peak_bf16_flops=756e12,
    hbm_bw=2.0e12,
    # NVLink bridge: 600 GB/s a GPU (both directions) over its 12 links, 50 GB/s a link (H100 datasheet)
    ici_link_bw=600e9 / 12,
    hbm_bytes=80 * 10**9,
    peak_fp32_flops=51e12,
)


def chip_for(smi_name: str) -> Chip:
    """The board that ``nvidia-smi --query-gpu=name`` (or a line of
    ``name,power.limit``) names: the PCIe card where the name says so, the
    SXM part otherwise."""
    return H100_PCIE if "PCIe" in smi_name else H100_SXM
