"""Flash attention: the hand-written CUDA kernel, its wrapper and its plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` (the
Pallas TPU kernel ``_flash_kernel``).  The kernel is
``csrc/flash_attention.cu``, built for ``sm_90a`` by :mod:`.build` at its
first launch and called through ``ctypes``.

What bounds it on an H100: the work itself (two products of 2·S²·D per head
pair, halved by causality) is bound by the bf16 tensor-core rate, but this
first kernel runs both products as fp32 FMAs on the CUDA cores, so it is
bound by the fp32 FMA rate and by shared-memory reads.  Its design keeps the
online softmax's state in registers, stages each K/V tile once in shared
memory for all 64 query rows of a block, reads GQA kv heads in place
(``h // group``), reads batch-major tensors through their strides and masks
the ragged edge itself, so it moves no byte beyond the inputs and the
output.  ``PERF.md`` holds its measured time beside its bound.

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.attention_ref`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import attention_ref

__all__ = ["flash_attention", "SUPPORTED_HEAD_DIMS", "SOURCE", "REPLACES"]

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: where the kernel lives, and which TPU kernel it replaces
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:167 (flash_attention_pallas / _flash_kernel)"


def _kernel_fn():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:  # first use of this library handle
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i] + [ll] * 12 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or v.shape != k.shape or Dk != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    if causal and Sq != Sk:
        raise ValueError("causal flash attention expects Sq == Sk self-attention")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Batch-major flash attention, out ``(B, Sq, Hq, D)`` in q's dtype.

    On a CUDA tensor it launches the kernel (fp32 or bf16, ``D`` in
    :data:`SUPPORTED_HEAD_DIMS`, last dimension contiguous) and counts the
    launch in ``flash_attention.launches``; on a CPU tensor it computes the
    plain version.  Anything the kernel does not take raises."""
    _check(q, k, v, causal)
    D = q.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k and v lie on different devices: {sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"kernel takes head dim in {SUPPORTED_HEAD_DIMS}, got {D}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("kernel needs the last (head) dimension contiguous")

    B, Sq, Hq, _ = q.shape
    _, Sk, Hkv, _ = k.shape
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lib, fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            B, Sq, Sk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            scale, int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: {lib.repro_cuda_error_string(err).decode()}"
        )
    flash_attention.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
flash_attention.launches = 0
