"""Flash attention: the hand-written CUDA kernels, their wrapper and its plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` (the
Pallas TPU kernel ``_flash_kernel``).  Two kernels, built for ``sm_90a`` by
:mod:`.build` at their first launch and called through ``ctypes``; a CUDA
call picks one by dtype (:func:`select_route`):

* **bf16 → ``csrc/flash_attention_wgmma.cu``** (route ``"wgmma"``), the
  serving path's kernel: both products on the tensor cores (``wgmma``, bf16
  in, fp32 accumulate), Q and a two-stage ring of K/V tiles brought into
  shared memory by TMA, the online softmax on the accumulator fragment in
  registers, P carried in registers as two bf16 terms (hi + lo, so that
  rows whose p·v nearly cancel stay within the bf16 tolerance) as the
  second product's A operand.  TMA needs the base address and the
  seq/head/batch strides of q, k and v 16-byte aligned; the wrapper checks
  and raises.
* **fp32 → ``csrc/flash_attention.cu``** (route ``"simt"``), both products as
  fp32 FMAs on the CUDA cores.  fp32 stays off the tensor cores on purpose:
  their fp32 input type is TF32, ~10 bits of mantissa, which misses the fp32
  tolerance (2e-5) that the fp32 checks hold the kernel to.

What bounds the function on an H100: two products of 2·S²·D per head pair
(halved by causality) against 8·B·H·S·D bytes moved; at the serving shapes
the bytes bound it.  Both kernels keep the online softmax's state in
registers, read GQA kv heads in place (``h // group``), read batch-major
tensors through their strides and mask the ragged edge themselves, so they
move no byte beyond the inputs and the output.  ``PERF.md`` holds their
measured times beside the bound.

A CUDA tensor launches a kernel or raises; nothing falls back to the other
kernel or to the plain version.  Only a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.attention_ref`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .ref import attention_ref

__all__ = [
    "flash_attention", "select_route", "tma_strides", "ROUTES", "SUPPORTED_HEAD_DIMS",
    "SOURCE", "SIMT_SOURCE", "REPLACES",
]

SUPPORTED_HEAD_DIMS = (32, 64, 128)
#: dtype → the kernel a CUDA call of that dtype launches
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}

#: where the kernels live, and which TPU kernel they replace (SOURCE is the
#: main path's: serving runs in bf16)
SOURCE = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
SIMT_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:167 (flash_attention_pallas / _flash_kernel)"
#: bytes of alignment TMA needs of a tensor map's base address and strides
TMA_ALIGN = 16


def select_route(dtype: torch.dtype) -> str:
    """The kernel that a CUDA call on ``dtype`` launches: ``"wgmma"`` (the
    tensor-core kernel) for bf16, ``"simt"`` for fp32; anything else raises."""
    route = ROUTES.get(dtype)
    if route is None:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v, got {dtype}")
    return route


def tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, seq, head) strides, in elements, that a tensor map over the
    (B, S, H, D) tensor ``t`` is given; raises ``ValueError`` unless TMA can
    read it (head dim contiguous, base and strides 16-byte aligned).  A
    dimension of size 1 is never stepped, so its stride is replaced by the
    extent of the dimensions inside it."""
    esize = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError("kernel needs the last (head) dimension contiguous")
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"TMA needs a {TMA_ALIGN}-byte-aligned base address, got {t.data_ptr():#x}")
    B, S, H, D = t.shape
    inner_stride, inner_size = 1, D
    out = {}
    for dim, size in ((1, S), (2, H), (0, B)):  # innermost first, as the tensor map orders them
        stride = t.stride(dim) if size > 1 else inner_stride * inner_size
        if (stride * esize) % TMA_ALIGN:
            raise ValueError(f"TMA needs {TMA_ALIGN}-byte-aligned strides, got stride {stride} of dim {dim}")
        out[dim] = stride
        inner_stride, inner_size = stride, size
    return out[0], out[1], out[2]


def _kernel_fn(route: str):
    """The route's C entry point and its error-string function; both kernels
    take the same arguments."""
    if route == "wgmma":
        lib = build.load("flash_attention_wgmma")
        fn, err_str = lib.repro_flash_attention_fwd_wgmma, lib.repro_flash_wgmma_error_string
    else:
        lib = build.load("flash_attention")
        fn, err_str = lib.repro_flash_attention_fwd, lib.repro_cuda_error_string
    if fn.argtypes is None:  # first use of this library handle
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, p, p, p] + [i] * 6 + [ll] * 12 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        err_str.argtypes = [i]
        err_str.restype = ctypes.c_char_p
    return fn, err_str


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

    On a CUDA tensor it launches the kernel that :func:`select_route` names
    for q's dtype (bf16: the tensor-core kernel, fp32: the SIMT kernel; ``D``
    in :data:`SUPPORTED_HEAD_DIMS`, last dimension contiguous; for bf16 also
    the alignment :func:`tma_strides` checks) and counts the launch in
    ``flash_attention.launches``; on a CPU tensor it computes the plain
    version.  Anything the kernels do not take raises."""
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
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    route = select_route(q.dtype)
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"kernel takes head dim in {SUPPORTED_HEAD_DIMS}, got {D}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("kernel needs the last (head) dimension contiguous")

    B, Sq, Hq, _ = q.shape
    _, Sk, Hkv, _ = k.shape
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if route == "wgmma":
        # a tensor with no rows is never read (Sk == 0 loads no tile)
        strides = [tma_strides(t) if t.shape[1] else t.stride()[:3] for t in (q, k, v)]
    else:
        strides = [t.stride()[:3] for t in (q, k, v)]
    fn, err_str = _kernel_fn(route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, Hq, Hkv, D,
            *strides[0], *strides[1], *strides[2], *out.stride()[:3],
            scale, int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: {err_str(err).decode()}")
    flash_attention.launches += 1
    return out


#: launches of either CUDA kernel since the count was last set to 0
flash_attention.launches = 0
