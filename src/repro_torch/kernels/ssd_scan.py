"""Mamba-2 SSD scan: the hand-written CUDA kernel, its wrapper, its gradient.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` (the Pallas TPU
kernel ``_ssd_kernel``).  The kernel is ``csrc/ssd_scan.cu``, built for
``sm_90a`` by :mod:`.build` at its first launch and called through
``ctypes``.

What bounds it on an H100: the work (2L²N + 2L²P + 4LNP FLOPs per tile of L
rows and head) is small against the bytes it moves (x, y, dt, B, C, the
final state), so the function is bound by bytes; this first kernel runs the
three products as fp32 FMAs from shared memory and recomputes C·Bᵀ for each
slice of 32 state rows, so it is bound by shared-memory reads and FMA issue.
Its design: one block per (batch, head, slice of the state rows) walks the
sequence in 64-row tiles with its slice of the fp32 state in shared memory;
it reads batch-major tensors through their strides and B/C of group
``h // (H/G)`` in place, and masks the ragged last tile itself, so it takes
any sequence length.  ``PERF.md`` holds its measured time beside its bound.

**Chunk.** The reference takes ``min(chunk, S)`` and halves it until it
divides S (``ops.py:207-211``), so a 300-token prompt runs with chunk 4.  The
kernel always works in 64-row tiles and masks the last one; the chunk only
names the block size of the result the reference computes, and the math is
the same up to rounding.

**Gradient.** The JAX package has no backward kernel for the SSD scan: off
the TPU it differentiates its chunked jnp form (``ops.py:215-217``).  So
:class:`SSDScan`'s forward launches the kernel and saves the inputs, and its
backward recomputes the port's chunked torch form
(:func:`repro_torch.kernels.ref.ssd_chunked_ref`) from them under autograd
and returns the gradients of x, dt, A, B, C, D and h0.  A backward kernel is
later work (``ROADMAP.md``).

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .ref import ssd_chunked_ref

__all__ = ["ssd_scan", "SSDScan", "ssd_scan_autograd", "ssd_flops", "MAX_STATE", "TILE", "SOURCE", "REPLACES"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's tile of sequence rows, and the largest d_state it takes
TILE, MAX_STATE = 64, 256

#: where the kernel lives, and which TPU kernel it replaces
SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:145 (ssd_scan_pallas / _ssd_kernel)"


def ssd_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    """FLOPs the kernel does for one call: ``2L²N + 2L²P + 4LNP`` per
    (batch, head, tile of L = :data:`TILE` rows), the full L×L tile counted
    (the kernel computes the causal half's zeros too)."""
    L = TILE
    return B * H * -(-S // L) * (2 * L * L * N + 2 * L * L * P + 4 * L * N * P)


def _kernel_fn():
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    if fn.argtypes is None:  # first use of this library handle
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p] * 9 + [i] * 7 + [ll] * 12 + [p]
        fn.restype = ctypes.c_int
        lib.repro_ssd_error_string.argtypes = [i]
        lib.repro_ssd_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(x, dt, A, Bm, Cm, D, h0) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4 or Cm.ndim != 4:
        raise ValueError("ssd_scan takes x (B,S,H,P), dt (B,S,H), A (H,), B and C (B,S,G,N)")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}")
    if tuple(Bm.shape) != (Bsz, S, G, N) or Cm.shape != Bm.shape:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if G == 0 or H % G != 0:
        raise ValueError(f"heads {H} not a multiple of groups {G}")
    if D is not None and tuple(D.shape) != (H,):
        raise ValueError(f"D has shape {tuple(D.shape)}, want ({H},)")
    if h0 is not None and tuple(h0.shape) != (Bsz, H, P, N):
        raise ValueError(f"h0 has shape {tuple(h0.shape)}, want {(Bsz, H, P, N)}")


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-major SSD scan → ``(y (B,S,H,P) in x's dtype, h_final (B,H,P,N))``.

    On a CUDA tensor it launches the kernel (x, B, C fp32 or bf16 of one
    dtype with the last dimension contiguous; dt, A, D, h0 fp32; N up to
    :data:`MAX_STATE`) and counts the launch in ``ssd_scan.launches``; on a
    CPU tensor it computes the plain chunked version at ``chunk`` (which must
    divide S).  Anything the kernel does not take raises.  No gradient flows
    through this function: :class:`SSDScan` is its differentiable form."""
    _check(x, dt, A, Bm, Cm, D, h0)
    tensors = [t for t in (x, dt, A, Bm, Cm, D, h0) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan inputs lie on different devices: {sorted(map(str, devices))}")
    if x.device.type == "cpu":
        with torch.no_grad():
            return ssd_chunked_ref(x, dt, A, Bm, Cm, D, h0, chunk=chunk, return_state=True)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(
            f"kernel takes float32 or bfloat16 x/B/C of one dtype, got {x.dtype}, {Bm.dtype}, {Cm.dtype}"
        )
    for name, t in (("dt", dt), ("A", A), ("D", D), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"kernel takes {name} in float32, got {t.dtype}")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("kernel needs the last dimension of x, B and C contiguous")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if N > MAX_STATE:
        raise ValueError(f"kernel takes d_state up to {MAX_STATE}, got {N}")

    A = A.contiguous()
    D = D.contiguous() if D is not None else None
    h0 = h0.contiguous() if h0 is not None else None
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    h_out = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    lib, fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D.data_ptr() if D is not None else None, h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), h_out.data_ptr(), _DTYPE_CODES[x.dtype],
            Bsz, S, H, G, P, N,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: {lib.repro_ssd_error_string(err).decode()}")
    ssd_scan.launches += 1
    return y, h_out


#: launches of the CUDA kernel since the count was last set to 0
ssd_scan.launches = 0


class SSDScan(torch.autograd.Function):
    """The SSD scan with a gradient: forward by :func:`ssd_scan` (the kernel
    on the card), backward by autograd through the chunked torch form,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, h0, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, h0)
        return ssd_scan(x, dt, A, Bm, Cm, D, h0, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[: len(saved)]
        inputs = [t.detach().requires_grad_(n) if t is not None else None for t, n in zip(saved, need)]
        wrt = [t for t, n in zip(inputs, need) if n]
        grads = iter(())
        if wrt:
            with torch.enable_grad():
                y, h = ssd_chunked_ref(*inputs, chunk=ctx.chunk, return_state=True)
                grads = iter(torch.autograd.grad((y, h), wrt, (gy, gh), allow_unused=True))
        return (*(next(grads) if n else None for n in need), None)


def ssd_scan_autograd(x, dt, A, Bm, Cm, D=None, h0=None, *, chunk: int):
    """:class:`SSDScan` applied: :func:`ssd_scan` with a gradient."""
    return SSDScan.apply(x, dt, A, Bm, Cm, D, h0, chunk)
