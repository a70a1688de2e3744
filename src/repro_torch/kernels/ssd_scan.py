"""Mamba-2 SSD scan: the hand-written CUDA kernels, their wrapper, its gradient.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` (the Pallas TPU
kernel ``_ssd_kernel``).  Two kernels, built for ``sm_90a`` by :mod:`.build`
at their first launch and called through ``ctypes``; a CUDA call picks one
by dtype (:func:`select_route`):

* **bf16 → ``csrc/ssd_scan_wgmma.cu``** (route ``"wgmma"``), the training
  path's kernel: the chunked-parallel form in three kernels on one stream.
  ``C·Bᵀ`` once per (batch, group, 64-row tile) and each chunk's own state
  ``Xᵀ(B ⊙ w)`` in parallel; the states passed across chunks in order in
  fp32; then per (batch, head, chunk) the outputs ``exp(cum)·(C hᵀ) + M X``.
  Every product runs on the tensor cores (``wgmma``, bf16 in, fp32
  accumulate), x, B and C tiles arrive by TMA, and the fp32 operands M,
  ``x·w`` and the entering state are carried as two bf16 terms (hi + lo):
  one bf16 rounding of ``x·w`` alone puts the final state past the 1e-3
  relative error it is held to, and one of M or of the state puts outputs
  past the bf16 tolerance where large terms cancel.  It takes P = 64 (one
  warpgroup a block) and P = 128 (jamba's heads: two warpgroups a block,
  each owning 64 state rows and 64 output columns), d_state 64 or 128, and
  needs the base and the batch/seq/head strides of x, B and C 16-byte
  aligned (TMA); the wrapper checks and raises.  Chunks hold
  :func:`tiles_per_chunk` tiles, picked to fill the output kernel's waves.
* **fp32 → ``csrc/ssd_scan.cu``** (route ``"simt"``): the same
  chunked-parallel form on the CUDA cores, one 64-row tile a chunk, in three
  kernels: ``C·Bᵀ`` once per (batch, group, tile) and each tile's own state
  ``Xwᵀ B`` per (batch, head, tile); the states passed across tiles in order
  in fp32 from h0; then per (batch, head, tile) ``y = M X + exp(cum)·(C
  h_inᵀ)``.  Every product is an fp32 FMA on register-blocked micro-tiles
  read as float4s; any P (slices of :data:`SIMT_SLICE` state rows) and
  d_state up to :data:`MAX_STATE`.  Its plain model, in its order of sums,
  is :func:`repro_torch.kernels.ref.ssd_tiled_ref` with no rounding terms and
  one tile a chunk.  fp32 stays off the tensor cores on purpose: their fp32
  input type is TF32, which misses the fp32 tolerance.

Either route launches :data:`KERNELS_PER_CALL` CUDA kernels a call (only
the pass when S = 0); ``ssd_scan.launches`` counts calls.  What bounds the
function on an H100: the work (:func:`ssd_flops`: ``C·Bᵀ`` once per group and tile, the causal
halves of the L×L products, ``C hᵀ`` and the state product per head and
tile) is small against the bytes it moves (x, y, dt, B, C, the final
state: :func:`ssd_bytes`), so the function is bound by bytes in bf16; in
fp32 at the fp32 FMA rate it is bound by operations.  Both kernels read
batch-major tensors through their strides and B/C of group ``h // (H/G)`` in
place, and mask the ragged last tile themselves, so they take any sequence
length.  ``PERF.md`` holds their measured times beside the bound.

**Chunk.** The reference takes ``min(chunk, S)`` and halves it until it
divides S (``ops.py:207-211``), so a 300-token prompt runs with chunk 4.  The
kernels always work in 64-row tiles and mask the last one; the chunk only
names the block size of the result the reference computes, and the math is
the same up to rounding.

**Gradient.** The JAX package has no backward kernel for the SSD scan: off
the TPU it differentiates its chunked jnp form (``ops.py:215-217``).  So
:class:`SSDScan`'s forward launches the kernel and saves the inputs, and its
backward recomputes the port's chunked torch form
(:func:`repro_torch.kernels.ref.ssd_chunked_ref`) from them under autograd
and returns the gradients of x, dt, A, B, C, D and h0.  A backward kernel is
later work (``ROADMAP.md``).

A CUDA tensor launches a kernel or raises; nothing falls back to the other
kernel or to the plain version.  Only a CPU tensor takes the plain version.
A ``FakeTensor`` (on any device: the cost count of
:func:`repro_torch.perf.cost.count_step`) builds and launches nothing: the
wrapper records the launch it stands for as an :class:`SSDLaunch` in
``ssd_scan.fake_shapes`` (not in ``ssd_scan.launches``) and returns empty
outputs of the kernel's shapes.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from .flash_attention import is_fake, tma_strides
from .ref import ssd_chunked_ref

__all__ = [
    "ssd_scan", "SSDScan", "SSDLaunch", "ssd_scan_autograd", "ssd_flops", "ssd_bytes", "select_route", "tiles_per_chunk",
    "ROUTES",
    "MAX_STATE", "MAX_CHUNK_TILES", "TILE", "SIMT_SLICE", "KERNELS_PER_CALL", "WGMMA_HEAD_DIMS", "WGMMA_STATES",
    "SOURCE", "SIMT_SOURCE", "REPLACES", "simt_scratch",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: dtype → the kernel a CUDA call of that dtype launches
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
#: the kernels' tile of sequence rows, and the largest d_state the SIMT kernel takes
TILE, MAX_STATE = 64, 256
#: the SIMT kernel's slice of state rows (P), and the widths it pads d_state to
SIMT_SLICE, _SIMT_STATES = 64, (64, 128, 256)
#: CUDA kernels one call launches, on either route: prep, the pass across chunks, the outputs
KERNELS_PER_CALL = 3
#: the head dims and the d_states the tensor-core kernel takes
WGMMA_HEAD_DIMS, WGMMA_STATES = (64, 128), (64, 128)
#: the longest state chunk the tensor-core kernel takes, in tiles, and the
#: chunk states at P = 64 that cost one output tile's time (measured on an
#: H100: ~6 µs a tile, ~0.05 µs a state)
MAX_CHUNK_TILES, _STATES_PER_TILE = 8, 120

#: where the kernels live, and which TPU kernel they replace (SOURCE is the
#: main path's: training runs in bf16)
SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_wgmma.cu"
SIMT_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:145 (ssd_scan_pallas / _ssd_kernel)"


def select_route(dtype: torch.dtype) -> str:
    """The kernel that a CUDA call on ``dtype`` launches: ``"wgmma"`` (the
    tensor-core kernel) for bf16, ``"simt"`` for fp32; anything else raises."""
    route = ROUTES.get(dtype)
    if route is None:
        raise ValueError(f"kernel takes float32 or bfloat16 x/B/C, got {dtype}")
    return route


def tiles_per_chunk(B: int, H: int, S: int, sms: int, P: int = 64) -> int:
    """Tiles per state chunk of the tensor-core kernel (1 to
    :data:`MAX_CHUNK_TILES`).  Its output kernel holds two blocks per SM at
    P = 64 and one at P = 128 (whose block of two warpgroups needs more than
    half an SM's shared memory), each walking its chunk's tiles in turn, so
    that kernel's time goes as waves × tiles per chunk, while every chunk
    adds a state that its kernels write, pass on and read.  On an H100 one
    block's tile at P = 64 costs about as much as :data:`_STATES_PER_TILE`
    chunk states (``scripts/ssd_chunk_sweep.py``).  At P = 128 a block's two
    warpgroups each do a P = 64 block's work on a tile, side by side, so its
    tile is taken to cost the same, while a state holds twice the bytes and
    costs twice as much.  The chunk length that minimises the sum is taken,
    the longest among equals."""
    n_tiles = -(-S // TILE)
    per_sm, states_per_tile = (2 if P == 64 else 1), _STATES_PER_TILE * 64 / P

    def cost(q: int):
        items = B * H * -(-n_tiles // q)
        return -(-items // (per_sm * sms)) * q + items / states_per_tile, -q

    return min(range(1, MAX_CHUNK_TILES + 1), key=cost)


def ssd_flops(B: int, S: int, H: int, P: int, N: int, G: int = 1) -> int:
    """The FLOPs of the function's least work in the chunked form, the
    yardstick both kernels are timed against: per (batch, group, tile of
    r ≤ L = :data:`TILE` rows) ``C·Bᵀ``'s causal half, ``r(r+1)/2·2N``; per
    (batch, head, tile) ``M X``'s causal half, ``r(r+1)/2·2P``, the
    inter-tile ``C h_inᵀ``, ``2rNP``, and the state update ``Xwᵀ B``,
    ``2rNP``.  (The kernels compute whole L×L tiles, and the tensor-core
    kernel runs each two-term product twice.)"""
    full, r = divmod(S, TILE)
    rows = [TILE] * full + ([r] if r else [])
    tri = sum(n * (n + 1) // 2 for n in rows)
    return B * (G * tri * 2 * N + H * (tri * 2 * P + 4 * S * N * P))


def ssd_bytes(B: int, S: int, H: int, P: int, N: int, G: int, esize: int) -> int:
    """The bytes one call must move: x read and y written (``esize`` each), B
    and C read (``esize``), dt, A and D read and the final state written
    (fp32)."""
    return esize * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * B * S * H + 2 * 4 * H + 4 * B * H * P * N


class SSDLaunch(NamedTuple):
    """One call of the SSD kernel as a fake-tensor call records it (shape,
    element size of x, B and C), priced by :func:`ssd_flops` and
    :func:`ssd_bytes`."""

    B: int
    S: int
    H: int
    P: int
    N: int
    G: int
    esize: int

    def flops(self) -> int:
        return ssd_flops(self.B, self.S, self.H, self.P, self.N, self.G)

    def bytes(self) -> int:
        return ssd_bytes(self.B, self.S, self.H, self.P, self.N, self.G, self.esize)


def _kernel_fn(route: str):
    """The route's C entry point and its error-string function."""
    ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    if route == "wgmma":
        lib = build.load("ssd_scan_wgmma")
        fn, err_str = lib.repro_ssd_scan_fwd_wgmma, lib.repro_ssd_wgmma_error_string
        argtypes = [p] * 13 + [i] * 7 + [ll] * 12 + [p]
    else:
        lib = build.load("ssd_scan")
        fn, err_str = lib.repro_ssd_scan_fwd, lib.repro_ssd_error_string
        argtypes = [p] * 12 + [i] * 7 + [ll] * 12 + [p]
    if fn.argtypes is None:  # first use of this library handle
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_str.argtypes = [i]
        err_str.restype = ctypes.c_char_p
    return fn, err_str


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
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-major SSD scan → ``(y (B,S,H,P) in x's dtype, h_final (B,H,P,N))``.

    On a CUDA tensor it launches the kernel that :func:`select_route` names
    for x's dtype (x, B, C fp32 or bf16 of one dtype with the last dimension
    contiguous; dt, A, D, h0 fp32; bf16 also with the shapes and alignment
    the tensor-core kernel takes) and counts the launch in
    ``ssd_scan.launches``; ``route="simt"`` asks for the SIMT kernel on bf16
    too (for timing it beside the tensor-core one; nothing on the main path
    passes it).  On a CPU tensor it computes the plain chunked version at
    ``chunk`` (which must divide S).  Anything the kernels do not take
    raises.  No gradient flows through this function: :class:`SSDScan` is
    its differentiable form."""
    _check(x, dt, A, Bm, Cm, D, h0)
    if is_fake(x):
        Bsz, S, H, P = x.shape
        G, N = Bm.shape[2], Bm.shape[3]
        ssd_scan.fake_shapes[SSDLaunch(Bsz, S, H, P, N, G, x.element_size())] += 1
        return x.new_empty((Bsz, S, H, P)), x.new_empty((Bsz, H, P, N), dtype=torch.float32)
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
    route = select_route(x.dtype) if route is None else route
    if route not in ("wgmma", "simt") or (route == "wgmma" and x.dtype != torch.bfloat16):
        raise ValueError(f"route {route!r} does not take {x.dtype} (the tensor-core kernel is bf16 only)")
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
    fn, err_str = _kernel_fn(route)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            args = _wgmma_args(x, Bm, Cm, h0)
            err = fn(
                ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), ptr(D), ptr(args["h0"]), ptr(y), ptr(h_out),
                *(ptr(t) for t in args["scratch"]), Bsz, S, H, G, P, N, args["tiles_per_chunk"],
                *args["x_strides"], *dt.stride(), *args["b_strides"], *args["c_strides"], stream,
            )
        else:
            scratch = [torch.empty(shape, dtype=torch.float32, device=x.device)
                       for shape in simt_scratch(Bsz, S, H, G, P, N)]
            err = fn(
                ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), ptr(D), ptr(h0), ptr(y), ptr(h_out),
                *(ptr(t) for t in scratch), _DTYPE_CODES[x.dtype], Bsz, S, H, G, P, N,
                *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3], stream,
            )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: {err_str(err).decode()}")
    ssd_scan.launches += 1
    return y, h_out


def simt_scratch(B: int, S: int, H: int, G: int, P: int, N: int):
    """The SIMT kernel's fp32 scratch shapes: ``C·Bᵀ`` per (batch, group,
    tile), each tile's state as (n, p) rows per (batch, tile, head, slice of
    :data:`SIMT_SLICE` state rows), d_state padded to 64, 128 or 256 (its
    own state, then the state entering it), and each tile's decay per
    (batch, tile, head)."""
    n_tiles, slices = -(-S // TILE), -(-P // SIMT_SLICE)
    ns = next(w for w in _SIMT_STATES if N <= w)
    return ((B, G, n_tiles, TILE, TILE), (B, n_tiles, H, slices, ns, SIMT_SLICE), (B, n_tiles, H))


def _wgmma_args(x, Bm, Cm, h0):
    """What the tensor-core kernel needs beyond the tensors: its TMA strides
    (raising where TMA cannot read x, B or C), an h0 on a 16-byte boundary,
    its chunk length and its fp32 scratch (C Bᵀ per tile; each chunk's own
    and entering state; each chunk's log decay)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if P not in WGMMA_HEAD_DIMS or N not in WGMMA_STATES:
        raise ValueError(f"the bf16 kernel takes head dim in {WGMMA_HEAD_DIMS} and d_state in {WGMMA_STATES}, "
                         f"got P={P}, N={N}")
    strides = {name: tma_strides(t) for name, t in (("x", x), ("b", Bm), ("c", Cm))}
    if h0 is not None and h0.data_ptr() % 16:
        h0 = h0.clone()  # the state pass reads h0 four floats at a time
    q = tiles_per_chunk(Bsz, H, S, torch.cuda.get_device_properties(x.device).multi_processor_count, P)
    n_tiles = -(-S // TILE)
    n_chunks = -(-n_tiles // q)
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = (
        torch.empty((Bsz, G, n_tiles, TILE, TILE), **f32),
        torch.empty((Bsz, n_chunks, H, P, N), **f32),
        torch.empty((Bsz, n_chunks, H, P, N), **f32),
        torch.empty((Bsz, n_chunks, H), **f32),
    )
    return {"x_strides": strides["x"], "b_strides": strides["b"], "c_strides": strides["c"], "h0": h0,
            "tiles_per_chunk": q, "scratch": scratch}


#: launches of the CUDA kernel since the count was last set to 0
ssd_scan.launches = 0
#: the calls that fake tensors stood for, by :class:`SSDLaunch` (nothing launched)
ssd_scan.fake_shapes = Counter()


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
