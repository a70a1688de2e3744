"""Flash attention: the hand-written CUDA kernels, their wrappers and their plain versions.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` (the
Pallas TPU kernel ``_flash_kernel``) and the gradient the JAX package lets
XLA take of its blocked form.  Four kernels, built for ``sm_90a`` by
:mod:`.build` at their first launch and called through ``ctypes``; a CUDA
call picks one by dtype and head dims (:func:`select_route` forward,
:func:`select_bwd_route` backward).  Both directions take the (q/k head
dim, v head dim) pairs of :data:`FWD_PAIRS`: the equal widths 16, 32, 64,
128 and 256 (16 by zero-padding to 32: :data:`PAD_D16`), and (192,
128), MLA's (deepseek-v2: q and k carry 128 columns
plus 64 of rope, v 128), served by the forward and trained through both.
Every kernel takes a causal mask with a prefix-LM prefix (``prefix_len``:
every row also sees the first ``prefix_len`` keys, paligemma's vision
tokens; self-attention only), and the non-causal mask of an encoder or of
cross-attention at ``Sq != Sk`` (whisper's 448 decoder rows over 1,500
frames).

* **forward, bf16 at every pair → ``csrc/flash_attention_wgmma.cu``**
  (route ``"wgmma"``), the serving and training path's kernel: both
  products on the tensor cores (``wgmma``, bf16 in, fp32 accumulate), Q and
  a two-stage ring of K/V tiles brought into shared memory by TMA, the
  online softmax on the accumulator fragment in registers, P carried in
  registers as two bf16 terms (hi + lo, so that rows whose p·v nearly
  cancel stay within the bf16 tolerance) as the second product's A
  operand.  At D = 256 (gemma-7b, paligemma-3b) Q and the ring take
  164,904 bytes of shared memory, within a block's 232,448; the 64 x 256
  fp32 accumulator takes 128 registers a thread.  At (192, 128) the Q and
  K tiles are 192 columns wide (S = Q Kᵀ in 12 k-steps) and V and O 128.
* **forward, fp32 → ``csrc/flash_attention.cu``** (route ``"simt"``), both
  products as fp32 FMAs on the CUDA cores, tiled as the fp32 backward is:
  8 × 4 score micro-tiles read as float4s from swizzled shared tiles over
  parts of D, summed in one softmax pass, O in 8 × 4 register blocks, K/V
  by ``cp.async`` in two stages (``csrc/simt_tile.cuh``); at (192, 128)
  the 32-row tiles of D = 256, six parts of the 192 score columns, O over
  128.  fp32 stays off the tensor cores on purpose: their fp32 input type
  is TF32, ~10 bits of mantissa, which misses the fp32 tolerance (2e-5)
  that the fp32 checks hold the kernel to.  It also takes bf16 at D = 256 when asked (``route="simt"``),
  so that the two can be timed side by side.
* **backward, bf16 at every pair → ``csrc/flash_attention_bwd_wgmma.cu``**
  (route ``"wgmma"``), the training path's: the FlashAttention-2 split in
  three launches (``Dᵢ = rowsum(dO ∘ O)``; dK and dV per kv tile; dQ per q
  tile), all seven products on ``wgmma``, q/k/v/dO tiles by TMA, P and dS
  as the A operands from registers, each as two bf16 terms
  (:data:`BWD_P_TERMS`, :data:`BWD_DS_TERMS`).  At D = 256 (gemma-7b,
  paligemma-3b) a block runs two consumer warpgroups, each owning half of
  D's output columns, so that the dK and dV accumulators fit the registers;
  at (192, 128) (deepseek-v2-lite's MLA) two warpgroups split by output,
  one owning the 192-wide dK and the other the 128-wide dV.
* **backward, fp32 → ``csrc/flash_attention_bwd.cu``** (route ``"simt"``),
  the same split with every product as fp32 FMAs on register-blocked
  micro-tiles, float4 reads of swizzled tiles and ``cp.async`` double
  buffering; at (192, 128) the 32-row tiles of D = 256, the scores and dQ,
  dK over 192 columns and dP's V side and dV over 128.  It also takes bf16
  at the equal widths when asked (``route="simt"``), for timing beside the
  tensor-core kernel.

Every forward kernel can write the rows' logsumexp (``return_lse=True``),
which the backward reads.  The JAX package has no backward kernel: off the
TPU it lets XLA differentiate its blocked jnp form
(``repro/kernels/ops.py::_xla_flash``), so that gradient is the function
the backward replaces.  The tensor-core kernels need the base address and
the seq/head/batch strides of what they read by TMA 16-byte aligned
(:func:`tma_strides`); the wrapper checks and raises.

What bounds the function on an H100: the forward's two products,
2·Sq·Sk·(Dqk + Dv) FLOPs per head (halved by causality; a prefix adds back
its own square's upper half), against q, k (Dqk wide), v and out (Dv wide)
moved once; the backward's five products, 2·Sq·Sk·(3·Dqk + 2·Dv), against
q, k, v, o, dO read and dq, dk, dv written once (:func:`flash_flops`,
:func:`flash_bytes`; :class:`FlashLaunch` prices one launch as the wrapper
records it).  At the
serving shapes the forward is bound by bytes, at training's S = 2048 by
operations.  Every kernel reads GQA kv heads in place (``h // group``),
reads batch-major tensors through their strides and masks the ragged edge
itself.  ``PERF.md`` holds their measured times beside the bound.

A CUDA tensor launches a kernel or raises; nothing falls back to another
kernel or to the plain version.  Only a CPU tensor takes the plain versions
(:func:`repro_torch.kernels.ref.attention_ref`,
:func:`~repro_torch.kernels.ref.attention_lse_ref`,
:func:`~repro_torch.kernels.ref.flash_backward_ref`).  A ``FakeTensor``
(``torch._subclasses.fake_tensor``, on any device: the cost count of
:func:`repro_torch.perf.cost.count_step`) builds and launches nothing: the
wrapper records the launch it stands for in ``.fake_shapes`` (not in
``.launches`` or ``.shapes``, which count real launches only) and returns
empty outputs of the kernel's shapes.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional, Tuple, Union

import torch

from . import build
from .ref import attention_lse_ref, attention_ref, flash_backward_ref

__all__ = [
    "is_fake", "flash_attention", "flash_attention_backward", "flash_flops", "flash_bytes", "FlashLaunch",
    "select_route",
    "select_bwd_route", "tma_strides", "ROUTES", "SUPPORTED_HEAD_DIMS", "PAD_D16", "FWD_PAIRS",
    "BWD_LAUNCHES", "BWD_P_TERMS", "BWD_DS_TERMS",
    "SOURCE", "SIMT_SOURCE", "BWD_SOURCE", "BWD_SIMT_SOURCE", "REPLACES", "BWD_REPLACES",
]

#: the equal q/k and v head dims both directions take
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
#: the kernel width a CUDA call at head dim 16 runs at: the wrapper copies q,
#: k and v (and o and dO backward) into zero-padded tensors of this width,
#: launches the kernel there with the true width's scale, records the launch
#: at the true width, and copies the true width's columns out.  Zero columns
#: add nothing to Q Kᵀ, give zero columns of O and dV, and leave Dᵢ =
#: rowsum(dO ∘ O) as it is, so the result is the true width's.  A 16-wide bf16 row is 32 bytes, under the
#: 64-byte swizzle the tensor-core kernels' tiles take; the copies are timed
#: with the kernel (chip_smoke.py, ``d16``).
PAD_D16 = 32
_EQUAL_PAIRS = tuple((d, d) for d in SUPPORTED_HEAD_DIMS)
#: the (q/k head dim, v head dim) pairs the forward and the backward kernels
#: take: the equal widths, and MLA's at deepseek-v2's published widths
FWD_PAIRS = _EQUAL_PAIRS + ((192, 128),)
#: dtype → the kernel a CUDA call of that dtype launches, forward and backward, at every pair they take
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
#: the SIMT kernels' element-type codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: CUDA kernels one backward call launches, on either route: the Dᵢ pre-pass, dK/dV, dQ
BWD_LAUNCHES = 3
#: bf16 terms in which the tensor-core backward carries P into dV = Pᵀ dO and dS into
#: dK = dSᵀ Q and dQ = dS K (``P_TERMS``, ``DS_TERMS`` in its source), as
#: :func:`~repro_torch.kernels.ref.flash_backward_ref` models them
BWD_P_TERMS, BWD_DS_TERMS = 2, 2

#: where the kernels live, and which TPU kernel (or, for the backward, which
#: function) they replace (SOURCE is the main path's: serving and training run in bf16)
SOURCE = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
SIMT_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu"
BWD_SIMT_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/kernels/flash_attention.py:167 (flash_attention_pallas / _flash_kernel)"
BWD_REPLACES = "src/repro/kernels/ops.py:38 (the gradient XLA takes of _xla_flash; no Pallas backward)"
#: bytes of alignment TMA needs of a tensor map's base address and strides
TMA_ALIGN = 16
#: rows of the tensor-core backward's q tiles: its lse/Dᵢ scratch pads Sq to a multiple
_BWD_ROWS = 64


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``FakeTensor``: shapes and dtypes without data,
    which a wrapper answers by recording its launch and returning empty
    outputs (a cost count), never by building or launching a kernel."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def _dims_text(dims: Tuple[int, int]) -> str:
    return f"head dim {dims[0]}" if dims[0] == dims[1] else f"head dims (q/k {dims[0]}, v {dims[1]})"


def _route(dtype: torch.dtype, dims: Tuple[int, int], pairs) -> str:
    route = ROUTES.get(dtype)
    if route is None:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v, got {dtype}")
    if dims not in pairs:
        raise ValueError(f"kernel takes (q/k head dim, v head dim) in {pairs}, got {_dims_text(dims)}")
    return route


def select_route(dtype: torch.dtype, head_dim: int, v_head_dim: Optional[int] = None) -> str:
    """The forward kernel that a CUDA call on ``dtype`` at ``head_dim`` (q
    and k) and ``v_head_dim`` (v; ``head_dim`` by default) launches:
    ``"wgmma"`` (the tensor-core kernel) for bf16 at every pair of
    :data:`FWD_PAIRS`, ``"simt"`` for fp32; any other dtype or pair raises."""
    dims = (head_dim, head_dim if v_head_dim is None else v_head_dim)
    return _route(dtype, dims, FWD_PAIRS)


def select_bwd_route(dtype: torch.dtype, head_dim: int, v_head_dim: Optional[int] = None) -> str:
    """The backward kernel that a CUDA call on ``dtype`` at ``head_dim`` (q
    and k) and ``v_head_dim`` (v, o and dO; ``head_dim`` by default)
    launches: ``"wgmma"`` (the tensor-core kernel) for bf16 at every pair of
    :data:`FWD_PAIRS`, ``"simt"`` for fp32; any other dtype or pair raises."""
    dims = (head_dim, head_dim if v_head_dim is None else v_head_dim)
    return _route(dtype, dims, FWD_PAIRS)


def flash_flops(B: int, Sq: int, Sk: int, Hq: int, D: int, *, causal: bool, backward: bool = False,
                v_head_dim: Optional[int] = None, prefix_len: int = 0) -> int:
    """The FLOPs attention needs: forward, S = Q Kᵀ of 2·Sq·Sk·D and O = P V
    of 2·Sq·Sk·Dv per query head (``Dv = v_head_dim``, ``D`` by default);
    backward five products, S = Q Kᵀ, dQ = dS K and dK = dSᵀ Q of 2·Sq·Sk·D
    and dP = dO Vᵀ and dV = Pᵀ dO of 2·Sq·Sk·Dv; over the visible (query,
    key) pairs: all of them, or when causal half the square (the diagonal
    counted half) plus, with a prefix of ``P = min(prefix_len, Sk)`` keys,
    the upper half of the prefix's own square, which its rows also see:
    ``(Sq·Sk + P²) / 2``.  A prefix of 0 gives the causal half, one of Sk
    the whole square.  The backward kernel computes S and dP in both its
    dK/dV and its dQ kernel (seven products), which is not counted: this is
    the work of the function, not of the kernel."""
    Dv = D if v_head_dim is None else v_head_dim
    if not causal:
        per_pair = 2 * B * Hq * Sq * Sk
    else:
        P = min(prefix_len, Sk)
        per_pair = 2 * B * Hq * (Sq * Sk + P * P) // 2
    return per_pair * (3 * D + 2 * Dv if backward else D + Dv)


def flash_bytes(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int, esize: int, *, backward: bool = False,
                v_head_dim: Optional[int] = None) -> int:
    """The bytes attention must move: forward q and k (``D`` wide) and v
    (``Dv = v_head_dim`` wide, ``D`` by default) read and out (``Dv``)
    written once; backward q and k (``D``), v, o and dO (``Dv``) and the
    fp32 lse read, and dq, dk (``D``) and dv (``Dv``) written once (element
    size ``esize``)."""
    Dv = D if v_head_dim is None else v_head_dim
    q, kv = B * Sq * Hq, B * Sk * Hkv
    if not backward:
        return esize * (q * (D + Dv) + kv * (D + Dv))
    return esize * (q * (2 * D + 2 * Dv) + kv * (2 * D + 2 * Dv)) + 4 * B * Hq * Sq


class FlashLaunch(NamedTuple):
    """One launch of a flash kernel as its wrapper records it (shape, mask,
    element size), in ``flash_attention.shapes`` and
    ``flash_attention_backward.shapes`` beside their launch counts, so that a
    caller prices each launch at its own shape and mask: whisper's encoder
    (non-causal 1,500 x 1,500), its cross-attention (448 x 1,500) and its
    causal decoder differ, and paligemma's rows see its prefix."""

    B: int
    Sq: int
    Sk: int
    Hq: int
    Hkv: int
    D: int
    Dv: int
    causal: bool
    prefix_len: int
    esize: int

    def flops(self, backward: bool = False) -> int:
        return flash_flops(self.B, self.Sq, self.Sk, self.Hq, self.D, causal=self.causal, backward=backward,
                           v_head_dim=self.Dv, prefix_len=self.prefix_len)

    def bytes(self, backward: bool = False) -> int:
        return flash_bytes(self.B, self.Sq, self.Sk, self.Hq, self.Hkv, self.D, self.esize, backward=backward,
                           v_head_dim=self.Dv)


def _launch_record(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, prefix_len: int) -> FlashLaunch:
    B, Sq, Hq, D = q.shape
    return FlashLaunch(B, Sq, k.shape[1], Hq, k.shape[2], D, v.shape[-1], bool(causal), int(prefix_len),
                       q.element_size())


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


_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
#: kernel → (library, C entry point, its error-string function, argtypes)
_ENTRIES = {
    "wgmma": ("flash_attention_wgmma", "repro_flash_attention_fwd_wgmma", "repro_flash_wgmma_error_string",
              [_P] * 5 + [_I] * 7 + [_LL] * 12 + [_F, _I, _I, _P]),
    "simt": ("flash_attention", "repro_flash_attention_fwd", "repro_cuda_error_string",
             [_P] * 5 + [_I] * 8 + [_LL] * 12 + [_F, _I, _I, _P]),
    "bwd_wgmma": ("flash_attention_bwd_wgmma", "repro_flash_attention_bwd_wgmma", "repro_flash_bwd_wgmma_error_string",
                  [_P] * 10 + [_I] * 7 + [_LL] * 15 + [_F, _I, _I, _P]),
    "bwd_simt": ("flash_attention_bwd", "repro_flash_attention_bwd", "repro_flash_bwd_error_string",
                 [_P] * 10 + [_I] * 8 + [_LL] * 15 + [_F, _I, _I, _P]),
}


def _kernel_fn(kernel: str):
    """The kernel's C entry point and its error-string function."""
    lib_name, fn_name, err_name, argtypes = _ENTRIES[kernel]
    lib = build.load(lib_name)
    fn, err_str = getattr(lib, fn_name), getattr(lib, err_name)
    if fn.argtypes is None:  # first use of this library handle
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_str.argtypes = [_I]
        err_str.restype = ctypes.c_char_p
    return fn, err_str


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, prefix_len: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or v.shape[:-1] != k.shape[:-1] or Dk != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    if causal and Sq != Sk:
        raise ValueError("causal flash attention expects Sq == Sk self-attention")
    if prefix_len < 0 or (prefix_len > 0 and not causal):
        raise ValueError(f"a prefix-LM prefix is causal self-attention's, of length >= 0; got prefix_len "
                         f"{prefix_len} with causal={causal}")


def _device(*ts: torch.Tensor) -> torch.device:
    """The one device of ``ts``; raises unless it is a CPU or CUDA device."""
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    return dev


def _check_route(dtype: torch.dtype, dims: Tuple[int, int], route: str, pairs, simt_bf16_pairs) -> None:
    """Raise unless the kernel ``route`` names takes ``dtype`` at the (q/k,
    v) head dims ``dims`` (``"wgmma"`` bf16 at ``pairs``; ``"simt"`` fp32
    at ``pairs``, and bf16 at ``simt_bf16_pairs``), checked on every device."""
    _route(dtype, dims, pairs)  # a dtype or pair no kernel takes
    takes = {"wgmma": dtype == torch.bfloat16, "simt": dtype == torch.float32 or dims in simt_bf16_pairs}
    if not takes.get(route, False):
        raise ValueError(f"route {route!r} does not take {dtype} at {_dims_text(dims)} (the tensor-core kernel "
                         f"takes bfloat16 at {pairs}, the SIMT one float32 and bfloat16 at {simt_bf16_pairs})")


def _check_cuda(ts) -> None:
    """Dtype and layout checks of a CUDA call."""
    dtype = ts[0].dtype
    if any(t.dtype != dtype for t in ts):
        raise ValueError(f"kernel takes q/k/v (and o, dO) of one dtype, got {[t.dtype for t in ts]}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("kernel needs the last (head) dimension contiguous")


def _pad_heads(ts):
    """Each tensor copied into a contiguous zero-padded one :data:`PAD_D16`
    wide in its last dimension."""
    return tuple(torch.nn.functional.pad(t, (0, PAD_D16 - t.shape[-1])) for t in ts)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    prefix_len: int = 0,
    return_lse: bool = False,
    route: Optional[str] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Batch-major flash attention, out ``(B, Sq, Hq, Dv)`` in q's dtype, and
    with ``return_lse`` also the rows' logsumexp ``(B, Hq, Sq)`` fp32
    (``+inf`` for a row that sees no key), which :func:`flash_attention_backward` reads.
    ``prefix_len`` (causal only) lets every row also see the first
    ``prefix_len`` keys (prefix-LM); a prefix of Sk or more gives the
    non-causal result.

    On a CUDA tensor it launches the kernel that :func:`select_route` names
    for q's dtype and head dims (``(D, Dv)`` in :data:`FWD_PAIRS`, last
    dimension contiguous; for the tensor-core kernel also the alignment
    :func:`tma_strides` checks) and counts the launch in
    ``flash_attention.launches``, its :class:`FlashLaunch` in
    ``flash_attention.shapes`` and its route in ``flash_attention.routes``;
    ``route="simt"`` asks for the SIMT kernel
    on bf16 at D = 256 too (for timing it beside the tensor-core one;
    nothing on the main path passes it).  On a CPU tensor it computes the
    plain version, at any ``Dv``.  Anything the kernels do not take raises."""
    _check(q, k, v, causal, prefix_len)
    D, Dv = q.shape[-1], v.shape[-1]
    scale = float(scale if scale is not None else D ** -0.5)
    if route is not None:  # a CPU call with it runs the plain version
        _check_route(q.dtype, (D, Dv), route, FWD_PAIRS, ((256, 256),))
    if is_fake(q):
        flash_attention.fake_shapes[_launch_record(q, k, v, causal, prefix_len)] += 1
        B, Sq, Hq, _ = q.shape
        out = q.new_empty((B, Sq, Hq, Dv))
        return (out, q.new_empty((B, Hq, Sq), dtype=torch.float32)) if return_lse else out
    if _device(q, k, v).type == "cpu":
        mask = dict(causal=causal, scale=scale, prefix_len=prefix_len)
        out = attention_ref(q, k, v, **mask)
        return (out, attention_lse_ref(q, k, v, **mask)) if return_lse else out
    route = route or select_route(q.dtype, D, Dv)
    _check_cuda((q, k, v))
    record = _launch_record(q, k, v, causal, prefix_len)
    if D == 16:
        q, k, v = _pad_heads((q, k, v))

    B, Sq, Hq, Dk = q.shape
    _, Sk, Hkv, Dvk = v.shape
    out = torch.empty((B, Sq, Hq, Dvk), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    dims = [B, Sq, Sk, Hq, Hkv, Dk, Dvk]
    if route == "wgmma":
        # a tensor with no rows is never read (Sk == 0 loads no tile)
        strides = [tma_strides(t) if t.shape[1] else t.stride()[:3] for t in (q, k, v)]
    else:
        strides = [t.stride()[:3] for t in (q, k, v)]
        dims.append(_DTYPE_CODES[q.dtype])
    fn, err_str = _kernel_fn(route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if lse is not None else None,
            *dims, *strides[0], *strides[1], *strides[2], *out.stride()[:3],
            scale, int(causal), int(prefix_len), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: {err_str(err).decode()}")
    flash_attention.launches += 1
    flash_attention.shapes[record] += 1
    flash_attention.routes[route] += 1
    if D == 16:
        out = out[..., :D]
    return (out, lse) if return_lse else out


#: launches of either forward kernel since the count was last set to 0
flash_attention.launches = 0
#: those launches by :class:`FlashLaunch` (shape, mask, element size)
flash_attention.shapes = Counter()
#: those launches by the route they launched (``"wgmma"``, ``"simt"``)
flash_attention.routes = Counter()
#: the launches that calls on fake tensors stood for, by :class:`FlashLaunch` (nothing launched)
flash_attention.fake_shapes = Counter()


def flash_attention_backward(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    o: torch.Tensor,  # (B, Sq, Hq, Dv)  the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq)    the forward's logsumexp, fp32
    do: torch.Tensor,  # (B, Sq, Hq, Dv) the output's gradient
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    prefix_len: int = 0,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention`, contiguous, in q's dtype
    (dq and dk ``D`` wide, dv ``Dv``).

    On a CUDA tensor it launches the backward that :func:`select_bwd_route`
    names (one dtype for q, k, v, o and dO; ``(D, Dv)`` in
    :data:`FWD_PAIRS`; last dimension contiguous; causal only with Sq ==
    Sk; a prefix as :func:`flash_attention` takes it):
    ``csrc/flash_attention_bwd_wgmma.cu`` for bf16 (q, k, v and dO
    also aligned as :func:`tma_strides` checks),
    ``csrc/flash_attention_bwd.cu`` for fp32 (any strides).  ``route="simt"`` asks for the SIMT
    kernel on bf16 at every equal head dim (for timing it beside the
    tensor-core one; nothing on the main path passes it).  It counts the call in
    ``flash_attention_backward.launches`` (each call launches
    :data:`BWD_LAUNCHES` CUDA kernels), its :class:`FlashLaunch` in
    ``flash_attention_backward.shapes``, its route in
    ``flash_attention_backward.routes``.  On a CPU tensor it computes the
    plain version (:func:`~repro_torch.kernels.ref.flash_backward_ref`).
    Anything the kernels do not take raises."""
    _check(q, k, v, causal, prefix_len)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    if o.shape != (B, Sq, Hq, Dv) or do.shape != (B, Sq, Hq, Dv):
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must be q's shape at v's width, "
                         f"{(B, Sq, Hq, Dv)}")
    if lse.shape != (B, Hq, Sq):
        raise ValueError(f"lse must be (B, Hq, Sq) = {(B, Hq, Sq)}, got {tuple(lse.shape)}")
    scale = float(scale if scale is not None else D ** -0.5)
    if route is not None:  # a CPU call with it runs the plain version
        _check_route(q.dtype, (D, Dv), route, FWD_PAIRS, _EQUAL_PAIRS)
    if is_fake(q):
        flash_attention_backward.fake_shapes[_launch_record(q, k, v, causal, prefix_len)] += 1
        return q.new_empty((B, Sq, Hq, D)), k.new_empty((B, Sk, Hkv, D)), v.new_empty((B, Sk, Hkv, Dv))
    if _device(q, k, v, o, lse, do).type == "cpu":
        return flash_backward_ref(q, k, v, o, lse, do, causal=causal, scale=scale, prefix_len=prefix_len)
    route = route or select_bwd_route(q.dtype, D, Dv)
    _check_cuda((q, k, v, o, do))
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"kernel takes a contiguous float32 lse, got {lse.dtype}")
    record = _launch_record(q, k, v, causal, prefix_len)
    if D == 16:
        q, k, v, o, do = _pad_heads((q, k, v, o, do))

    Dk, Dvk = q.shape[-1], v.shape[-1]
    dq = torch.empty((B, Sq, Hq, Dk), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, Hkv, Dk), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, Hkv, Dvk), dtype=q.dtype, device=q.device)
    dims = [B, Sq, Sk, Hq, Hkv, Dk, Dvk]
    if route == "wgmma":
        # lse·log2(e) and Dᵢ, each (B, Hq, Sq padded to the kernel's 64-row tile)
        scratch = torch.empty(2 * B * Hq * -(-Sq // _BWD_ROWS) * _BWD_ROWS, dtype=torch.float32, device=q.device)
        strides = [s for t in (q, k, v) for s in (tma_strides(t) if t.shape[1] else t.stride()[:3])]
        strides += [*o.stride()[:3], *(tma_strides(do) if Sq else do.stride()[:3])]
    else:
        scratch = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)  # Dᵢ
        strides = [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
        dims.append(_DTYPE_CODES[q.dtype])
    fn, err_str = _kernel_fn("bwd_" + route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv, scratch)),
            *dims, *strides, scale, int(causal), int(prefix_len), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_backward {route} kernel launch failed: {err_str(err).decode()}")
    flash_attention_backward.launches += 1
    flash_attention_backward.shapes[record] += 1
    flash_attention_backward.routes[route] += 1
    if D == 16:
        return tuple(g[..., :D].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


#: calls of the backward that launched its kernels since the count was last set to 0
flash_attention_backward.launches = 0
#: those calls by :class:`FlashLaunch` (shape, mask, element size)
flash_attention_backward.shapes = Counter()
#: those calls by the route they launched (``"wgmma"``, ``"simt"``)
flash_attention_backward.routes = Counter()
#: the calls that fake tensors stood for, by :class:`FlashLaunch` (nothing launched)
flash_attention_backward.fake_shapes = Counter()
