"""The CUDA kernels against their plain versions, on the card: flash attention
forward (bf16 on wgmma at every head dim, fp32 on the CUDA cores at every
head dim) and backward (bf16 on wgmma at every head dim; fp32 on the CUDA
cores; both at MLA's (192, 128)), both directions with a prefix-LM prefix, the SSD scan (bf16 on wgmma, fp32 on the CUDA cores) and the
simulator's landing.

Imports torch and the port only (the card's machine has no JAX).  Every
test needs an NVIDIA GPU and skips without one.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import segment_scatter as ss
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels.ref import (
    attention_lse_ref, attention_ref, flash_backward_ref, running_sum_ref, scatter_add_ref, segment_scatter_ref,
    ssd_ref,
)

pytestmark = pytest.mark.cuda

SHAPES = [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 192, 6, 1, 64), (2, 64, 2, 2, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0, Sk=None):
    B, S, Hq, Hkv, D = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    Sk = S if Sk is None else Sk
    mk = lambda *s: torch.randn(*s, generator=g).to(device=device, dtype=dtype)
    return mk(B, S, Hq, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_fp32_matches_plain(cuda, shape, causal):
    q, k, v = _qkv(shape, torch.float32, cuda, seed=shape[1])
    before = fa.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, impl="plain")
    torch.testing.assert_close(out, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("S", [1, 17, 63, 64, 65, 128, 500, 1024])
def test_kernel_bf16_matches_plain(cuda, S):
    """bf16 runs on the tensor-core kernel (wgmma + TMA) at the serving
    shape: one tile, a tile and one row, ragged lengths."""
    q, k, v = _qkv((1, S, 32, 32, 128), torch.bfloat16, cuda, seed=S)
    before = fa.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and fa.select_route(q.dtype, 128) == "wgmma"
    want = attention_ref(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_wgmma_kernel_matches_plain_on_kernel_shapes(cuda, shape, causal, D):
    """MHA, GQA, MQA with a ragged length and a length below one tile, at
    every head dim the kernel takes (D = 32 uses the 64-byte swizzle)."""
    q, k, v = _qkv(shape[:4] + (D,), torch.bfloat16, cuda, seed=shape[1] + D)
    out = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, impl="plain")
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("Sq,Sk,scale", [(48, 150, None), (130, 64, 0.3), (1, 1000, None)])
def test_wgmma_kernel_cross_length_and_scale(cuda, Sq, Sk, scale):
    """Non-causal attention whose query and key lengths differ (the Q and K/V
    tensor maps span different lengths) and a scale other than D^-0.5."""
    q, k, v = _qkv((2, Sq, 6, 3, 64), torch.bfloat16, cuda, seed=Sq + Sk, Sk=Sk)
    out = ops.flash_attention(q, k, v, causal=False, scale=scale)
    want = attention_ref(q, k, v, causal=False, scale=scale)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=1e-2)


def test_wgmma_kernel_reads_packed_qkv_and_empty_kv(cuda):
    qkv = torch.randn(2, 96, 3, 4, 64, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    for causal in (True, False):
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, causal=causal).float(),
            attention_ref(q, k, v, causal=causal).float(), atol=2e-2, rtol=1e-2,
        )
    q0, k0, v0 = _qkv((1, 5, 2, 2, 32), torch.bfloat16, cuda, Sk=0)
    before = fa.flash_attention.launches
    out = ops.flash_attention(q0, k0, v0, causal=False)
    assert fa.flash_attention.launches == before + 1  # the kernel writes the zeros itself
    assert out.shape == (1, 5, 2, 32) and torch.count_nonzero(out) == 0


def test_wgmma_kernel_refuses_misaligned_inputs(cuda):
    """TMA needs a 16-byte-aligned base and strides: such inputs raise and
    never reach the SIMT kernel or the plain version."""
    buf = torch.randn(1, 16, 2, 40, device=cuda).to(torch.bfloat16)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="aligned base"):
        ops.flash_attention(buf[..., 1:33], buf[..., :32], buf[..., :32])
    odd = torch.randn(1, 16, 2, 36, device=cuda).to(torch.bfloat16)[..., :32]  # 72-byte head stride
    with pytest.raises(ValueError, match="aligned strides"):
        ops.flash_attention(odd, odd, odd)
    assert fa.flash_attention.launches == before


def test_kernel_reads_strided_inputs_and_empty_kv(cuda):
    # q/k/v as slices of one packed projection: batch-major, head dim contiguous
    qkv = torch.randn(2, 96, 3, 4, 64, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True),
        attention_ref(q, k, v, causal=True), atol=2e-5, rtol=1e-4,
    )
    q0, k0, v0 = _qkv((1, 5, 2, 2, 32), torch.float32, cuda, Sk=0)
    assert torch.count_nonzero(ops.flash_attention(q0, k0, v0, causal=False)) == 0


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 16, 2, 2, 48), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv((1, 16, 2, 2, 32), torch.float16, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv((1, 16, 2, 2, 32), torch.float32, cuda)
    for bad in (dict(prefix_len=4, causal=False), dict(prefix_len=-1)):  # a prefix the kernels do not take
        with pytest.raises(ValueError, match="prefix-LM"):
            ops.flash_attention(q, k, v, **bad)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
#: the kernels' logsumexp against the plain one: both fp32 from the same
#: inputs, differing by summation order and exp/log rounding
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


#: the fp32 forward's tiles are 64 rows (32 at D = 256): every head dim, MHA,
#: GQA and MQA, lengths off the tile, and cross lengths (non-causal)
FP32_FWD_GRID = [
    (1, 70, 70, 2, 1, 32), (2, 130, 130, 4, 2, 64), (1, 200, 200, 8, 2, 128), (1, 97, 97, 4, 4, 256),
    (1, 404, 404, 16, 1, 256), (1, 48, 150, 6, 3, 128), (1, 33, 75, 4, 2, 256), (1, 1, 1, 2, 2, 64),
]


@pytest.mark.parametrize("shape,causal", [(s, c) for s in FP32_FWD_GRID for c in (True, False) if not c or s[1] == s[2]])
def test_fp32_forward_every_head_dim_matches_plain(cuda, shape, causal):
    """The fp32 SIMT forward and its logsumexp against the plain versions
    (causal only where Sq == Sk, as the kernels take it)."""
    B, Sq, Sk, Hq, Hkv, D = shape
    q, k, v = _qkv((B, Sq, Hq, Hkv, D), torch.float32, cuda, seed=Sq + Sk + D, Sk=Sk)
    assert fa.select_route(q.dtype, D) == "simt"
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=causal), **FP32_TOL)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, causal=causal), **LSE_TOL)


@pytest.mark.parametrize("D", [32, 128, 256])
def test_fp32_forward_copies_unaligned_rows(cuda, D):
    """fp32 q, k and v whose rows are not 16-byte aligned (head stride D + 1
    floats) take the forward's 4-byte copies and agree as aligned ones do."""
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn(1, 70, 3, D + 1, generator=g).to(cuda)[..., :D] for _ in range(3))
    assert q.stride(2) % 4 != 0 and q.stride(-1) == 1
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=True), **FP32_TOL)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, causal=True), **LSE_TOL)


@pytest.mark.parametrize("D", [64, 256])
def test_fp32_forward_masked_rows_give_zero_and_infinite_lse(cuda, D):
    """Rows that see no key (Sk = 0) give 0 and an lse of +inf at every tile size."""
    q, k, v = _qkv((2, 40, 4, 2, D), torch.float32, cuda, Sk=0)
    out, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    assert torch.count_nonzero(out) == 0 and torch.isinf(lse).all() and (lse > 0).all()
#: MLA's prefill pair (q/k head dim 192, v head dim 128), deepseek-v2's published widths: (B, S, Hq, Hkv),
#: causal; B = 2 ragged, GQA 16 over 4, lengths off both routes' tiles (64 rows; 32 on the SIMT route)
MLA_GRID = [(1, 404, 16, 16), (2, 77, 4, 4), (1, 132, 16, 4), (1, 1, 2, 2)]


def _mla_qkv(B, S, Hq, Hkv, dtype, device, seed, Sk=None):
    g = torch.Generator().manual_seed(seed)
    Sk = S if Sk is None else Sk
    mk = lambda *sh: torch.randn(*sh, generator=g).to(device=device, dtype=dtype)
    return mk(B, S, Hq, 192), mk(B, Sk, Hkv, 192), mk(B, Sk, Hkv, 128)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MLA_GRID)
def test_mla_pair_matches_plain_on_both_routes(cuda, shape, dtype, causal):
    """(192, 128) on the tensor-core kernel (bf16) and the SIMT one (fp32),
    at MLA's scale (192^-0.5), against the plain version; the output has v's width."""
    q, k, v = _mla_qkv(*shape, dtype, cuda, seed=sum(shape))
    assert fa.select_route(dtype, 192, 128) == ("wgmma" if dtype == torch.bfloat16 else "simt")
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, causal=causal, scale=192 ** -0.5, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and out.shape == (*q.shape[:3], 128)
    want = attention_ref(q, k, v, causal=causal, scale=192 ** -0.5)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, causal=causal, scale=192 ** -0.5), **LSE_TOL)


def test_mla_pair_cross_length_and_empty_kv(cuda):
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _mla_qkv(1, 70, 4, 2, dtype, cuda, seed=3, Sk=150)
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        torch.testing.assert_close(ops.flash_attention(q, k, v, causal=False).float(),
                                   attention_ref(q, k, v, causal=False).float(), **tol)
        q, k, v = _mla_qkv(1, 5, 2, 2, dtype, cuda, seed=4, Sk=0)
        assert torch.count_nonzero(ops.flash_attention(q, k, v, causal=False)) == 0


def test_pairs_without_a_kernel_raise_on_the_card(cuda):
    """A (q/k, v) pair outside FWD_PAIRS raises on a CUDA tensor, naming the
    pairs, and launches nothing; nothing falls back to the plain version."""
    before = fa.flash_attention.launches
    for dtype in (torch.bfloat16, torch.float32):
        q, k, _ = _qkv((1, 16, 2, 2, 64), dtype, cuda)
        with pytest.raises(ValueError, match=r"\(192, 128\)\), got head dims \(q/k 64, v 32\)"):
            ops.flash_attention(q, k, k[..., :32])
        q, k, v = _mla_qkv(1, 16, 2, 2, dtype, cuda, seed=5)
        with pytest.raises(ValueError, match="head dims"):
            ops.flash_attention(q, k, v[..., :64])
        with pytest.raises(ValueError, match="prefix-LM"):  # a prefix is causal self-attention's
            ops.flash_attention(q, k, v, prefix_len=4, causal=False)
    with pytest.raises(ValueError, match="route 'simt' does not take torch.bfloat16"):
        fa.flash_attention(*_mla_qkv(1, 16, 2, 2, torch.bfloat16, cuda, seed=6), route="simt")
    assert fa.flash_attention.launches == before


#: backward in fp32: the kernel and the plain version differ by the order of
#: their fp32 sums over up to 200 rows or columns
BWD_FP32_TOL = dict(atol=1e-4, rtol=1e-4)
#: (B, Sq, Sk, Hq, Hkv, D, causal): every head dim, GQA groups 1, 2, 3 and 4,
#: lengths that are not a multiple of the 64-row (32 at D = 256) tile, and
#: non-causal cross lengths; fp32 runs the SIMT kernel, bf16 the tensor-core
#: one
BWD_GRID = [
    (1, 128, 128, 4, 4, 32, True), (2, 100, 100, 4, 2, 64, True), (1, 70, 150, 6, 2, 64, False),
    (2, 65, 65, 2, 2, 128, True), (1, 200, 90, 4, 1, 128, False), (1, 97, 97, 2, 1, 256, True),
    (2, 40, 77, 4, 2, 256, False), (1, 1, 1, 2, 2, 64, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_GRID)
def test_backward_kernel_matches_plain(cuda, shape, dtype):
    """The forward kernel's lse and the backward kernel's dq, dk, dv against
    the plain versions on the same inputs (the kernel's own o and lse)."""
    B, Sq, Sk, Hq, Hkv, D, causal = shape
    q, k, v = _qkv((B, Sq, Hq, Hkv, D), dtype, cuda, seed=Sq + Sk + D, Sk=Sk)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, causal=causal), **LSE_TOL)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(D)).to(device=cuda, dtype=dtype)
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == before + 1
    want = flash_backward_ref(q, k, v, o, lse, do, causal=causal)
    tol = BWD_FP32_TOL if dtype == torch.float32 else BF16_TOL
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=lambda m: f"d{name}: {m}")


def test_backward_kernel_reads_strided_inputs_and_masked_rows(cuda):
    """q/k/v as slices of one packed projection and a transposed dO (last dim
    contiguous); rows that see no key (Sk = 0) give zero gradients, not nan."""
    qkv = torch.randn(2, 96, 3, 4, 64, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    do = torch.randn(2, 4, 96, 64, device=cuda).transpose(1, 2)
    assert not do.is_contiguous() and do.stride(-1) == 1
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
    for g, w in zip(got, flash_backward_ref(q, k, v, o, lse, do, causal=True)):
        torch.testing.assert_close(g, w, **BWD_FP32_TOL)
    q0, k0, v0 = _qkv((1, 5, 2, 2, 32), torch.float32, cuda, Sk=0)
    o0, lse0 = fa.flash_attention(q0, k0, v0, causal=False, return_lse=True)
    assert torch.isinf(lse0).all() and (lse0 > 0).all()
    dq, dk, dv = fa.flash_attention_backward(q0, k0, v0, o0, lse0, torch.ones_like(o0), causal=False)
    assert torch.count_nonzero(dq) == 0 and dk.shape == (1, 0, 2, 32) and dv.shape == (1, 0, 2, 32)


@pytest.mark.parametrize("D", [32, 128, 256])
def test_backward_kernel_fp32_copies_unaligned_rows(cuda, D):
    """fp32 q, k, v and dO whose rows are not 16-byte aligned (head stride D +
    1 floats) take the SIMT kernel's 4-byte copies and agree with the plain
    backward as the aligned ones do."""
    g = torch.Generator().manual_seed(D)
    q, k, v, do = (torch.randn(1, 70, 3, D + 1, generator=g).to(cuda)[..., :D] for _ in range(4))
    assert q.stride(2) % 4 != 0 and q.stride(-1) == 1
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
    for g_, w in zip(got, flash_backward_ref(q, k, v, o, lse, do, causal=True)):
        torch.testing.assert_close(g_, w, **BWD_FP32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradient_goes_through_both_kernels(cuda, dtype):
    """ops.flash_attention on CUDA tensors that need a gradient: the forward
    kernel once, the backward kernel once, and the gradients of autograd
    through the plain version (an expanded dO from ``sum()`` included)."""
    q, k, v = (t.requires_grad_() for t in _qkv((2, 80, 4, 2, 64), dtype, cuda, seed=5))
    before = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
    out = ops.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out.float().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_backward.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True).float().sum(), (q, k, v))
    tol = BWD_FP32_TOL if dtype == torch.float32 else BF16_TOL
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **tol)


#: the tensor-core backward against the plain one: rtol BWD_RTOL plus
#: BWD_ATOL_OF_MAX of the gradient's largest entry (chip_smoke.py's
#: _grads_close): P and dS enter the products as bf16 terms, and each output
#: is rounded once to bf16.  A gradient that is 0 in exact arithmetic (one
#: query that sees one key: dS = P (dP - D_i) = 0) is held to BWD_ZERO_ATOL,
#: the fp32 noise of dP - D_i summed in two orders, which both the kernel
#: and the plain version leave (measured 3.7e-7 at D = 64 and 5.5e-7 at D =
#: 256 on the H100); every other gradient's BWD_ATOL_OF_MAX share is above it.
BWD_RTOL, BWD_ATOL_OF_MAX, BWD_ZERO_ATOL = 1e-2, 1e-3, 1e-6
#: (B, Sq, Sk, Hq, Hkv, D, causal): every head dim, GQA groups 1-4, MQA at
#: D = 256 (8 q heads on 1 kv head, as paligemma-3b's backbone), ragged
#: lengths (one row, one tile and one row, below one tile), non-causal Sq !=
#: Sk both ways
WGMMA_BWD_GRID = [
    (1, 128, 128, 4, 4, 32, True), (2, 100, 100, 4, 2, 64, True), (1, 65, 65, 8, 2, 128, True),
    (1, 1, 1, 2, 2, 64, True), (1, 70, 150, 6, 2, 64, False), (1, 200, 90, 4, 1, 128, False),
    (2, 40, 77, 4, 4, 32, False), (1, 257, 257, 3, 3, 128, True),
    (1, 130, 130, 16, 16, 256, True), (2, 97, 97, 8, 1, 256, True), (1, 70, 150, 4, 2, 256, False),
    (1, 1, 1, 2, 2, 256, True),
]


def _assert_grads_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        atol = max(BWD_ATOL_OF_MAX * w.abs().max().item(), BWD_ZERO_ATOL)
        torch.testing.assert_close(g, w, rtol=BWD_RTOL, atol=atol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("shape", WGMMA_BWD_GRID)
def test_wgmma_backward_matches_plain(cuda, shape):
    """bf16 at every head dim runs the tensor-core backward: one call, three
    CUDA kernels, against the plain FA-2 backward on the kernel's own o and
    lse; the SIMT backward, asked for by ``route``, agrees too."""
    B, Sq, Sk, Hq, Hkv, D, causal = shape
    assert fa.select_bwd_route(torch.bfloat16, D) == "wgmma"
    q, k, v = _qkv((B, Sq, Hq, Hkv, D), torch.bfloat16, cuda, seed=Sq + 3 * Sk + D, Sk=Sk)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(Sq + D)).to(device=cuda, dtype=torch.bfloat16)
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == before + 1
    want = flash_backward_ref(q, k, v, o, lse, do, causal=causal)
    assert all(g.dtype == torch.bfloat16 and g.shape == w.shape and g.is_contiguous() for g, w in zip(got, want))
    _assert_grads_close(got, want)
    _assert_grads_close(fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal, route="simt"), want)


@pytest.mark.parametrize("D,Hq,Hkv", [(64, 4, 4), (256, 8, 1)])
def test_wgmma_backward_reads_strided_inputs_and_masked_rows(cuda, D, Hq, Hkv):
    """q/k/v as slices of one packed projection (q, k and v heads side by
    side; MQA at D = 256), dO transposed (last dim contiguous,
    16-byte-aligned strides), a scale other than D^-0.5; rows that see no key
    (Sk = 0) give zero dQ, and no query rows (Sq = 0) give zero dK and dV."""
    qkv = torch.randn(2, 96, Hq + 2 * Hkv, D, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    o, lse = fa.flash_attention(q, k, v, causal=True, scale=0.3, return_lse=True)
    do = torch.randn(2, Hq, 96, D, device=cuda).to(torch.bfloat16).transpose(1, 2)
    assert not do.is_contiguous() and do.stride(-1) == 1 and not q.is_contiguous()
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True, scale=0.3)
    _assert_grads_close(got, flash_backward_ref(q, k, v, o, lse, do, causal=True, scale=0.3))
    q0, k0, v0 = _qkv((1, 5, 2, 2, 32), torch.bfloat16, cuda, Sk=0)
    o0, lse0 = fa.flash_attention(q0, k0, v0, causal=False, return_lse=True)
    assert torch.isinf(lse0).all() and (lse0 > 0).all()
    dq, dk, dv = fa.flash_attention_backward(q0, k0, v0, o0, lse0, torch.ones_like(o0), causal=False)
    assert torch.count_nonzero(dq) == 0 and dk.shape == dv.shape == (1, 0, 2, 32)
    q1, k1, v1 = _qkv((1, 0, 2, 2, 32), torch.bfloat16, cuda, Sk=70)
    o1, lse1 = fa.flash_attention(q1, k1, v1, causal=False, return_lse=True)
    dq, dk, dv = fa.flash_attention_backward(q1, k1, v1, o1, lse1, o1, causal=False)
    assert dq.shape == (1, 0, 2, 32) and torch.count_nonzero(dk) == 0 and torch.count_nonzero(dv) == 0


def test_wgmma_backward_refuses_what_it_does_not_take(cuda):
    """A dO whose strides TMA cannot read raises and launches nothing; so does
    a route that does not take the call (nothing falls back)."""
    q, k, v = _qkv((1, 16, 2, 2, 32), torch.bfloat16, cuda)
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    odd = torch.randn(1, 16, 2, 36, device=cuda).to(torch.bfloat16)[..., :32]  # 72-byte head stride
    before = fa.flash_attention_backward.launches
    with pytest.raises(ValueError, match="aligned strides"):
        fa.flash_attention_backward(q, k, v, o, lse, odd, causal=True)
    with pytest.raises(ValueError, match="route 'wgmma'"):
        fa.flash_attention_backward(*(t.float() for t in (q, k, v, o)), lse, o.float(), route="wgmma")
    assert fa.flash_attention_backward.launches == before


#: MLA's backward at (q/k 192, v 128), as chip_smoke.py's mla_bwd_kernel holds it: (B, Sq, Sk, Hq, Hkv,
#: causal): ragged causal lengths (one row, one tile less and more a row, 517), non-causal Sq != Sk both
#: ways, and GQA 16 over 4 (MLA itself runs 16 over 16)
MLA_BWD_GRID = [(1, 1, 1, 4, 4, True), (2, 63, 63, 4, 4, True), (1, 65, 65, 16, 16, True),
                (1, 517, 517, 4, 4, True), (1, 70, 150, 4, 2, False), (2, 150, 45, 4, 4, False),
                (1, 200, 200, 16, 4, True)]


def _mla_backward_inputs(B, Sq, Sk, Hq, Hkv, causal, dtype, device, seed, scale=192 ** -0.5):
    q, k, v = _mla_qkv(B, Sq, Hq, Hkv, dtype, device, seed=seed, Sk=Sk)
    o, lse = fa.flash_attention(q, k, v, causal=causal, scale=scale, return_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(seed + 1)).to(device=device, dtype=dtype)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MLA_BWD_GRID)
def test_mla_backward_matches_plain_on_both_routes(cuda, shape, dtype):
    """The backward at (192, 128): bf16 on the tensor-core kernel (two
    warpgroups split by output), fp32 on the SIMT one (32-row tiles), one
    call each, against the plain FA-2 backward on the kernel's own o and lse;
    dv has v's width."""
    B, Sq, Sk, Hq, Hkv, causal = shape
    assert fa.select_bwd_route(dtype, 192, 128) == ("wgmma" if dtype == torch.bfloat16 else "simt")
    q, k, v, o, lse, do = _mla_backward_inputs(*shape, dtype, cuda, seed=Sq + 3 * Sk + Hkv)
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == before + 1
    want = flash_backward_ref(q, k, v, o, lse, do, causal=causal, scale=192 ** -0.5)
    assert [tuple(g.shape) for g in got] == [(B, Sq, Hq, 192), (B, Sk, Hkv, 192), (B, Sk, Hkv, 128)]
    assert all(g.dtype == dtype and g.is_contiguous() for g in got)
    if dtype == torch.bfloat16:
        _assert_grads_close(got, want)
    else:
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(g, w, **BWD_FP32_TOL, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mla_backward_reads_strided_inputs_and_masked_rows(cuda, dtype):
    """q, k and v at (192, 128) as views of one wider projection (q, k and v
    heads side by side, the last dim contiguous), dO transposed, a scale
    other than 192^-0.5; rows that see no key (Sk = 0) give zero dQ, and no
    query rows (Sq = 0) give zero dK and dV."""
    Hq, Hkv, S = 4, 2, 96
    g = torch.Generator().manual_seed(11)
    wide = torch.randn(2, S, Hq * 192 + Hkv * 192 + Hkv * 128 + 64, generator=g).to(device=cuda, dtype=dtype)
    q = wide[..., :Hq * 192].unflatten(-1, (Hq, 192))
    k = wide[..., Hq * 192:(Hq + Hkv) * 192].unflatten(-1, (Hkv, 192))
    v = wide[..., (Hq + Hkv) * 192:(Hq + Hkv) * 192 + Hkv * 128].unflatten(-1, (Hkv, 128))
    assert not q.is_contiguous() and v.stride(1) == wide.stride(1)
    o, lse = fa.flash_attention(q, k, v, causal=True, scale=0.3, return_lse=True)
    do = torch.randn(2, Hq, S, 128, generator=g).to(device=cuda, dtype=dtype).transpose(1, 2)
    assert not do.is_contiguous() and do.stride(-1) == 1
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True, scale=0.3)
    want = flash_backward_ref(q, k, v, o, lse, do, causal=True, scale=0.3)
    if dtype == torch.bfloat16:
        _assert_grads_close(got, want)
    else:
        for g_, w in zip(got, want):
            torch.testing.assert_close(g_, w, **BWD_FP32_TOL)
    q0, k0, v0 = _mla_qkv(1, 5, 2, 2, dtype, cuda, seed=12, Sk=0)
    o0, lse0 = fa.flash_attention(q0, k0, v0, causal=False, return_lse=True)
    dq, dk, dv = fa.flash_attention_backward(q0, k0, v0, o0, lse0, torch.ones_like(o0), causal=False)
    assert torch.count_nonzero(dq) == 0 and dk.shape == (1, 0, 2, 192) and dv.shape == (1, 0, 2, 128)
    q1, k1, v1 = _mla_qkv(1, 0, 2, 2, dtype, cuda, seed=13, Sk=70)
    o1, lse1 = fa.flash_attention(q1, k1, v1, causal=False, return_lse=True)
    dq, dk, dv = fa.flash_attention_backward(q1, k1, v1, o1, lse1, o1, causal=False)
    assert dq.shape == (1, 0, 2, 192) and torch.count_nonzero(dk) == 0 and torch.count_nonzero(dv) == 0
    assert dv.shape == (1, 70, 2, 128)


def test_backward_refuses_pairs_without_a_kernel(cuda):
    """Any unequal pair but (192, 128) raises on a CUDA tensor, naming the
    pairs the kernels take; so does the SIMT route on bf16 at (192, 128)
    (that kernel takes fp32 alone there); nothing launches and nothing falls
    back to the plain version."""
    before = fa.flash_attention_backward.launches
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _qkv((1, 16, 2, 2, 64), dtype, cuda)
        v = v[..., :32]
        o = torch.zeros(1, 16, 2, 32, device=cuda, dtype=dtype)
        lse = torch.zeros(1, 2, 16, device=cuda)
        with pytest.raises(ValueError, match=r"\(192, 128\)\), got head dims \(q/k 64, v 32\)"):
            fa.flash_attention_backward(q, k, v, o, lse, o, causal=True)
        with pytest.raises(ValueError, match=r"got head dims \(q/k 128, v 192\)"):
            fa.select_bwd_route(dtype, 128, 192)
    args = _mla_backward_inputs(1, 16, 16, 2, 2, True, torch.bfloat16, cuda, seed=14)
    with pytest.raises(ValueError, match="route 'simt' does not take torch.bfloat16 at head dims"):
        fa.flash_attention_backward(*args, causal=True, route="simt")
    with pytest.raises(ValueError, match="route 'wgmma' does not take torch.float32"):
        fa.flash_attention_backward(*(t.float() for t in args), causal=True, route="wgmma")
    assert fa.flash_attention_backward.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mla_flash_attention_function_matches_autograd_through_the_plain_version(cuda, dtype):
    """``ops.flash_attention`` at (192, 128) on CUDA tensors that need a
    gradient goes through ``FlashAttention``: the forward kernel once, the
    backward kernel once, and the gradients of autograd through the plain
    version (an expanded dO from ``sum()`` included)."""
    q, k, v = (t.requires_grad_() for t in _mla_qkv(2, 90, 4, 4, dtype, cuda, seed=15))
    before = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
    out = ops.flash_attention(q, k, v, causal=True, scale=192 ** -0.5)
    got = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_backward.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True, scale=192 ** -0.5).float().square().sum(),
                               (q, k, v))
    assert [g.shape[-1] for g in got] == [192, 192, 128]
    if dtype == torch.bfloat16:
        _assert_grads_close(got, want)
    else:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **BWD_FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 132, 404])
def test_head_dim_256_runs_the_wgmma_kernel_in_bf16(cuda, S, causal):
    """gemma-7b's attention (16 heads of 256) at served lengths: bf16 takes
    the tensor-core kernel (four 64-column chunks a tile), its lse within
    LSE_TOL; the SIMT kernel, asked for by ``route``, agrees too; fp32 stays
    on the SIMT kernel."""
    assert fa.select_route(torch.bfloat16, 256) == "wgmma" and fa.select_route(torch.float32, 256) == "simt"
    q, k, v = _qkv((1, S, 16, 16, 256), torch.bfloat16, cuda, seed=S)
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal).float()
    torch.testing.assert_close(out.float(), want, **BF16_TOL)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, causal=causal), **LSE_TOL)
    simt = fa.flash_attention(q, k, v, causal=causal, route="simt")
    torch.testing.assert_close(simt.float(), want, **BF16_TOL)
    q, k, v = _qkv((1, S, 16, 16, 256), torch.float32, cuda, seed=S)
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal=causal),
                               attention_ref(q, k, v, causal=causal), **FP32_TOL)


def test_gemma_head_dim_256_serves_on_the_card_as_on_the_cpu(cuda):
    """The gemma-7b smoke config at its published head dim of 256, served on
    the card and on the CPU from the same weights: the same greedy tokens and
    statuses, every card prefill through the flash kernel."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Transformer
    from repro_torch.serve import Engine, LoadSpec, ServeConfig, TenantSpec, generate_load, replay_load

    cfg = dataclasses.replace(get_smoke_config("gemma-7b"), head_dim=256)
    cpu_model = Transformer(cfg, device="cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    spec = LoadSpec(tenants=(TenantSpec("solo", rate=0.6, prompt_len=(8, 48), max_new_tokens=(4, 10)),),
                    steps=10, seed=3)
    scfg = ServeConfig(n_slots=4, max_len=128, batch_buckets=(1, 2))
    reqs = {}
    before = fa.flash_attention.launches
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        load = generate_load(spec, cfg.vocab_size)
        replay_load(Engine(model, scfg), load)
        reqs[name] = [r for _, r in load]
    assert fa.flash_attention.launches - before == cfg.n_layers * len(reqs["cuda"])
    assert [r.status for r in reqs["cuda"]] == [r.status for r in reqs["cpu"]]
    assert [r.generated for r in reqs["cuda"]] == [r.generated for r in reqs["cpu"]]
    tokens = torch.as_tensor(reqs["cpu"][0].prompt, dtype=torch.long)[None]
    torch.testing.assert_close(gpu_model.prefill(tokens.to(cuda))[0].cpu(), cpu_model.prefill(tokens)[0],
                               atol=1e-4, rtol=0)


# --------------------------------------------------------------------------- prefix-LM
#: (B, S, Hq, Hkv, D): S off the 64-row tile at head dims 64 and 128, and MQA at D = 256 (paligemma's
#: heads); every prefix at each: none, one key, one short of a tile, a tile, one past it, past S
PREFIX_SHAPES = [(1, 200, 4, 2, 64), (2, 130, 4, 4, 128), (1, 300, 8, 1, 256)]
PREFIX_LENS = (0, 1, 63, 64, 65, 100_000)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prefix_len", PREFIX_LENS)
@pytest.mark.parametrize("shape", PREFIX_SHAPES)
def test_prefix_forward_and_backward_match_plain(cuda, shape, prefix_len, dtype):
    """A causal call whose rows also see the first ``prefix_len`` keys: the
    forward kernel (bf16 on wgmma, fp32 on the CUDA cores), its logsumexp,
    and the backward kernel on its own o and lse, against the plain
    versions with the same prefix.  A kv tile that holds prefix keys is seen
    by every q tile in the dK/dV kernel, the likeliest place for a
    plausible wrong gradient, so the prefixes stop off the tile."""
    B, S, Hq, Hkv, D = shape
    q, k, v = _qkv(shape, dtype, cuda, seed=S + D + prefix_len % 97)
    before = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
    o, lse = fa.flash_attention(q, k, v, causal=True, prefix_len=prefix_len, return_lse=True)
    want = attention_ref(q, k, v, causal=True, prefix_len=prefix_len)
    torch.testing.assert_close(o.float(), want.float(), **(FP32_TOL if dtype == torch.float32 else BF16_TOL))
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, causal=True, prefix_len=prefix_len), **LSE_TOL)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(D + prefix_len % 89)).to(cuda, dtype)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True, prefix_len=prefix_len)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_backward.launches) == (before[0] + 1, before[1] + 1)
    want = flash_backward_ref(q, k, v, o, lse, do, causal=True, prefix_len=prefix_len)
    if dtype == torch.bfloat16:
        _assert_grads_close(got, want)
    else:
        for name, g, w in zip("qkv", got, want):
            torch.testing.assert_close(g, w, **BWD_FP32_TOL, msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", PREFIX_SHAPES)
def test_prefix_of_zero_and_of_all_keys_are_bit_equal_to_causal_and_not(cuda, shape, dtype):
    """``prefix_len = 0`` computes exactly the causal call (bit for bit, in
    both directions), and a prefix of S or more exactly the non-causal one."""
    q, k, v = _qkv(shape, dtype, cuda, seed=shape[1])
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    for prefix_len, causal in ((0, True), (shape[1], False), (100_000, False)):
        o, lse = fa.flash_attention(q, k, v, causal=True, prefix_len=prefix_len, return_lse=True)
        o2, lse2 = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        assert torch.equal(o, o2) and torch.equal(lse, lse2), prefix_len
        for a, b in zip(fa.flash_attention_backward(q, k, v, o, lse, do, causal=True, prefix_len=prefix_len),
                        fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)):
            assert torch.equal(a, b), prefix_len


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefix_gradient_goes_through_both_kernels(cuda, dtype):
    """``ops.flash_attention`` with a prefix and a gradient: the forward and
    the backward kernel each launch once, and the gradient agrees with
    autograd through the plain version; a prefix the kernels cannot take
    raises on the card."""
    q, k, v = (t.requires_grad_() for t in _qkv((1, 300, 8, 1, 256), dtype, cuda, seed=11))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    before = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, prefix_len=100), (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_backward.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True, prefix_len=100), (q, k, v), do)
    if dtype == torch.bfloat16:
        _assert_grads_close(got, want)
    else:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **BWD_FP32_TOL)
    with torch.no_grad():
        for bad in (dict(prefix_len=-1), dict(prefix_len=8, causal=False)):
            with pytest.raises(ValueError, match="prefix-LM"):
                ops.flash_attention(q, k, v, **bad)


@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b"])
def test_encdec_and_prefix_lm_smokes_on_the_card_as_on_the_cpu(cuda, arch):
    """whisper's smoke config at head dim 32 (its own is 16, which no
    kernel takes) and paligemma's, fp32: forward logits and the prefill's
    logits and cache on the card against the CPU, every attention call on
    the kernels (whisper: the encoder's, the decoder's and the
    cross-attention's; paligemma: with its prefix)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Transformer

    cfg = get_smoke_config(arch)
    if cfg.encdec:
        cfg = dataclasses.replace(cfg, n_heads=2, n_kv_heads=2)
    cpu_model = Transformer(cfg, device="cpu", seed=4)
    gpu_model = Transformer(cfg, device="cpu", seed=4).to(cuda)
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 20)), dtype=torch.long)
    kw = {}
    if cfg.encdec:
        kw["enc_embeds"] = torch.as_tensor(rng.standard_normal((2, 70, cfg.d_model)), dtype=torch.float32)
    else:
        kw["vision_embeds"] = torch.as_tensor(rng.standard_normal((2, cfg.vision_tokens, cfg.d_model)),
                                              dtype=torch.float32)
    before = fa.flash_attention.launches
    with torch.no_grad():
        got = gpu_model(toks.to(cuda), **{n: t.to(cuda) for n, t in kw.items()})[0]
        want = cpu_model(toks, **kw)[0]
    torch.cuda.synchronize()
    per_pass = cfg.n_layers * 2 + cfg.n_enc_layers if cfg.encdec else cfg.n_layers
    assert fa.flash_attention.launches - before == per_pass
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    g_logits, g_cache = gpu_model.prefill(toks.to(cuda), **{n: t.to(cuda) for n, t in kw.items()})
    c_logits, c_cache = cpu_model.prefill(toks, **kw)
    torch.testing.assert_close(g_logits.cpu(), c_logits, atol=1e-4, rtol=0)
    assert sorted(g_cache) == sorted(c_cache)
    for key in c_cache:
        torch.testing.assert_close(g_cache[key].cpu(), c_cache[key], atol=1e-4 * c_cache[key].abs().max().item(),
                                   rtol=0)


# --------------------------------------------------------------------------- SSD scan
SSD_SHAPES = [(1, 64, 2, 16, 8, 1), (2, 128, 4, 8, 16, 2), (2, 96, 6, 8, 16, 3), (1, 100, 2, 48, 8, 1)]


def _ssd(shape, dtype, device, seed=0, h0=False):
    B, S, H, P, N, G = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)
    x = mk(B, S, H, P)
    dt = torch.nn.functional.softplus(mk(B, S, H)) * 0.1
    A = -torch.exp(mk(H))
    Bm, Cm = mk(B, S, G, N) * 0.3, mk(B, S, G, N) * 0.3
    D = mk(H) * 0.2
    h = mk(B, H, P, N) * 0.1 if h0 else None
    out = [x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), D, h]
    return [t.to(device) if t is not None else None for t in out]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_fp32_matches_sequential_ref(cuda, shape, h0):
    x, dt, A, Bm, Cm, D, h = _ssd(shape, torch.float32, cuda, seed=shape[1], h0=h0)
    before = sk.ssd_scan.launches
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=32)
    torch.cuda.synchronize()
    assert sk.ssd_scan.launches == before + 1
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h, return_state=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=1e-3)
    torch.testing.assert_close(hf, want_h, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("S", [1, 37, 256])
def test_ssd_kernel_bf16_full_width_matches_ref(cuda, S):
    x, dt, A, Bm, Cm, D, _ = _ssd((1, S, 24, 64, 128, 1), torch.bfloat16, cuda, seed=S)
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, return_state=True)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(hf, want_h, atol=2e-2, rtol=2e-2)


def test_ssd_kernel_reads_strided_inputs_and_its_gradient_is_the_plain_one(cuda):
    # x, B, C and dt as strided slices of one packed projection
    B, S, H, P, N = 2, 80, 4, 16, 8
    packed = torch.randn(B, S, H * P + 2 * N + H, device=cuda)
    packed[..., H * P :] *= 0.3
    packed[..., -H:] = torch.nn.functional.softplus(packed[..., -H:]) * 0.1
    x = packed[..., : H * P].unflatten(-1, (H, P))
    Bm = packed[..., H * P : H * P + N].unflatten(-1, (1, N))
    Cm = packed[..., H * P + N : H * P + 2 * N].unflatten(-1, (1, N))
    dt = packed[..., -H:]
    A = -torch.rand(H, device=cuda) - 0.5
    assert not any(t.is_contiguous() for t in (x, dt, Bm, Cm))
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, hf = ops.ssd_scan(*leaves, chunk=16)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, return_state=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=1e-3)
    (y.square().sum() + hf.sum()).backward()
    plain = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    py, ph = ops.ssd_scan(*plain, chunk=16, impl="plain")
    (py.square().sum() + ph.sum()).backward()
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-3)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm, D, _ = _ssd((1, 16, 2, 8, 8, 1), torch.float16, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=16)
    x, dt, A, Bm, Cm, D, _ = _ssd((1, 16, 2, 8, 8, 1), torch.float32, cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_scan(x, dt.double(), A, Bm, Cm, D, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm, D, chunk=16)
    big = torch.zeros((1, 16, 1, 512), device=cuda)
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_scan(x, dt, A, big, big, D, chunk=16)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("S", [1, 37, 64, 65, 256, 1000])
def test_ssd_wgmma_kernel_matches_sequential_ref(cuda, S, h0):
    """bf16 at mamba2-130m's SSD width runs the tensor-core kernel: one row,
    ragged tiles, one and several chunks, with and without h0."""
    x, dt, A, Bm, Cm, D, h = _ssd((1, S, 24, 64, 128, 1), torch.bfloat16, cuda, seed=S, h0=h0)
    before = sk.ssd_scan.launches
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=256)
    torch.cuda.synchronize()
    assert sk.ssd_scan.launches == before + 1 and sk.select_route(x.dtype) == "wgmma"
    assert "ssd_scan_wgmma" in build._LOADED
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h, return_state=True)
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
    assert ((hf - want_h).norm() / want_h.norm()).item() <= 1e-3


@pytest.mark.parametrize("B,S,H,N,G", [(4, 256, 24, 128, 1), (1, 4096, 24, 128, 1), (2, 300, 4, 64, 2), (3, 130, 6, 128, 3)])
def test_ssd_wgmma_kernel_shapes_and_chunks(cuda, B, S, H, N, G):
    """The timed shapes (1 and 4 tiles per chunk), d_state 64, grouped B/C."""
    x, dt, A, Bm, Cm, D, h = _ssd((B, S, H, 64, N, G), torch.bfloat16, cuda, seed=B * S, h0=True)
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=256)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h, return_state=True)
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
    assert ((hf - want_h).norm() / want_h.norm()).item() <= 1e-3


def test_ssd_wgmma_kernel_reads_strided_inputs(cuda):
    """x, B and C as slices of one packed bf16 projection (16-byte aligned
    strides, as TMA needs), dt a strided fp32 slice, with h0."""
    Bsz, S, H, P, N = 2, 200, 4, 64, 128
    width = H * P + 2 * N + 8
    packed = (torch.randn(Bsz, S, width, device=cuda) * 0.3).to(torch.bfloat16)
    x = packed[..., : H * P].unflatten(-1, (H, P))
    Bm = packed[..., H * P : H * P + N].unflatten(-1, (1, N))
    Cm = packed[..., H * P + N : H * P + 2 * N].unflatten(-1, (1, N))
    dt = (torch.nn.functional.softplus(torch.randn(Bsz, S, 2 * H, device=cuda)) * 0.1)[..., ::2]
    A = -torch.rand(H, device=cuda) - 0.5
    h0 = torch.randn(Bsz, H, P, N, device=cuda) * 0.1
    assert not any(t.is_contiguous() for t in (x, dt, Bm, Cm))
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, None, h0, chunk=8)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, None, h0, return_state=True)
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
    assert ((hf - want_h).norm() / want_h.norm()).item() <= 1e-3


def test_ssd_wgmma_kernel_empty_sequence_passes_h0_through(cuda):
    x, dt, A, Bm, Cm, D, h = _ssd((2, 0, 4, 64, 128, 1), torch.bfloat16, cuda, h0=True)
    y, hf = sk.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=1)
    assert y.shape == (2, 0, 4, 64) and torch.equal(hf, h)


def test_ssd_wgmma_kernel_refuses_what_it_does_not_take(cuda):
    before = sk.ssd_scan.launches
    x, dt, A, Bm, Cm, D, _ = _ssd((1, 64, 2, 32, 128, 1), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=64)
    x, dt, A, Bm, Cm, D, _ = _ssd((1, 64, 2, 64, 256, 1), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=64)
    x, dt, A, Bm, Cm, D, _ = _ssd((1, 64, 2, 64, 128, 1), torch.bfloat16, cuda)
    odd = torch.zeros(1, 64, 2 * 64 + 4, dtype=torch.bfloat16, device=cuda)[..., : 2 * 64].unflatten(-1, (2, 64))
    with pytest.raises(ValueError, match="TMA"):  # a seq stride of 132 elements: not 16-byte aligned
        ops.ssd_scan(odd, dt, A, Bm, Cm, D, chunk=64)
    with pytest.raises(ValueError, match="bf16 only"):
        sk.ssd_scan(x.float(), dt, A, Bm.float(), Cm.float(), D, chunk=64, route="wgmma")
    assert sk.ssd_scan.launches == before


#: head dim 128 on the tensor-core kernel (two warpgroups a block): jamba's SSD width (H 128, P 128, N 128, G 1)
#: at its served prompt lengths, one row, d_state 64 with grouped B/C, and several chunks of a ragged length
P128_SHAPES = [(1, 132, 128, 128, 128, 1), (1, 404, 128, 128, 128, 1), (1, 1, 6, 128, 128, 3),
               (2, 300, 4, 128, 64, 2), (3, 700, 6, 128, 128, 3)]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("shape", P128_SHAPES)
def test_ssd_wgmma_kernel_at_head_dim_128(cuda, shape, h0):
    """bf16 at P = 128 runs the tensor-core kernel, held to the P = 64
    route's tolerances: y within the bf16 tolerance, h_final within 1e-3
    relative L2 of the sequential scan."""
    x, dt, A, Bm, Cm, D, h = _ssd(shape, torch.bfloat16, cuda, seed=sum(shape), h0=h0)
    before = sk.ssd_scan.launches
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=256)
    torch.cuda.synchronize()
    assert sk.ssd_scan.launches == before + 1 and sk.select_route(x.dtype) == "wgmma"
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h, return_state=True)
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
    assert ((hf - want_h).norm() / want_h.norm()).item() <= 1e-3


@pytest.mark.parametrize("B,S,H,G", [(1, 404, 128, 1), (2, 150, 4, 2)])
def test_ssd_fp32_simt_at_head_dim_128(cuda, B, S, H, G):
    """fp32 at P = 128 (two of the SIMT kernel's 64-row state slices) at
    jamba's SSD width and with grouped B/C, with h0."""
    x, dt, A, Bm, Cm, D, h = _ssd((B, S, H, 128, 128, G), torch.float32, cuda, seed=S, h0=True)
    assert sk.select_route(x.dtype) == "simt"
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=S)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h, return_state=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=1e-3)
    torch.testing.assert_close(hf, want_h, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("P", [16, 32, 96, 192, 256])
def test_ssd_wgmma_kernel_refuses_other_head_dims(cuda, P):
    """The bf16 route takes P = 64 and 128 only; any other P raises on a
    CUDA tensor, naming what it takes, and launches nothing."""
    x, dt, A, Bm, Cm, D, _ = _ssd((1, 64, 2, P, 128, 1), torch.bfloat16, cuda)
    before = sk.ssd_scan.launches
    with pytest.raises(ValueError, match=r"head dim in \(64, 128\)"):
        ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=64)
    assert sk.ssd_scan.launches == before


def test_ssd_simt_route_still_takes_bf16(cuda):
    """The SIMT kernel on bf16 (the route the timing asks for beside the
    tensor-core kernel) agrees with the tensor-core kernel and the plain scan."""
    x, dt, A, Bm, Cm, D, h = _ssd((2, 150, 24, 64, 128, 1), torch.bfloat16, cuda, seed=5, h0=True)
    ys, hs = sk.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=256, route="simt")
    yw, hw = sk.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=256)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h, return_state=True)
    for y, hf in ((ys, hs), (yw, hw)):
        torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
        assert ((hf - want_h).norm() / want_h.norm()).item() <= 1e-3


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,S", [(4, 256), (1, 1000), (1, 4096)])
def test_ssd_fp32_full_width_matches_sequential_ref(cuda, B, S, h0):
    """fp32 at mamba2-130m's SSD width (H=24, P=64, N=128) runs the SIMT
    kernels: the training microbatch, a ragged length and train_4k's."""
    x, dt, A, Bm, Cm, D, h = _ssd((B, S, 24, 64, 128, 1), torch.float32, cuda, seed=B + S, h0=h0)
    assert sk.select_route(x.dtype) == "simt"
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=256)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h, return_state=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=1e-3)
    torch.testing.assert_close(hf, want_h, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("P,N", [(72, 200), (6, 5)])
def test_ssd_fp32_state_slices_and_odd_widths(cuda, P, N):
    """A head dim over one 64-row state slice and a d_state padded to 256;
    widths that are not a multiple of 4 (4-byte copies), with h0."""
    x, dt, A, Bm, Cm, D, h = _ssd((2, 150, 4, P, N, 2), torch.float32, cuda, seed=P + N, h0=True)
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=50)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h, return_state=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=1e-3)
    torch.testing.assert_close(hf, want_h, atol=5e-5, rtol=1e-3)


def test_ssd_fp32_unaligned_strides_and_empty_sequence(cuda):
    """x, B and C as slices of one packed projection at an odd offset (the
    4-byte copies), with h0; S = 0 passes h0 through as h_final."""
    Bsz, S, H, P, N = 2, 130, 4, 32, 64
    packed = (torch.randn(Bsz, S, H * P + 2 * N + 1, device=cuda) * 0.3)[..., 1:]
    x = packed[..., : H * P].unflatten(-1, (H, P))
    Bm = packed[..., H * P : H * P + N].unflatten(-1, (1, N))
    Cm = packed[..., H * P + N :].unflatten(-1, (1, N))
    dt = torch.nn.functional.softplus(torch.randn(Bsz, S, H, device=cuda)) * 0.1
    A = -torch.rand(H, device=cuda) - 0.5
    h0 = torch.randn(Bsz, H, P, N, device=cuda) * 0.1
    assert x.data_ptr() % 16 != 0
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, None, h0, chunk=130)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, None, h0, return_state=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=1e-3)
    torch.testing.assert_close(hf, want_h, atol=5e-5, rtol=1e-3)
    x, dt, A, Bm, Cm, D, h = _ssd((2, 0, 4, 16, 8, 1), torch.float32, cuda, h0=True)
    before = sk.ssd_scan.launches
    y, hf = sk.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=1)
    assert sk.ssd_scan.launches == before + 1
    assert y.shape == (2, 0, 4, 16) and torch.equal(hf, h)


# --------------------------------------------------------------------------- the simulator's landing
def _events(n, n_segs, row_size, seed, big=False):
    """seg (with overflow rows past n_segs), lin, cnt as int64 storage on the CPU."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_segs + 2, size=n)
    lin = rng.integers(0, row_size, size=n)
    cnt = rng.integers(1, 50, size=n).astype(np.uint64)
    if big:  # counts near 2**64 and 2**63, so the sums wrap
        cnt = np.where(rng.random(n) < 0.5, np.uint64((1 << 64) - 1000), np.uint64((1 << 63) - 10))
    return torch.from_numpy(seg), torch.from_numpy(lin), torch.from_numpy(cnt.view(np.int64))


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("n,n_segs,row_size", [(2000, 1, 8), (2000, 5, 64), (2000, 16, 300), (100_000, 40, 1152)])
def test_segment_kernel_matches_plain_bit_for_bit(cuda, n, n_segs, row_size, big):
    seg, lin, cnt = _events(n, n_segs, row_size, seed=n_segs * row_size, big=big)
    want, want_bad = segment_scatter_ref(seg, lin, cnt, n_segs, row_size)
    before = ss.segment_scatter.launches
    table, bad = ss.segment_scatter(seg.to(cuda), lin.to(cuda), cnt.to(cuda), n_segs, row_size)
    torch.cuda.synchronize()
    assert ss.segment_scatter.launches == before + 1
    assert torch.equal(table.cpu(), want) and bad.item() == want_bad.item() == 0


def test_segment_kernel_edges(cuda):
    before = ss.segment_scatter.launches
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    table, bad = ss.segment_scatter(e, e, e, 3, 5)
    assert table.shape == (3, 5) and table.count_nonzero() == 0 and bad.item() == 0
    seg = torch.full((64,), 9, dtype=torch.int64, device=cuda)
    zero = torch.zeros(64, dtype=torch.int64, device=cuda)
    assert ss.segment_scatter(seg, zero, zero + 1, 0, 16)[0].shape == (0, 16)
    assert ss.segment_scatter.launches == before  # empty input and no rows launch nothing
    table, bad = ss.segment_scatter(seg, zero, zero + 1, 4, 16)  # every event past the last row
    assert table.count_nonzero() == 0 and bad.item() == 0
    out_of_table = torch.tensor([0, 3], device=cuda)
    table, bad = ss.segment_scatter(torch.tensor([0, 1], device=cuda), out_of_table, out_of_table, 2, 2)
    assert bad.item() == 1 and table.tolist() == [[0, 0], [0, 0]]
    assert ss.segment_scatter.launches == before + 2


@pytest.mark.parametrize("order", ["shuffled", "sorted"])
@pytest.mark.parametrize("offset", [0, 1])
def test_segment_kernel_heavy_duplication(cuda, order, offset):
    """All events on 3 cells (most lanes of a window share a key), shuffled
    or sorted, with 16-byte loads (offset 0) and with columns one element
    off that alignment (offset 1: 8-byte loads); counts that wrap."""
    rng = np.random.default_rng(21)
    n = 300_001
    cells = np.array([[0, 5], [2, 1151], [7, 300]])
    pick = rng.integers(0, 3, size=n)
    seg, lin = cells[pick, 0], cells[pick, 1]
    if order == "sorted":
        idx = np.argsort(seg, kind="stable")
        seg, lin = seg[idx], lin[idx]
    cnt = np.where(rng.random(n) < 0.5, np.uint64((1 << 64) - 1000), rng.integers(1, 9, size=n).astype(np.uint64))
    cols = [torch.from_numpy(np.ascontiguousarray(a).view(np.int64)) for a in (seg, lin, cnt)]
    want, want_bad = segment_scatter_ref(*cols, 8, 1152)
    dev = [torch.cat([c[:1], c]).to(cuda)[1:] if offset else c.to(cuda) for c in cols]
    assert all((c.data_ptr() % 16 == 0) == (offset == 0) for c in dev)
    table, bad = ss.segment_scatter(*dev, 8, 1152)
    assert torch.equal(table.cpu(), want) and bad.item() == want_bad.item() == 0
    dense = torch.zeros(8 * 1152, dtype=torch.int64, device=cuda)
    flat = (cols[0] * 1152 + cols[1]).to(cuda)
    assert ss.scatter_add(dense, flat, dev[2]).item() == 0
    assert torch.equal(dense.cpu(), want.reshape(-1))


@pytest.mark.parametrize("big", [False, True])
def test_accumulate_entry_matches_plain(cuda, big):
    _, lin, cnt = _events(50_000, 0, 4096, seed=3, big=big)
    base = torch.from_numpy(np.random.default_rng(4).integers(0, 1 << 40, size=4096))
    want = base.clone()
    assert scatter_add_ref(want, lin, cnt).item() == 0
    dense = base.to(cuda)
    before = ss.scatter_add.launches
    assert ss.scatter_add(dense, lin.to(cuda), cnt.to(cuda)).item() == 0
    assert ss.scatter_add.launches == before + 1
    assert torch.equal(dense.cpu(), want)


@pytest.mark.parametrize("shape", [(1,), (257,), (7367,), (64, 3), (300, 9)])
def test_fold_kernel_matches_plain_bit_for_bit(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    # adversarial magnitudes so any reassociation changes the rounding
    vals = rng.uniform(-1.0, 1.0, size=shape) * (10.0 ** rng.integers(-8, 8, size=shape))
    before = ss.running_sum.launches
    got = ss.running_sum(torch.from_numpy(vals).to(cuda)).cpu()
    assert ss.running_sum.launches == before + 1
    assert torch.equal(got, running_sum_ref(torch.from_numpy(vals)))
    assert np.array_equal(got.numpy(), np.add.accumulate(vals, axis=0))
    ints = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, size=shape))
    assert torch.equal(ss.running_sum(ints.to(cuda)).cpu(), running_sum_ref(ints))


@pytest.mark.parametrize("shape", [(3000, 40), (40, 300), (9000, 2), (5, 1000)])
def test_fold_kernel_chunks_and_column_blocks(cuda, shape):
    """Inputs taller than one staged chunk (the carry crosses chunks) and
    wider than one block's columns fold bit for bit, and a leading -0.0
    stays -0.0 (the fold starts from the first value, not from 0)."""
    rng = np.random.default_rng(shape[0])
    vals = rng.uniform(-1.0, 1.0, size=shape) * (10.0 ** rng.integers(-8, 8, size=shape))
    vals[0, ::3] = -0.0
    got = ss.running_sum(torch.from_numpy(vals).to(cuda)).cpu().numpy()
    assert np.array_equal(got, np.add.accumulate(vals, axis=0))
    assert np.signbit(got[0, ::3]).all()
    ints = rng.integers(-(1 << 62), 1 << 62, size=shape)
    got = ss.running_sum(torch.from_numpy(ints).to(cuda)).cpu().numpy()
    assert np.array_equal(got, np.add.accumulate(ints, axis=0))


def test_batched_sweep_on_the_card_equals_numpy(cuda):
    from repro_torch.core.array_ops import get_backend
    from repro_torch.sim.batch import BatchJob, BatchRunner
    from repro_torch.sim.scenarios import divergent_draws

    ops = get_backend("torch")
    calls = {"segment_scatter": 0, "scatter_add_u64": 0}
    seg_op, add_op = ops.segment_scatter, ops.scatter_add_u64

    def seg_counted(seg, lin, cnt, n_segs, row_size):
        calls["segment_scatter"] += int(len(seg) > 0 and n_segs > 0)
        return seg_op(seg, lin, cnt, n_segs, row_size)

    def add_counted(dense, lin, cnt):
        calls["scatter_add_u64"] += int(len(lin) > 0)
        return add_op(dense, lin, cnt)

    draws = divergent_draws(4, seed=0)
    runs = {}
    for backend in ("torch", "numpy"):
        jobs = [BatchJob.make(d["scenario"], d["params"], config=dict(array_backend=backend)) for d in draws]
        before = (ss.segment_scatter.launches, ss.scatter_add.launches)
        ops.segment_scatter, ops.scatter_add_u64 = seg_counted, add_counted
        try:
            runs[backend] = BatchRunner(jobs, backend="batched").run()
        finally:
            del ops.segment_scatter, ops.scatter_add_u64
        launched = (ss.segment_scatter.launches - before[0], ss.scatter_add.launches - before[1])
        if backend == "torch":
            assert launched == (calls["segment_scatter"], calls["scatter_add_u64"])
            assert launched[0] >= 1 and launched[1] >= len(jobs) // 2
        else:
            assert launched == (0, 0)
    assert runs["torch"].failures() == [] and runs["torch"].oracle_failures() == []
    assert runs["torch"].signature() == runs["numpy"].signature()


# --------------------------------------------------------------------------- distribution
@pytest.fixture
def nccl_world(cuda):
    """A one-rank NCCL process group over an in-process store, destroyed after the test."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


def test_ef_compress_on_the_card_equals_its_cpu_result(cuda):
    from repro_torch.optim import ef_compress, ef_state_init

    g = torch.Generator().manual_seed(0)
    names = [f"layers.{i}.attn.wq" for i in range(3)] + ["embed.embedding"]
    groups = {n: "blocks/pos_0/attn/wq" if n.startswith("layers") else n for n in names}
    cpu_ef = ef_state_init({n: torch.zeros(64, 48) for n in names})
    card_ef = {n: e.to(cuda) for n, e in cpu_ef.items()}
    for step in range(4):
        grads = {n: (torch.randn(64, 48, generator=g) * 10.0 ** -i).to(torch.bfloat16) for i, n in enumerate(names)}
        want, cpu_ef = ef_compress(grads, cpu_ef, groups)
        got, card_ef = ef_compress({n: t.to(cuda) for n, t in grads.items()}, card_ef, groups)
        for n in names:
            assert torch.equal(got[n].cpu(), want[n]), (step, n)
            assert torch.equal(card_ef[n].cpu(), cpu_ef[n]), (step, n)


def test_nccl_mesh_round_trip_is_bit_equal(nccl_world):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.launch.mesh import make_tiny_mesh
    from repro_torch.launch.shardings import make_plan
    from repro_torch.models import Transformer
    from repro_torch.models.params import iter_leaves

    mesh = make_tiny_mesh(data=1, model=1)
    assert mesh.device_type == "cuda"
    cfg = get_smoke_config("deepseek-7b")
    plan = make_plan(cfg, SHAPES["train_4k"], mesh)
    placements = {p.replace("/", "."): pl for p, pl in iter_leaves(plan.placements(plan.param_specs))}
    model = Transformer(cfg, device=nccl_world, seed=0)
    for name, p in model.named_parameters():
        d = distribute_tensor(p.detach(), mesh, placements[name])
        assert torch.equal(d.full_tensor(), p.detach()), name


def test_one_stage_pipeline_equals_the_sequential_stack(nccl_world):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train.pipeline import pipeline_forward, split_stages

    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    g = torch.Generator().manual_seed(1)
    w = (torch.randn(4, 64, 64, generator=g) / 8).to(nccl_world)
    b = torch.randn(4, 64, generator=g).to(nccl_world)
    xs = torch.randn(3, 2, 16, 64, generator=g).to(nccl_world)
    fn = lambda lp, x: torch.tanh(x @ lp["w"] + lp["b"])
    out = pipeline_forward(split_stages({"w": w, "b": b}, 1), xs, fn, mesh, "stage")
    want = []
    for x in xs:
        for i in range(4):
            x = fn({"w": w[i], "b": b[i]}, x)
        want.append(x)
    assert torch.equal(out, torch.stack(want))


def test_adamw_on_bf16_gradients_equals_its_cpu_result(cuda):
    """The compressed path's bf16 accumulator reaches AdamW as bf16 (type
    promotion op by op, the foreach ops' per-tensor route): the card's update
    is the CPU's, and the CPU's is its fp32 copies' (test_torch_grad_compress)."""
    from repro_torch.optim import adamw_init, adamw_update

    g = torch.Generator().manual_seed(0)
    params = {f"p{i}": torch.randn(64, 33, generator=g).to(torch.bfloat16) for i in range(3)}
    grads = {n: (torch.randn(p.shape, generator=g) * 3).to(torch.bfloat16) for n, p in params.items()}
    out = {}
    for dev in ("cpu", cuda):
        p = {n: t.clone().to(dev) for n, t in params.items()}
        st = adamw_init(p)
        for _ in range(3):
            st = adamw_update({n: t.to(dev) for n, t in grads.items()}, st, p, 1e-2)
        out[str(dev)] = (p, st)
    (a, sa), (b, sb) = out["cpu"], out["cuda"]
    for n in params:  # fp32 elementwise noise (the card may fuse a multiply-add); bf16 weights within one rounding
        torch.testing.assert_close(b[n].cpu().float(), a[n].float(), rtol=2 ** -8, atol=1e-7)
        torch.testing.assert_close(sb["m"][n].cpu(), sa["m"][n], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(sb["v"][n].cpu(), sa["v"][n], rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------- the cost count (perf.cost)
def _one_rank_cell(arch, kind, cfg=None):
    """A smoke cell of ``arch`` from ``launch.steps.build_cell`` on a one-rank
    (data 1, model 1) mesh over torch's ``fake`` process group (placements
    only; nothing is communicated)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.launch.mesh import make_tiny_mesh
    from repro_torch.launch.steps import build_cell

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = make_tiny_mesh(data=1, model=1, device_type="cpu")
        return build_cell(arch, cfg or get_smoke_config(arch), ShapeConfig("smoke", 64, 2, kind), mesh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,kind", [("deepseek-7b", "prefill"), ("deepseek-7b", "train"),
                                       ("mamba2-130m", "prefill"), ("mamba2-130m", "train")])
def test_fake_count_equals_the_card_run(cuda, arch, kind):
    """A smoke cell counted on fake copies of its card inputs equals its count
    on fake CPU tensors, and the launches the count prices are the ones a real
    run of the cell makes on the card: the fp32 flash kernels (deepseek-7b at
    head dim 32) and the SSD kernel (mamba2)."""
    from repro_torch.launch.steps import materialize
    from repro_torch.perf.cost import count_cell

    cell = _one_rank_cell(arch, kind)
    args = materialize(cell, "cuda", seed=3)
    card, host = count_cell(cell, args=args), count_cell(cell, device="cpu")
    assert card.to_dict() == host.to_dict() and card.parts == host.parts and card.launches == host.launches
    before = (Counter(fa.flash_attention.shapes), Counter(fa.flash_attention_backward.shapes), sk.ssd_scan.launches)
    cell.fn(*args)
    torch.cuda.synchronize()
    assert Counter(fa.flash_attention.shapes) - before[0] == card.launches["flash_forward"]
    assert Counter(fa.flash_attention_backward.shapes) - before[1] == card.launches["flash_backward"]
    assert sk.ssd_scan.launches - before[2] == sum(card.launches["ssd_kernel"].values())
    assert sum(card.launches["flash_forward"].values()) + sum(card.launches["ssd_kernel"].values()) > 0


def test_a_real_cuda_tensor_never_takes_the_fake_branch(cuda):
    q, k, v = _qkv((1, 64, 2, 2, 64), torch.bfloat16, cuda)
    fake_before = (Counter(fa.flash_attention.fake_shapes), Counter(sk.ssd_scan.fake_shapes))
    launches = (fa.flash_attention.launches, sk.ssd_scan.launches)
    out = fa.flash_attention(q, k, v, causal=True)
    x = torch.randn(1, 64, 2, 64, device=cuda)
    dt = torch.rand(1, 64, 2, device=cuda)
    A = -torch.rand(2, device=cuda)
    Bm, Cm = (torch.randn(1, 64, 1, 16, device=cuda) for _ in range(2))
    y, _ = sk.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    torch.cuda.synchronize()
    assert not fa.is_fake(out) and not fa.is_fake(y)
    assert (fa.flash_attention.launches, sk.ssd_scan.launches) == (launches[0] + 1, launches[1] + 1)
    assert (Counter(fa.flash_attention.fake_shapes), Counter(sk.ssd_scan.fake_shapes)) == fake_before
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, causal=True).float(), atol=2e-2, rtol=1e-2)


def test_two_seeded_moe_training_runs_are_bit_identical(cuda):
    """The smallest MoE training cut (deepseek-v2-lite's smoke config at
    deepseek-v2's published MLA head dims, fp32) trained twice from one seed
    on one batch stream: every parameter and moment bit for bit the same after
    three steps.  The MoE dispatch's gather sums each token's k gradient rows
    in order (``models.moe.gather_tokens``), where autograd's scatter_add
    added them by atomics in a run-dependent order."""
    import dataclasses

    from repro_torch.configs import MLAConfig, get_smoke_config
    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.train import TrainConfig, Trainer

    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"),
                              mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128))
    runs = []
    for _ in range(2):
        it = make_train_iter(DataConfig(global_batch=4, seq_len=64, vocab_size=cfg.vocab_size))
        tr = Trainer(cfg, TrainConfig(microbatches=2), it, device="cuda")
        model, opt = tr.restore_or_init()
        model, opt, hist = tr.run(model, opt, 3)
        it.close()
        runs.append(({n: p.detach().cpu() for n, p in model.named_parameters()},
                     {n: t.cpu() for n, t in opt["m"].items()}, [h["loss"] for h in hist]))
    (p1, m1, l1), (p2, m2, l2) = runs
    assert l1 == l2
    assert [n for n in p1 if not torch.equal(p1[n], p2[n])] == []
    assert [n for n in m1 if not torch.equal(m1[n], m2[n])] == []
