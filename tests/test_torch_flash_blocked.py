"""The blocked online-softmax plain version and the flash kernels' routing, on the CPU.

``flash_blocked_ref`` is the port of the reference's ``_xla_flash``
(``repro/kernels/ops.py:38``), held against it here in fp32.  With P carried
in bf16 before the second product (``p_bf16_terms``) it computes what the
bf16 tensor-core kernel computes, so holding that form to the bf16 tolerance
against the full-softmax ``attention_ref`` holds the kernel's rounding
points to it before any card run.  The kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_ref, flash_blocked_ref

SHAPES = [  # tests/test_kernels.py's set: MHA, GQA, MQA with a ragged seq, seq < block
    (1, 128, 4, 4, 32),
    (2, 256, 8, 2, 64),
    (1, 192, 6, 1, 64),
    (2, 64, 2, 2, 128),
]
FP32 = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=1e-2)  # chip_smoke.py's BF16_TOL: bf16 keeps 8 significant bits


def _qkv(B, Sq, Hq, Hkv, D, seed=0, Sk=None, Dv=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, Dv or D)).astype(np.float32)
    return q, k, v


def _xla(q, k, v, **kw):
    D = q.shape[-1]
    out = ref_ops._xla_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=D ** -0.5, **kw)
    return np.asarray(out)


@pytest.mark.parametrize("blocks", [(64, 64), (256, 1024)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", SHAPES)
def test_blocked_matches_reference_xla_flash(B, S, Hq, Hkv, D, causal, blocks):
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=S + D)
    qb, kb = blocks
    want = _xla(q, k, v, causal=causal, prefix_len=0, q_block=qb, kv_block=kb)
    got = flash_blocked_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_block=qb, kv_block=kb,
    )
    assert got.dtype == torch.float32 and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("case", ["prefix_lm", "mla_dv", "cross_length"])
def test_blocked_matches_reference_on_the_paths_it_exists_for(case):
    """The reference sends prefix-LM masking and Dv != D (MLA) to its blocked
    form (``ops.py:145``); non-causal attention may have Sk != Sq."""
    kw = dict(prefix_len=0, q_block=64, kv_block=64)
    if case == "prefix_lm":
        q, k, v = _qkv(1, 160, 4, 2, 32, seed=11)
        kw.update(causal=True, prefix_len=40)
    elif case == "mla_dv":
        q, k, v = _qkv(2, 96, 4, 4, 64, seed=12, Dv=32)
        kw.update(causal=True)
    else:
        q, k, v = _qkv(1, 48, 6, 3, 32, seed=13, Sk=150)
        kw.update(causal=False)
    want = _xla(q, k, v, **kw)
    got = flash_blocked_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    full = attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=kw["causal"], prefix_len=kw["prefix_len"],
    )
    np.testing.assert_allclose(got.numpy(), full.numpy(), **FP32)


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("sharp", [1.0, 8.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", SHAPES + [(1, 300, 4, 4, 128), (1, 65, 2, 1, 32)])
def test_bf16_p_rounding_stays_within_bf16_tolerance(B, S, Hq, Hkv, D, causal, sharp, terms):
    """The tensor-core kernel's rounding points: bf16 q/k/v, fp32 scores and
    softmax state, P in bf16 before ``P V`` (one term, or hi + lo as the
    kernel carries it), 64 x 64 tiles.  ``sharp`` scales q so that softmax is
    near one-hot, as at the reference's init at full width."""
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=3 * S + D)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q * sharp, k, v))
    got = flash_blocked_ref(tq, tk, tv, causal=causal, q_block=64, kv_block=64, p_bf16_terms=terms)
    want = attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    if terms == 1:  # and the rounding is really there: without it the blocked form differs
        unrounded = flash_blocked_ref(tq, tk, tv, causal=causal, q_block=64, kv_block=64)
        assert not torch.equal(got, unrounded)


def test_one_bf16_rounding_of_p_misses_the_tolerance_on_a_cancelling_row():
    """Why the kernel carries P as two bf16 terms.  At deepseek-7b full width
    (|v| up to ~60, near one-hot attention) rows where two keys' p v nearly
    cancel miss the bf16 tolerance when P is rounded once.  One such row: p
    = (1, ~0.7) over v = (56, -80), whose output is ~0."""
    D = 32
    q = torch.zeros(1, 1, 1, D)
    k = torch.zeros(1, 2, 1, D)
    v = torch.zeros(1, 2, 1, D)
    q[..., 0] = 4.0
    k[0, 1, 0, 0] = math.log(0.7) / (4.0 * D ** -0.5)
    v[0, 0], v[0, 1] = 56.0, -80.0
    tq, tk, tv = (t.to(torch.bfloat16) for t in (q, k, v))
    want = attention_ref(tq, tk, tv, causal=False).float()
    assert want.abs().max() < 0.02  # the row cancels
    one = flash_blocked_ref(tq, tk, tv, causal=False, q_block=64, kv_block=64, p_bf16_terms=1).float()
    two = flash_blocked_ref(tq, tk, tv, causal=False, q_block=64, kv_block=64, p_bf16_terms=2).float()
    assert not torch.allclose(one, want, **BF16_TOL)
    torch.testing.assert_close(two, want, **BF16_TOL)
    assert (two - want).abs().max() < 1e-3
    with pytest.raises(ValueError, match="p_bf16_terms"):
        flash_blocked_ref(tq, tk, tv, p_bf16_terms=3)


def test_route_selection():
    """Forward and backward: bf16 at every head dim on the tensor-core kernels
    (head dim 256, gemma-7b's and paligemma-3b's, included), fp32 on the SIMT
    ones; head dim 16 (the qwen2 and whisper smoke configs') zero-padded to
    32."""
    assert fa.SUPPORTED_HEAD_DIMS == (16, 32, 64, 128, 256) and fa.PAD_D16 == 32
    assert fa.FWD_PAIRS == ((16, 16), (32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
    for D in fa.SUPPORTED_HEAD_DIMS:
        assert fa.select_route(torch.bfloat16, D) == "wgmma"
        assert fa.select_route(torch.float32, D) == "simt"
        assert fa.select_bwd_route(torch.bfloat16, D) == "wgmma"
        assert fa.select_bwd_route(torch.float32, D) == "simt"
    for select in (fa.select_route, fa.select_bwd_route):
        for dtype in (torch.float16, torch.float64, torch.int32, torch.float8_e4m3fn):
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                select(dtype, 64)
        for D in (8, 48, 96, 512):
            with pytest.raises(ValueError, match="head dim"):
                select(torch.bfloat16, D)
    assert set(fa.ROUTES.values()) == {"wgmma", "simt"}
    assert fa.SOURCE.endswith("flash_attention_wgmma.cu") and fa.SIMT_SOURCE.endswith("flash_attention.cu")
    assert fa.BWD_SOURCE.endswith("flash_attention_bwd_wgmma.cu")
    assert fa.BWD_SIMT_SOURCE.endswith("flash_attention_bwd.cu")


def test_route_argument_the_kernels_refuse_raises_on_any_device():
    """``route=`` names a kernel for timing beside the chosen one; a kernel
    that does not take the call's dtype or head dim is refused before any
    device branch, so the CPU path raises as the card's would."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 64, seed=5))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    with pytest.raises(ValueError, match="route 'wgmma' does not take torch.float32"):
        fa.flash_attention_backward(q, k, v, o, lse, o, route="wgmma")
    with pytest.raises(ValueError, match="route 'wgmma' does not take torch.float32"):
        fa.flash_attention(q, k, v, route="wgmma")
    b16 = [t.to(torch.bfloat16) for t in (q, k, v, o)]
    with pytest.raises(ValueError, match="route 'simt' does not take torch.bfloat16 at head dim 64"):
        fa.flash_attention(*b16[:3], route="simt")  # the SIMT forward takes bf16 at 256 only
    with pytest.raises(ValueError, match="route 'triton'"):
        fa.flash_attention_backward(*b16, lse, b16[3], route="triton")
    q256, k256, v256 = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 8, 2, 2, 256, seed=6))
    o256, lse256 = fa.flash_attention(q256, k256, v256, causal=True, return_lse=True, route="simt")
    # bf16 at 256 takes the tensor-core backward as every head dim does; fp32 there does not
    got = fa.flash_attention_backward(q256, k256, v256, o256, lse256, o256, route="wgmma")
    want = fa.flash_attention_backward(q256, k256, v256, o256, lse256, o256)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="route 'wgmma' does not take torch.float32 at head dim 256"):
        fa.flash_attention_backward(*(t.float() for t in (q256, k256, v256, o256)), lse256, o256.float(), route="wgmma")
    # a route the kernels take runs the plain version on the CPU
    got = fa.flash_attention_backward(*b16, lse, b16[3], route="simt")
    want = fa.flash_attention_backward(*b16, lse, b16[3])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_tma_strides_of_contiguous_and_packed_inputs():
    t = torch.zeros((2, 96, 4, 64), dtype=torch.bfloat16)
    assert fa.tma_strides(t) == t.stride()[:3]
    packed = torch.zeros((2, 96, 3, 4, 64), dtype=torch.bfloat16)  # q/k/v as slices of one projection
    q = packed[:, :, 1]
    assert not q.is_contiguous() and fa.tma_strides(q) == q.stride()[:3]
    # a dimension of size 1 is never stepped: its stride becomes the extent inside it
    one = torch.zeros((1, 1, 32, 128), dtype=torch.bfloat16)[:, :, :, :]
    b_stride, s_stride, h_stride = fa.tma_strides(one.as_strided(one.shape, (7, 3, 128, 1)))
    assert (s_stride, h_stride, b_stride) == (128, 128, 128 * 32)


def test_tma_strides_refuse_misaligned_inputs():
    buf = torch.zeros((1, 16, 2, 40), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned base"):
        fa.tma_strides(buf[..., 1:33])  # base 2 bytes past an aligned address
    with pytest.raises(ValueError, match="aligned strides"):
        fa.tma_strides(torch.zeros((1, 16, 2, 36), dtype=torch.bfloat16)[..., :32])  # 72-byte head stride
    with pytest.raises(ValueError, match="contiguous"):
        fa.tma_strides(torch.zeros((1, 16, 32, 2), dtype=torch.bfloat16).transpose(2, 3))
