"""The port's attention ops against the reference's, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.  The
reference's flash attention runs as its own kernel tests run it here: the
Pallas kernel in interpret mode.  On the CPU the port's wrapper computes its
plain version; the CUDA kernel itself is held against that plain version on
the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_ref

SHAPES = [  # tests/test_kernels.py's set: MHA, GQA, MQA with a ragged seq, seq < block
    (1, 128, 4, 4, 32),
    (2, 256, 8, 2, 64),
    (1, 192, 6, 1, 64),
    (2, 64, 2, 2, 128),
]
FP32 = dict(atol=2e-5, rtol=1e-4)
BF16_ATOL = 2e-2  # as tests/test_kernels.py: bf16 keeps 8 significant bits


def _qkv(B, Sq, Hq, Hkv, D, seed=0, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", SHAPES)
def test_flash_fp32_matches_pallas_and_ref(B, S, Hq, Hkv, D, causal):
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=S + D)
    pallas = ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, impl="pallas", q_block=64, kv_block=64,
    )
    jref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    assert out.dtype == torch.float32 and out.shape == (B, S, Hq, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **FP32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **FP32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_matches_pallas(causal):
    q, k, v = _qkv(2, 128, 4, 2, 32, seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    pallas = ref_ops.flash_attention(jq, jk, jv, causal=causal, impl="pallas", q_block=64, kv_block=64)
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(pallas, np.float32), atol=BF16_ATOL, rtol=1e-2
    )


def test_plain_impl_equals_auto_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 4, 2, 32, seed=5))
    assert torch.equal(ops.flash_attention(q, k, v, impl="plain"), ops.flash_attention(q, k, v))


def test_prefix_lm_plain_matches_reference():
    q, k, v = _qkv(1, 96, 4, 4, 32, seed=6)
    jref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, prefix_len=32)
    out = ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True, prefix_len=32
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **FP32)


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (6, 1)])
def test_decode_attention_ragged_lengths_match_reference(Hq, Hkv):
    rng = np.random.default_rng(Hq * 10 + Hkv)
    B, S, D = 3, 40, 32
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lens = np.array([1, 17, 40], np.int32)
    want = ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens))
    got = ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(lens).long()
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    # a scalar length broadcasts over the batch, as in the reference
    want_s = ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 9)
    got_s = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), 9)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **FP32)


def test_fully_masked_rows_give_zeros():
    """A row that sees no key gives 0, as the flash kernels do (Pallas
    ``flash_attention.py:113``).  The reference's ``attention_ref`` instead
    averages v over such a row (softmax of equal scores); the port's plain
    version follows the kernels."""
    q, k, v = _qkv(2, 8, 2, 2, 32, seed=8)
    lens = np.array([0, 8])
    out = attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=False, kv_len=torch.from_numpy(lens),
    )
    assert torch.count_nonzero(out[0]) == 0
    jref = jax_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False, kv_len=jnp.asarray(lens)
    )
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jref)[1], **FP32)
    assert np.abs(np.asarray(jref)[0]).max() > 0  # the reference's mean-of-v row
    # no keys at all: every row is fully masked
    q0, k0, v0 = _qkv(1, 5, 2, 2, 32, seed=9, Sk=0)
    empty = ops.flash_attention(torch.from_numpy(q0), torch.from_numpy(k0), torch.from_numpy(v0), causal=False)
    assert empty.shape == (1, 5, 2, 32) and torch.count_nonzero(empty) == 0


def test_causal_needs_equal_lengths():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 32, Sk=24))
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.flash_attention(q, k, v, causal=True)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    with pytest.raises(ValueError):  # the reference's kernel refuses it too (:137)
        ref_ops.flash_attention(jq, jk, jv, causal=True, impl="pallas")
    # non-causal cross-length attention is fine
    out = ops.flash_attention(q, k, v, causal=False)
    jref = jax_attention_ref(jq, jk, jv, causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **FP32)


def test_bad_inputs_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 6, 4, 32))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, v, causal=False)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, k[..., :16], v, causal=False)
    with pytest.raises(ValueError, match="shape"):  # Dv != D is ops' to route, not the kernel's
        fa.flash_attention(q, k, v[..., :16], causal=False)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q, k, v, impl="pallas")


def test_non_cpu_tensors_never_take_the_plain_version():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    another device (here ``meta``) and the cases without a kernel yet raise
    instead of falling back."""
    q, k, v = (torch.empty((1, 16, 4, 32), device="meta") for _ in range(3))
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="prefix-LM"):
        ops.flash_attention(q, k, v, prefix_len=4)
    with pytest.raises(NotImplementedError, match="MLA"):
        ops.flash_attention(q, k, torch.empty((1, 16, 4, 16), device="meta"), causal=False)
    assert fa.flash_attention.launches == before
    assert fa.REPLACES.startswith("src/repro/kernels/flash_attention.py")
