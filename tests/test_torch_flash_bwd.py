"""The port's attention gradient against the reference's, on the CPU.

The JAX package has no flash backward: off the TPU it trains through its
blocked jnp form (``ops.flash_attention(impl="xla")``) and lets XLA
differentiate it.  So the oracle of the port's plain backward
(``ref.flash_backward_ref``, what the CUDA backward kernel computes) is
``jax.vjp`` of that form and of the naive ``impl="ref"``, on the same numpy
inputs from a seed; the oracle of ``ref.attention_lse_ref`` is JAX's
``logsumexp`` of the reference's masked scores.  The CUDA kernels themselves
are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: fp32 throughout, atol 2e-5 and rtol 1e-4 (the forward's fp32
tolerance): the two differ by the order of their fp32 sums (blocked online
softmax and XLA's gradient against one full softmax and the FA-2 form).

The bf16 tensor-core backward carries P and dS into its products as bf16
terms; ``flash_backward_ref(p_bf16_terms=, ds_bf16_terms=)`` models that
rounding, and is held here, with the kernel's terms, against the same
``jax.vjp`` on bf16 inputs to the backward's bf16 tolerance (BWD_TOL: rtol
1e-2 plus 1e-3 of the gradient's largest entry, ``chip_smoke.py``'s
``_grads_close``): bf16 keeps 8 significant bits, and near-one-hot
attention cancels in dS = P (dP - Dᵢ), so entries span decades.
"""

import re
from pathlib import Path


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_lse_ref, attention_ref, flash_backward_ref

FP32 = dict(atol=2e-5, rtol=1e-4)
#: chip_smoke.py's BWD_RTOL and BWD_ATOL_OF_MAX
BWD_RTOL, BWD_ATOL_OF_MAX = 1e-2, 1e-3
#: (B, Sq, Sk, Hq, Hkv, D, causal): GQA groups 1 and 2, lengths that are not
#: a multiple of the kernel's 64-row tile, D 32 and 64, and non-causal
#: attention with Sq ≠ Sk both ways
CASES = [
    (2, 100, 100, 4, 4, 32, True),
    (1, 130, 130, 4, 2, 64, True),
    (1, 77, 150, 4, 2, 32, False),
    (2, 90, 45, 2, 2, 64, False),
    (1, 64, 64, 2, 1, 32, False),
]


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sq, Hq, D)).astype(np.float32))


def _outside_bwd_tol(got, want):
    """Per gradient, the entries of ``got`` outside rtol BWD_RTOL plus
    BWD_ATOL_OF_MAX of ``want``'s largest entry, and the largest error as a
    share of that tolerance."""
    out = []
    for g, w in zip(got, want):
        g, w = (t.float() if torch.is_tensor(t) else torch.tensor(np.asarray(t, dtype=np.float32)) for t in (g, w))
        tol = BWD_RTOL * w.abs() + BWD_ATOL_OF_MAX * w.abs().max()
        err = (g - w).abs()
        out.append((int((err > tol).sum()), float((err / tol).max())))
    return out


def _jax_lse(q, k, causal):
    """logsumexp of the reference's scaled, masked scores, (B, Hq, Sq)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    kk = jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kk) * D ** -0.5
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((Sq, Sk), bool)), s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


@pytest.mark.parametrize("impl", ["xla", "ref"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", CASES)
def test_plain_backward_matches_jax_vjp(B, Sq, Sk, Hq, Hkv, D, causal, impl):
    q, k, v, do = _inputs(B, Sq, Sk, Hq, Hkv, D, seed=Sq + Sk + D)
    f = lambda q, k, v: ref_ops.flash_attention(q, k, v, causal=causal, impl=impl, q_block=64, kv_block=64)
    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FP32)
    lse = attention_lse_ref(tq, tk, tv, causal=causal)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal), **FP32)
    got = flash_backward_ref(tq, tk, tv, o, lse, tdo, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32, err_msg=name)


def test_plain_backward_gives_zero_for_rows_that_see_no_key():
    """A row that sees no key has lse = +inf, which the backward reads as no
    mass: zero gradients, not nan (``exp(s - inf)`` is 0)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 6, 0, 2, 1, 32, seed=1))
    lse = attention_lse_ref(q, k, v, causal=False)
    assert torch.isinf(lse).all() and (lse > 0).all()
    o = attention_ref(q, k, v, causal=False)
    dq, dk, dv = flash_backward_ref(q, k, v, o, lse, do, causal=False)
    assert torch.count_nonzero(dq) == 0 and dk.shape == dv.shape == (1, 0, 1, 32)


def test_plain_backward_keeps_bf16():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 40, 40, 4, 2, 32, seed=2))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = flash_backward_ref(*(t.float() for t in (q, k, v, o)), lse, do.float(), causal=True)
    for g, w in zip(got, want):  # only the outputs' rounding to bf16 differs
        torch.testing.assert_close(g.float(), w, atol=0, rtol=2 ** -8)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", CASES[:3])
def test_flash_attention_function_matches_autograd_through_the_plain_version(B, Sq, Sk, Hq, Hkv, D, causal):
    """``FlashAttention.apply`` on CPU tensors (both wrappers then compute
    their plain versions) against torch's autograd through ``attention_ref``,
    with a scale other than D^-0.5; the wrappers launch nothing."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, Sq, Sk, Hq, Hkv, D, seed=7))
    before = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.FlashAttention.apply(*leaves, causal, 0.3)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = attention_ref(*ref_leaves, causal=causal, scale=0.3)
    want = torch.autograd.grad(want_out, ref_leaves, do)
    torch.testing.assert_close(out, want_out, **FP32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **FP32)
    assert (fa.flash_attention.launches, fa.flash_attention_backward.launches) == before


def test_backward_wrapper_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 4, 2, 32, seed=3))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    with pytest.raises(ValueError, match="q's shape"):
        fa.flash_attention_backward(q, k, v, o[:, :8], lse, do)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, o, lse[:, :2], do)
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.flash_attention_backward(q, k[:, :8], v[:, :8], o, lse, do, causal=True)
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_attention_backward(q, k, v, o, lse.to("meta"), do)


def _bf16(a):
    """numpy fp32 rounded to bf16 and back: the values both packages see."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("impl", ["xla", "ref"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", CASES + [(1, 96, 96, 4, 2, 128, True), (1, 96, 96, 4, 1, 256, True)])
def test_kernel_rounding_model_matches_jax_vjp_in_bf16(B, Sq, Sk, Hq, Hkv, D, causal, impl):
    """The plain backward with the tensor-core kernel's bf16 terms of P and
    dS, on bf16 q, k, v and dO (fp32 o and lse; bf16 gradients), against
    ``jax.vjp`` of the reference's attention on the same values, to BWD_TOL."""
    q, k, v, do = (_bf16(a) for a in _inputs(B, Sq, Sk, Hq, Hkv, D, seed=Sq + Sk + D + 1))
    f = lambda q, k, v: ref_ops.flash_attention(q, k, v, causal=causal, impl=impl, q_block=64, kv_block=64)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    # o in fp32, as JAX's gradient sees it: a bf16 o moves Dᵢ = rowsum(dO o) by its own rounding
    o, lse = fa.flash_attention(*(t.float() for t in (tq, tk, tv)), causal=causal, return_lse=True)
    got = flash_backward_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                             p_bf16_terms=fa.BWD_P_TERMS, ds_bf16_terms=fa.BWD_DS_TERMS)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for name, (n_out, worst) in zip(("dq", "dk", "dv"), _outside_bwd_tol(got, want)):
        assert n_out == 0, f"{name}: {n_out} entries outside BWD_TOL (worst at {worst:.2f} of it)"


def _near_one_hot(seed):
    """bf16 q scaled by 4 (softmax near one-hot) and v by 20, as attention at
    the reference's init at full width: rows whose p·dO and dS·k terms
    nearly cancel."""
    rng = np.random.default_rng(seed)
    shape = (1, 256, 2, 64)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) * m for m in (4.0, 1.0, 20.0, 1.0))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    o, lse = fa.flash_attention(tq, tk, tv, causal=False, return_lse=True)
    return tq, tk, tv, o, lse, tdo


def test_kernel_terms_keep_near_one_hot_gradients_within_tolerance_and_one_term_misses():
    """Why the tensor-core backward carries both P and dS as two bf16 terms:
    on near-one-hot attention with cancelling rows, two terms keep every
    gradient entry within BWD_TOL of the fp32-P, fp32-dS plain backward,
    while one term of P misses in dV and one term of dS misses in dQ or dK."""
    assert (fa.BWD_P_TERMS, fa.BWD_DS_TERMS) == (2, 2)
    worst = {"chosen": 0.0, "p_one_term": 0.0, "ds_one_term": 0.0}
    missed = {"p_one_term": 0, "ds_one_term": 0}
    for seed in range(3):
        args = _near_one_hot(seed)
        want = flash_backward_ref(*args, causal=False)
        for name, terms in (("chosen", (2, 2)), ("p_one_term", (1, 2)), ("ds_one_term", (2, 1))):
            got = flash_backward_ref(*args, causal=False, p_bf16_terms=terms[0], ds_bf16_terms=terms[1])
            counts = _outside_bwd_tol(got, want)
            worst[name] = max(worst[name], *(w for _, w in counts))
            if name == "chosen":
                assert all(n == 0 for n, _ in counts), counts
            elif name == "p_one_term":
                missed[name] += counts[2][0]  # P enters dV alone
            else:
                missed[name] += counts[0][0] + counts[1][0]  # dS enters dQ and dK
    assert missed["p_one_term"] > 0 and missed["ds_one_term"] > 0, (missed, worst)
    assert worst["chosen"] < 0.75 < 1.0 < worst["p_one_term"] and worst["ds_one_term"] > 1.0, worst


def test_rounding_model_refuses_other_term_counts():
    q, k, v, o, lse, do = _near_one_hot(0)
    for kw in (dict(p_bf16_terms=3), dict(ds_bf16_terms=-1)):
        with pytest.raises(ValueError, match="bf16_terms"):
            flash_backward_ref(q, k, v, o, lse, do, **kw)


def test_kernel_source_states_the_terms_the_model_is_given():
    """``BWD_P_TERMS`` / ``BWD_DS_TERMS`` are the constants the kernel's
    source compiles with, so the CPU model above is the kernel's rounding."""
    src = (Path(fa.__file__).parent / "csrc" / "flash_attention_bwd_wgmma.cu").read_text()
    found = {name: int(n) for name, n in re.findall(r"constexpr int (P_TERMS|DS_TERMS) = (\d+);", src)}
    assert found == {"P_TERMS": fa.BWD_P_TERMS, "DS_TERMS": fa.BWD_DS_TERMS}
