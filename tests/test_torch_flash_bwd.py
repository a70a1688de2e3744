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
The same holds at unequal widths, v narrower than q and k, as MLA runs
them: deepseek-v2-lite's smoke (q/k 24, v 16) and published (q/k 192, v
128) widths, whose backward counts three products over the q/k width and
two over v's (``flash_flops``, ``flash_bytes``, and the trainer's cost).

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


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal", [(2, 100, 100, 8, 2, True), (1, 77, 150, 4, 4, False)])
def test_head_dim_16_zero_padded_to_32_is_the_true_width(B, Sq, Sk, Hq, Hkv, causal):
    """A CUDA call at head dim 16 runs the kernels at 32 on zero-padded
    copies with the true width's scale (``PAD_D16``): the plain
    versions so padded, then sliced, against ``jax.vjp`` of the reference's
    blocked form at 16 (qwen2-72b's and whisper-medium's smoke head dim)."""
    q, k, v, do = _inputs(B, Sq, Sk, Hq, Hkv, 16, seed=Sq + Hq)
    f = lambda q, k, v: ref_ops.flash_attention(q, k, v, causal=causal, impl="xla", q_block=64, kv_block=64)
    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    width, scale = fa.PAD_D16, 16 ** -0.5
    tq, tk, tv, tdo = fa._pad_heads([torch.from_numpy(a) for a in (q, k, v, do)])
    assert tq.shape[-1] == width and tq.is_contiguous() and not tq[..., 16:].any()
    o = attention_ref(tq, tk, tv, causal=causal, scale=scale)
    assert not o[..., 16:].any()
    np.testing.assert_allclose(o[..., :16].numpy(), np.asarray(jo), **FP32)
    lse = attention_lse_ref(tq, tk, tv, causal=causal, scale=scale)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal), **FP32)
    got = flash_backward_ref(tq, tk, tv, o, lse, tdo, causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert not g[..., 16:].any(), name
        np.testing.assert_allclose(g[..., :16].numpy(), np.asarray(w), **FP32, err_msg=name)


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


# --------------------------------------------------------------------------- unequal widths (MLA)
#: (B, Sq, Sk, Hq, Hkv, causal) at S <= 64: causal and not, GQA groups 1 and 2, Sq != Sk both ways
MLA_CASES = [(2, 37, 37, 4, 4, True), (1, 64, 64, 4, 2, True), (1, 23, 50, 4, 2, False), (2, 45, 19, 2, 2, False)]
#: every case at deepseek-v2-lite's smoke widths (q/k 16 + 8, v 16), and a causal and a non-causal GQA one at
#: its published widths (q/k 128 + 64, v 128)
MLA_WIDTH_CASES = ([(*c, 24, 16) for c in MLA_CASES] + [(*MLA_CASES[0], 192, 128), (*MLA_CASES[2], 192, 128)])


def _mla_inputs(B, Sq, Sk, Hq, Hkv, D, Dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32),
            rng.standard_normal((B, Sq, Hq, Dv)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,D,Dv", MLA_WIDTH_CASES)
def test_backward_at_unequal_widths_matches_jax_vjp(B, Sq, Sk, Hq, Hkv, causal, D, Dv):
    """The plain backward and ``FlashAttention`` (on CPU tensors: autograd
    through both wrappers' plain versions) with v narrower than q and k,
    against ``jax.vjp`` of the reference's blocked form, which takes Dv != D,
    at the default scale D^-0.5, in fp32 (FP32)."""
    q, k, v, do = _mla_inputs(B, Sq, Sk, Hq, Hkv, D, Dv, seed=Sq + Sk + D + Dv)
    f = lambda q, k, v: ref_ops.flash_attention(q, k, v, causal=causal, impl="xla", q_block=64, kv_block=64)
    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FP32)
    got = fa.flash_attention_backward(tq, tk, tv, o, lse, tdo, causal=causal)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    through = torch.autograd.grad(ops.FlashAttention.apply(*leaves, causal, D ** -0.5), leaves, tdo)
    for name, g, t, w in zip(("dq", "dk", "dv"), got, through, want):
        assert g.shape == w.shape == t.shape and g.shape[-1] == (Dv if name == "dv" else D), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32, err_msg=name)
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **FP32, err_msg=f"FlashAttention {name}")


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal", [MLA_CASES[1], MLA_CASES[2]])
def test_kernel_rounding_model_at_mla_widths_matches_jax_vjp_in_bf16(B, Sq, Sk, Hq, Hkv, causal):
    """The tensor-core kernel's bf16 terms of P and dS (two each) at (192,
    128), on bf16 q, k, v and dO, against ``jax.vjp`` of the reference's
    blocked form on the same values, to BWD_TOL."""
    q, k, v, do = (_bf16(a) for a in _mla_inputs(B, Sq, Sk, Hq, Hkv, 192, 128, seed=Sq + Sk + 1))
    f = lambda q, k, v: ref_ops.flash_attention(q, k, v, causal=causal, impl="xla", q_block=64, kv_block=64)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    o, lse = fa.flash_attention(*(t.float() for t in (tq, tk, tv)), causal=causal, return_lse=True)
    got = flash_backward_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                             p_bf16_terms=fa.BWD_P_TERMS, ds_bf16_terms=fa.BWD_DS_TERMS)
    assert [g.shape[-1] for g in got] == [192, 192, 128]
    for name, (n_out, worst) in zip(("dq", "dk", "dv"), _outside_bwd_tol(got, want)):
        assert n_out == 0, f"{name}: {n_out} entries outside BWD_TOL (worst at {worst:.2f} of it)"


def test_backward_wrapper_checks_widths_and_pairs():
    """o and dO must have v's width; a route names a kernel, and a pair no
    kernel takes is refused before any device branch, naming the pairs; on
    the CPU without a route any pair runs the plain version."""
    q, k, v, do = (torch.from_numpy(a) for a in _mla_inputs(1, 16, 16, 2, 2, 64, 32, seed=4))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert o.shape[-1] == 32
    with pytest.raises(ValueError, match="v's width"):
        fa.flash_attention_backward(q, k, v, torch.zeros_like(q), lse, do)
    with pytest.raises(ValueError, match="v's width"):
        fa.flash_attention_backward(q, k, v, o, lse, do[..., :16])
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention_backward(q, k[..., :32], v, o, lse, do)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, o, lse, do)  # the plain version takes (64, 32)
    assert (dq.shape[-1], dk.shape[-1], dv.shape[-1]) == (64, 64, 32)
    for route in ("wgmma", "simt"):
        with pytest.raises(ValueError, match=r"\(192, 128\)\), got head dims \(q/k 64, v 32\)"):
            fa.flash_attention_backward(q, k, v, o, lse, do, route=route)
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match=r"got head dims \(q/k 64, v 32\)"):
            fa.select_bwd_route(dtype, 64, 32)
    assert fa.select_bwd_route(torch.bfloat16, 192, 128) == "wgmma"
    assert fa.select_bwd_route(torch.float32, 192, 128) == "simt"
    mla = [torch.from_numpy(a) for a in _mla_inputs(1, 16, 16, 2, 2, 192, 128, seed=5)]
    o, lse = fa.flash_attention(*(t.bfloat16() for t in mla[:3]), causal=True, return_lse=True)
    with pytest.raises(ValueError, match="route 'simt' does not take torch.bfloat16 at head dims"):
        fa.flash_attention_backward(*(t.bfloat16() for t in mla[:3]), o, lse, mla[3].bfloat16(), route="simt")


def test_flops_and_bytes_count_each_product_at_its_width():
    """The backward's five products at their own widths, counted by hand:
    S, dQ and dK over the q/k width, dP and dV over v's; q, k, dq, dk at the
    q/k width and v, o, dO, dv at v's, plus the fp32 lse.  At equal widths
    the counts are what they were (five products of D; eight tensors of D)."""
    B, S, H, Hkv = 2, 64, 16, 4
    pairs = B * H * S * S // 2  # causal (Sq, Sk) pairs of all heads
    got = fa.flash_flops(B, S, S, H, 192, causal=True, backward=True, v_head_dim=128)
    assert got == 2 * pairs * 192 * 3 + 2 * pairs * 128 * 2
    assert fa.flash_flops(1, 2048, 2048, 16, 192, causal=True, backward=True, v_head_dim=128) == 55_834_574_848
    assert fa.flash_flops(B, S, S, H, 192, causal=False, backward=True, v_head_dim=128) == 2 * got
    nbytes = fa.flash_bytes(B, S, S, H, Hkv, 192, 2, backward=True, v_head_dim=128)
    q_rows, kv_rows = B * S * H, B * S * Hkv
    assert nbytes == 2 * (q_rows * (192 + 192 + 128 + 128) + kv_rows * (192 + 192 + 128 + 128)) + 4 * B * H * S
    for D in fa.SUPPORTED_HEAD_DIMS:
        assert fa.flash_flops(B, S, S, H, D, causal=True, backward=True) == 5 * 2 * pairs * D
        assert fa.flash_flops(B, S, S, H, D, causal=True, backward=True, v_head_dim=D) == 5 * 2 * pairs * D
        assert fa.flash_bytes(B, S, S, H, Hkv, D, 2, backward=True) == (
            2 * (4 * q_rows * D + 4 * kv_rows * D) + 4 * B * H * S)
        assert fa.flash_flops(B, S, S, H, D, causal=True) == 2 * 2 * pairs * D
    # the forward at (192, 128) keeps its two products
    assert fa.flash_flops(B, S, S, H, 192, causal=True, v_head_dim=128) == 2 * pairs * (192 + 128)


def test_trainer_prices_mla_attention_at_its_widths():
    """The trainer's cost count (``perf.cost.kernel_costs``, which prices each
    launch the wrappers record) prices deepseek-v2's flash launches at (q/k
    192, v 128) with K and V expanded to every query head, as
    ``flash_widths`` says, ``mla_apply`` calls them and the wrapper records
    them; a GQA config stays at its head dim and kv heads."""
    import dataclasses
    from collections import Counter

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.perf.cost import kernel_costs
    from repro_torch.train import flash_widths

    cfg = get_config("deepseek-v2-lite-16b")
    assert cfg.resolved_head_dim == 128 and flash_widths(cfg) == (16, 192, 128)
    rec = fa.FlashLaunch(2, 2048, 2048, 16, *flash_widths(cfg), causal=True, prefix_len=0, esize=2)
    got = kernel_costs({"flash_forward": Counter({rec: 4}), "flash_backward": Counter({rec: 2})})
    shape = (2, 2048, 2048, 16)
    assert got["flash_forward"] == 4 * fa.flash_flops(*shape, 192, causal=True, v_head_dim=128)
    assert got["flash_backward"] == 2 * 2 * 55_834_574_848  # two launches at B = 2
    assert got["bytes_flash_backward"] == 2 * fa.flash_bytes(*shape, 16, 192, 2, backward=True, v_head_dim=128)
    assert got["bytes_flash_forward"] == 4 * 2 * (2 * 2048 * 16 * (192 + 128) * 2)
    smoke = get_smoke_config("deepseek-v2-lite-16b")
    assert flash_widths(smoke) == (smoke.n_heads, 24, 16)
    gqa = get_smoke_config("llama4-scout-17b-a16e")
    assert flash_widths(gqa) == (gqa.n_kv_heads, gqa.resolved_head_dim, gqa.resolved_head_dim)
    dense = dataclasses.replace(get_config("deepseek-7b"), n_layers=2)
    assert flash_widths(dense) == (32, 128, 128)
