"""The port's SSD scan and Mamba-2 model against the reference's, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.  The
reference's SSD kernel runs as its own tests run it here: the Pallas kernel
in interpret mode (``impl="pallas"``), beside its sequential oracle
``ssd_ref``.  On the CPU the port's wrapper computes its plain chunked
version; the CUDA kernel is held against ``ssd_ref`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Tolerances:

* SSD outputs: atol 5e-5 / rtol 1e-3 in fp32, atol 2e-2 / rtol 2e-2 in
  bf16 (those of ``tests/test_kernels.py``).
* SSD gradients against ``jax.grad`` of the reference's chunked jnp form:
  rtol 1e-4 with atol 1e-4 of each gradient's largest entry.  Both
  differentiate the same chunked algorithm in fp32; they differ by
  summation order, measured at up to ~1e-6 of the scale.
* ``gradcheck`` in float64 at its default tolerances.
* mamba2 smoke logits within atol 5e-5 (measured 4e-6 on logits up to ~1),
  the SSM state ``h`` within 1e-5 of its largest entry (the reference's
  init gain makes |h| reach the hundreds; measured 2e-3 absolute), the
  pre-conv windows within 1e-4 absolute.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.kernels import ops as ref_ops
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.models import prefill as ref_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_ref
from repro_torch.models import Transformer, load_jax_params
from repro_torch.models.convert import flatten_jax_tree
from repro_torch.serve import Engine, ServeConfig

SSD_SHAPES = [  # tests/test_kernels.py's set (B, S, H, P, N, G, chunk): grouped B/C, ragged chunking
    (1, 64, 2, 16, 8, 1, 64),
    (2, 128, 4, 8, 16, 2, 32),
    (2, 96, 6, 8, 16, 3, 32),
]
FP32 = dict(atol=5e-5, rtol=1e-3)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _ssd_inputs(B, S, H, P, N, G, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.1).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    D = (rng.standard_normal(H) * 0.2).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32)
    return x, dt, A, Bm, Cm, D, h0


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk", SSD_SHAPES)
def test_ssd_fp32_matches_pallas_and_ref(B, S, H, P, N, G, chunk, with_h0):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(B, S, H, P, N, G, seed=S + N)
    h0 = h0 if with_h0 else None
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)]
    jh0 = jnp.asarray(h0) if with_h0 else None
    py, ph = ref_ops.ssd_scan(*j, h0=jh0, chunk=chunk, impl="pallas")
    ry, rh = jax_ssd_ref(*j, h0=jh0, return_state=True)
    th0 = _t(h0) if with_h0 else None
    args = [_t(a) for a in (x, dt, A, Bm, Cm, D)]
    y, h = ops.ssd_scan(*args, h0=th0, chunk=chunk)
    sy, sh = ssd_ref(*args, h0=th0, return_state=True)
    assert y.dtype == torch.float32 and y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    for got, want in ((y, py), (y, ry), (sy, ry), (h, ph), (h, rh), (sh, rh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_ssd_bf16_matches_pallas():
    x, dt, A, Bm, Cm, _, _ = _ssd_inputs(1, 64, 2, 8, 16, 1, seed=3)
    x = x * 0.5
    jx, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm))
    pallas, _ = ref_ops.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, impl="pallas", chunk=32)
    y, h = ops.ssd_scan(_t(x, torch.bfloat16), _t(dt), _t(A), _t(Bm, torch.bfloat16), _t(Cm, torch.bfloat16),
                        chunk=32)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(pallas, np.float32), **BF16)


def test_chunk_follows_the_reference_rule():
    """The reference halves ``min(chunk, S)`` until it divides S; the plain
    version and the backward use the same chunk (the kernel tiles any S)."""
    assert [ops.ref_chunk(S, 256) for S in (256, 300, 257, 1000, 37, 4096)] == [256, 4, 1, 8, 37, 256]
    x, dt, A, Bm, Cm, D, h0 = (_t(a) for a in _ssd_inputs(1, 300, 2, 4, 8, 1, seed=4))
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, D, h0, chunk=256)
    sy, sh = ssd_ref(x, dt, A, Bm, Cm, D, h0, return_state=True)
    torch.testing.assert_close(y, sy, **FP32)
    torch.testing.assert_close(h, sh, **FP32)
    with pytest.raises(ValueError, match="divide"):
        ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=256)


def _jax_ssd_grads(arrays, weights, chunk):
    wy, wh = (jnp.asarray(w) for w in weights)

    def loss(x, dt, A, Bm, Cm, D, h0):
        y, h = ref_ops.ssd_scan(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk, impl="xla")
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    return jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("B,S,H,P,N,G,chunk", SSD_SHAPES)
def test_ssd_gradients_match_jax(B, S, H, P, N, G, chunk):
    arrays = _ssd_inputs(B, S, H, P, N, G, seed=7 + S)
    rng = np.random.default_rng(8)
    weights = (rng.standard_normal((B, S, H, P)).astype(np.float32),
               rng.standard_normal((B, H, P, N)).astype(np.float32))
    want = _jax_ssd_grads(arrays, weights, chunk)
    leaves = [_t(a).requires_grad_() for a in arrays]
    y, h = ops.ssd_scan(*leaves[:6], h0=leaves[6], chunk=chunk)
    (torch.sum(y * _t(weights[0])) + torch.sum(h * _t(weights[1]))).backward()
    for name, leaf, w in zip(("x", "dt", "A", "B", "C", "D", "h0"), leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_ssd_backward_is_autograd_through_the_chunked_form():
    """:class:`SSDScan`'s backward (the card's gradient) equals autograd
    through the plain chunked version, and passes gradcheck in float64."""
    arrays = _ssd_inputs(2, 32, 4, 4, 8, 2, seed=11)
    grads = {}
    for name, fn in (("function", sk.ssd_scan_autograd), ("plain", ops.ssd_scan)):
        leaves = [_t(a).requires_grad_() for a in arrays]
        y, h = fn(*leaves[:6], h0=leaves[6], chunk=8)
        (y.square().sum() + h.sum()).backward()
        grads[name] = [t.grad for t in leaves]
    for a, b in zip(grads["function"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

    tiny = [_t(a, torch.float64).requires_grad_() for a in _ssd_inputs(1, 8, 2, 2, 3, 1, seed=12)]
    assert torch.autograd.gradcheck(lambda *t: sk.ssd_scan_autograd(*t, chunk=4), tuple(tiny))
    # optional inputs absent: no gradient slots for them
    assert torch.autograd.gradcheck(lambda x, dt, A, Bm, Cm: sk.ssd_scan_autograd(x, dt, A, Bm, Cm, chunk=4),
                                    tuple(tiny[:5]))


def test_ssd_wrapper_refuses_what_it_does_not_take():
    x, dt, A, Bm, Cm, D, h0 = (_t(a) for a in _ssd_inputs(1, 16, 4, 4, 8, 3, seed=1)[:7])
    with pytest.raises(ValueError, match="multiple"):
        sk.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    x, dt, A, Bm, Cm, D, h0 = (_t(a) for a in _ssd_inputs(1, 16, 4, 4, 8, 2, seed=1))
    with pytest.raises(ValueError, match="shape"):
        sk.ssd_scan(x, dt[:, :8], A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="h0"):
        sk.ssd_scan(x, dt, A, Bm, Cm, D, h0[..., :4], chunk=16)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ssd_scan(x, dt, A, Bm, Cm, impl="pallas")
    before = sk.ssd_scan.launches
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm)]
    with pytest.raises(ValueError, match="cuda or cpu"):  # never the plain version off the CPU
        sk.ssd_scan(*meta, chunk=16)
    assert sk.ssd_scan.launches == before
    assert sk.REPLACES.startswith("src/repro/kernels/ssd_scan.py")
    # the least work: C Bᵀ once per (batch, group, tile) and M X each the causal half (2080 of 64 x 64 entries
    # with the diagonal), C h_inᵀ and the state product per (batch, head, tile)
    assert sk.ssd_flops(4, 256, 24, 64, 128) == 4 * 4 * (2080 * 2 * 128 + 24 * (2080 * 2 * 64 + 4 * 64 * 128 * 64))


# --------------------------------------------------------------------------- mamba2 model
@pytest.fixture(scope="module")
def mamba():
    cfg = ref_smoke("mamba2-130m")
    params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(7), cfg.param_jdtype())
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = load_jax_params(Transformer(get_smoke_config("mamba2-130m"), device="cpu"), tree)
    return cfg, params, tree, model


def test_mamba2_tree_round_trips_leaf_for_leaf(mamba):
    cfg, _, tree, model = mamba
    flat = flatten_jax_tree(tree, cfg)
    port = dict(model.named_parameters())
    assert sorted(port) == sorted(flat)
    assert any(".ssm.gate_norm.scale" in n for n in port) and "lm_head.w" not in port  # tied embeddings
    for name, p in port.items():
        assert np.array_equal(p.detach().numpy(), flat[name]), name


def test_mamba2_init_recipes_match_reference(mamba):
    """Normal leaves without their own scale read ``n_layers`` as fan-in (the
    reference's stacked init); the conv taps keep their explicit 0.5."""
    cfg, _, tree, _ = mamba
    ref_flat = flatten_jax_tree(tree, cfg)
    port = dict(Transformer(get_smoke_config("mamba2-130m"), device="cpu", seed=3).named_parameters())
    for name, p in port.items():
        ref = ref_flat[name].astype(np.float64)
        assert tuple(p.shape) == ref.shape, name
        if ref.std() == 0:
            assert np.array_equal(p.detach().numpy(), ref_flat[name]), name
            continue
        # two samples' stds differ by ~std / sqrt(n) each: allow four of those
        rtol = 4 / np.sqrt(p.numel())
        np.testing.assert_allclose(p.double().std().item(), ref.std(), rtol=rtol, err_msg=name)
    np.testing.assert_allclose(ref_flat["layers.0.ssm.conv_x"].std(), 0.5, rtol=0.05)
    np.testing.assert_allclose(ref_flat["layers.0.ssm.w_x"].std(), cfg.n_layers ** -0.5, rtol=0.05)


def test_mamba2_forward_and_prefill_match_reference(mamba):
    cfg, params, _, model = mamba
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    want, want_aux = ref_forward(cfg, params, {"tokens": toks})
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(toks).long())
    assert logits.shape == (2, 37, cfg.padded_vocab) and float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=5e-5, rtol=0)

    want_last, want_cache = ref_prefill(cfg, params, {"tokens": toks})
    last, cache = model.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=5e-5, rtol=0)
    ref_mixer = want_cache["blocks"]["pos_0"]["mixer"]
    assert sorted(cache) == sorted(ref_mixer)
    for k, v in cache.items():
        r = np.asarray(ref_mixer[k])
        assert tuple(v.shape) == r.shape, k
        atol = 1e-5 * np.abs(r).max() if k == "h" else 1e-4
        np.testing.assert_allclose(v.numpy(), r, atol=atol, rtol=0, err_msg=k)


def test_mamba2_decode_steps_match_reference(mamba):
    cfg, params, _, model = mamba
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 19)).astype(np.int32)
    ref_logits, ref_cache = ref_prefill(cfg, params, {"tokens": toks})
    logits, cache = model.prefill(torch.from_numpy(toks).long())
    tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    pos = np.full((2,), toks.shape[1], np.int32)
    for _ in range(4):
        ref_logits, ref_cache = ref_decode_step(cfg, params, ref_cache, tok, pos)
        logits, out = model.decode_step(cache, torch.from_numpy(tok).long(), torch.from_numpy(pos).long())
        assert out is cache  # written in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=5e-5, rtol=0)
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
        assert np.array_equal(logits.argmax(-1).numpy(), tok)
        pos = pos + 1


def test_mamba2_decode_continues_forward(mamba):
    """A prefill then decode steps give the logits that ``forward`` gives on
    the extended sequence: the final state hands off exactly."""
    _, _, _, model = mamba
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (1, 24))).long()
    with torch.no_grad():
        full, _ = model(toks)
    _, cache = model.prefill(toks[:, :20])
    for t in range(20, 24):
        logits, cache = model.decode_step(cache, toks[:, t], torch.tensor([t]))
        torch.testing.assert_close(logits, full[:, t], atol=5e-5, rtol=0)


def test_causal_conv_with_a_left_window_matches_reference():
    from repro.models.mamba import _causal_conv as ref_conv
    from repro_torch.models.mamba import _causal_conv

    rng = np.random.default_rng(5)
    u, w, win = (rng.standard_normal(s).astype(np.float32) for s in ((2, 9, 3, 4), (4, 3, 4), (2, 3, 3, 4)))
    for window in (None, win):
        want = ref_conv(jnp.asarray(u), jnp.asarray(w), None if window is None else jnp.asarray(window))
        got = _causal_conv(_t(u), _t(w), None if window is None else _t(window))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_mamba_apply_continues_a_split_prefill_like_the_reference(mamba):
    """A prefill split in two: the second half, given the first half's conv
    windows and final state (``conv_window``, ``h0``), against the
    reference's ``mamba_apply`` given its own first half's, and against the
    whole sequence's second half."""
    from repro.models.mamba import mamba_apply as ref_mamba_apply
    from repro_torch.models.mamba import mamba_apply

    cfg, params, _, model = mamba
    ref_lp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["pos_0"]["ssm"])
    lp = model.layers[0]["ssm"]
    x = np.random.default_rng(11).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    S1 = 24

    def window(cache):
        return {"x": cache["conv_x"], "B": cache["conv_B"], "C": cache["conv_C"]}

    ref_full = np.asarray(ref_mamba_apply(ref_lp, jnp.asarray(x), cfg, ssd_impl="xla"))
    _, ref_cache = ref_mamba_apply(ref_lp, jnp.asarray(x[:, :S1]), cfg, return_cache=True, ssd_impl="xla")
    want, want_cache = ref_mamba_apply(ref_lp, jnp.asarray(x[:, S1:]), cfg, return_cache=True, ssd_impl="xla",
                                       conv_window=window(ref_cache), h0=ref_cache["h"])
    with torch.no_grad():
        _, cache = mamba_apply(lp, _t(x[:, :S1]), cfg, return_cache=True)
        got, got_cache = mamba_apply(lp, _t(x[:, S1:]), cfg, return_cache=True, conv_window=window(cache),
                                     h0=cache["h"])
        plain = mamba_apply(lp, _t(x[:, S1:]), cfg, ssd_impl="plain", conv_window=window(cache), h0=cache["h"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref_full[:, S1:], atol=5e-5, rtol=0)
    assert torch.equal(plain, got)  # on the CPU "auto" is the plain version
    h = np.asarray(want_cache["h"])
    np.testing.assert_allclose(got_cache["h"].numpy(), h, atol=1e-5 * np.abs(h).max(), rtol=0)
    assert not np.allclose(ref_full[:, S1:], np.asarray(ref_mamba_apply(ref_lp, jnp.asarray(x[:, S1:]), cfg)))


def test_init_cache_matches_the_reference_layout(mamba):
    cfg, _, _, model = mamba
    cache = model.init_cache(3, 64)
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "conv_x": (cfg.n_layers, 3, s.conv_width - 1, H, s.head_dim),
        "conv_B": (cfg.n_layers, 3, s.conv_width - 1, s.n_groups, s.d_state),
        "conv_C": (cfg.n_layers, 3, s.conv_width - 1, s.n_groups, s.d_state),
        "h": (cfg.n_layers, 3, H, s.head_dim, s.d_state),
    }
    assert cache["h"].dtype == torch.float32 and not any(v.any() for v in cache.values())


def test_engine_refuses_a_pure_ssm_model(mamba):
    with pytest.raises(NotImplementedError, match=r"serve/engine\.py:228"):
        Engine(mamba[3], ServeConfig(n_slots=2, max_len=64))


def test_hybrid_and_moe_ssm_configs_still_raise():
    """Named for what it held before the hybrid slice.  Now the hybrid of
    attention and SSM layers builds, with MoE (jamba) and without (mamba2
    with attention every other layer): each gets a cache of both kinds, the
    KV leaves over its attention layers and the SSM leaves over the rest."""
    hybrid = replace(get_smoke_config("mamba2-130m"), family="hybrid", n_heads=4, n_kv_heads=4, attn_every=2)
    for cfg in (hybrid, get_smoke_config("jamba-1.5-large-398b")):
        cache = Transformer(cfg, device="cpu").init_cache(2, 16)
        n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
        assert 0 < n_attn < cfg.n_layers
        assert {k: v.shape[0] for k, v in cache.items()} == {
            "k": n_attn, "v": n_attn, **{k: cfg.n_layers - n_attn for k in ("conv_x", "conv_B", "conv_C", "h")}}
