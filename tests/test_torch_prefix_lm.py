"""Prefix-LM attention and the port's VLM (paligemma-3b's smoke config)
against the reference, on the CPU in fp32; and the flash pricing of
every mask.

* The plain versions with a prefix (every row also sees the first
  ``prefix_len`` keys): ``attention_ref`` against the reference's,
  ``attention_lse_ref`` against a logsumexp of explicitly masked scores,
  and ``flash_backward_ref`` against autograd of ``attention_ref``, at
  prefixes of 0, 1, off-tile and past S.  atol 2e-5 (fp32; measured up to
  2.9e-6).
* ``ops.flash_attention`` with a prefix on CPU tensors against the
  reference's plain ``attention_ref``, and against its blocked
  ``_xla_flash`` (where its dispatch sends a prefix) where that form keeps
  every prefix key: atol 2e-5; and its gradient through ``FlashAttention``.
* paligemma's smoke config (MQA, head dim 32, 16 vision tokens, GeGLU, a
  tied and scaled embedding): forward logits over the text positions,
  prefill logits and the cache, greedy decode from positions after the
  prefix.  Logits atol 2e-5 (measured 1.4e-5 on logits up to 0.93), caches
  within 5e-5 of each leaf's largest magnitude (as
  ``tests/test_torch_models.py``).  Three train steps on batches carrying
  stub patch embeddings: ``tests/test_torch_train.py``'s step-1 tolerances
  (loss rtol 1e-6, grad norm rtol 1e-3, every leaf's gradient within 2e-3
  relative L2) and deepseek-7b's later ones (loss rtol 1e-3, grad norm rtol
  1e-1), a query projection's change within 2e-3 at step 1 and 0.5 after.
* The serving engine serves paligemma text-only, as the reference's engine
  does (it prefills with the tokens alone): a two-tenant replay gives equal
  tokens, statuses and count lanes.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.kernels import ops as ref_ops
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.models import prefill as ref_prefill
from repro.optim import ScheduleConfig as RefScheduleConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.serve import Engine as RefEngine
from repro.serve import LoadSpec as RefLoadSpec
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import TenantSpec as RefTenantSpec
from repro.serve import generate_load as ref_generate_load
from repro.serve import replay_load as ref_replay_load
from repro.serve.cache_utils import transplant as ref_transplant
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, make_train_iter
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_lse_ref, attention_ref, flash_backward_ref
from repro_torch.models import Transformer, load_jax_params
from repro_torch.models.convert import flatten_jax_tree
from repro_torch.optim import ScheduleConfig, adamw_init
from repro_torch.serve import Engine, LoadSpec, ServeConfig, TenantSpec, generate_load, replay_load
from repro_torch.serve.cache_utils import transplant
from repro_torch.train import TrainConfig, Trainer, make_train_step

ARCH = "paligemma-3b"
ATOL = 2e-5
CACHE_REL = 5e-5
#: prefixes at S = 37: none, one key, off the tile, a whole 16-row block, all of S, past S
PREFIXES = (0, 1, 7, 16, 37, 50)


def _qkv(B, S, Hq, Hkv, D, Dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dv)).astype(np.float32))


def _visible(S, prefix_len):
    """The prefix-LM mask written out entry by entry."""
    return np.array([[c <= r or c < prefix_len for c in range(S)] for r in range(S)])


@pytest.mark.parametrize("prefix_len", PREFIXES)
def test_plain_versions_with_a_prefix(prefix_len):
    """``attention_ref`` against the reference's; ``attention_lse_ref``
    against a logsumexp of explicitly masked scores; ``flash_backward_ref``
    (from that output and lse) against autograd of ``attention_ref``; MQA at
    q/k width 16, v width 8."""
    q, k, v = _qkv(2, 37, 4, 1, 16, 8, seed=prefix_len)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention_ref(tq, tk, tv, causal=True, prefix_len=prefix_len)
    want = np.asarray(jax_attention_ref(q, k, v, causal=True, prefix_len=prefix_len))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL, rtol=0)

    s = np.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) * 16 ** -0.5
    s = np.where(_visible(37, prefix_len), s, -np.inf)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    lse = attention_lse_ref(q=torch.from_numpy(q), k=torch.from_numpy(k), v=torch.from_numpy(v), causal=True,
                            prefix_len=prefix_len)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=0)

    do = torch.from_numpy(np.random.default_rng(9).standard_normal(out.shape).astype(np.float32))
    want_grads = torch.autograd.grad(out, (tq, tk, tv), do)
    grads = flash_backward_ref(tq.detach(), tk.detach(), tv.detach(), out.detach(), lse, do, causal=True,
                               prefix_len=prefix_len)
    for got, w in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=ATOL, rtol=0)


def test_prefix_of_zero_and_of_all_keys():
    """A prefix of 0 is the causal mask, one of S or more the non-causal one,
    in every plain version."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 20, 2, 2, 8, 8, seed=5))
    do = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 20, 2, 8)).astype(np.float32))
    for prefix_len, causal in ((0, True), (20, False), (33, False)):
        o = attention_ref(q, k, v, causal=True, prefix_len=prefix_len)
        lse = attention_lse_ref(q, k, v, causal=True, prefix_len=prefix_len)
        assert torch.equal(o, attention_ref(q, k, v, causal=causal))
        assert torch.equal(lse, attention_lse_ref(q, k, v, causal=causal))
        for a, b in zip(flash_backward_ref(q, k, v, o, lse, do, causal=True, prefix_len=prefix_len),
                        flash_backward_ref(q, k, v, o, lse, do, causal=causal)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("prefix_len", (3, 16, 40))
def test_flash_op_with_a_prefix_matches_reference(prefix_len):
    """``ops.flash_attention`` with a prefix on CPU tensors (the wrapper's
    plain version) against the reference's op: its plain ``attention_ref``
    at every prefix, and its blocked form where that form is right (see
    ``test_reference_blocked_form_drops_prefix_keys_past_a_chunk_diagonal``);
    the gradient through ``FlashAttention`` (both wrappers' plain versions)
    against autograd of ``attention_ref``."""
    q, k, v = _qkv(2, 33, 4, 2, 16, 16, seed=prefix_len)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), prefix_len=prefix_len)
    want = np.asarray(ref_ops.flash_attention(jq, jk, jv, causal=True, prefix_len=prefix_len, impl="ref"))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the blocked form's first causal chunk (11 rows at q_block 16) ends past a prefix of 3
    blocked = np.asarray(ref_ops.flash_attention(jq, jk, jv, causal=True, prefix_len=prefix_len, impl="xla",
                                                 q_block=16, kv_block=16))
    if prefix_len <= 11:
        np.testing.assert_allclose(got.numpy(), blocked, atol=ATOL, rtol=0)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(got.shape).astype(np.float32))
    through = torch.autograd.grad(ops.FlashAttention.apply(*leaves, True, None, prefix_len), leaves, do)
    plain = torch.autograd.grad(attention_ref(*leaves, causal=True, prefix_len=prefix_len), leaves, do)
    for a, b in zip(through, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


def test_reference_blocked_form_drops_prefix_keys_past_a_chunk_diagonal():
    """A fault on the reference's side, which the port does not copy: its
    blocked ``_xla_flash`` (``src/repro/kernels/ops.py:120``) walks each
    causal query chunk's keys only to the chunk's diagonal, so a row in a
    chunk that ends inside the prefix loses the prefix keys past that end.
    Its own ``attention_ref`` and the port keep them.  At the model's
    default blocks (256-row chunks) paligemma's 256-key prefix ends where
    the first chunk does, so the reference's model paths are not hit."""
    q, k, v = _qkv(1, 33, 2, 2, 16, 16, seed=8)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    exact = np.asarray(ref_ops.flash_attention(jq, jk, jv, causal=True, prefix_len=16, impl="ref"))
    blocked = np.asarray(ref_ops.flash_attention(jq, jk, jv, causal=True, prefix_len=16, impl="xla",
                                                 q_block=16, kv_block=16))
    differ = np.abs(exact - blocked).max(axis=(0, 2, 3)) > 1e-3
    assert differ[:11].all() and not differ[11:].any()  # exactly the first chunk's 11 rows
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), prefix_len=16).numpy()
    np.testing.assert_allclose(got, exact, atol=ATOL, rtol=0)


# ----------------------------------------------------------------------------- paligemma
@pytest.fixture(scope="module")
def paligemma():
    cfg = ref_smoke(ARCH)
    params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(7), cfg.param_jdtype())
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = load_jax_params(Transformer(get_smoke_config(ARCH), device="cpu"), tree)
    jits = (jax.jit(lambda p, b: ref_prefill(cfg, p, b)),
            jax.jit(lambda p, c, t, q: ref_decode_step(cfg, p, c, t, q), donate_argnums=(1,)))
    return cfg, params, tree, model, jits


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vis = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return toks, vis


def _close_cache(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, atol=CACHE_REL * np.abs(ref).max(), rtol=0)


def test_forward_over_text_positions_matches_reference(paligemma):
    """Vision embeddings before the tokens, every text row seeing them (the
    prefix), logits over the text positions only."""
    cfg, params, _, model, _ = paligemma
    toks, vis = _inputs(cfg, 2, 24, seed=1)
    want, want_aux = ref_forward(cfg, params, {"tokens": toks, "vision_embeds": vis})
    with torch.no_grad():
        got, aux = model(torch.from_numpy(toks).long(), vision_embeds=torch.from_numpy(vis))
    assert got.shape == np.asarray(want).shape == (2, 24, cfg.padded_vocab) and float(aux) == float(want_aux) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # text alone, as the serving engine prefills: no prefix, no vision rows
    want_text = np.asarray(ref_forward(cfg, params, {"tokens": toks})[0])
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(toks).long())[0].numpy(), want_text, atol=ATOL, rtol=0)


def test_prefill_and_greedy_decode_after_the_prefix_match_reference(paligemma):
    """Prefill of 16 vision embeddings and 9 tokens (the cache holds all 25
    positions), then 8 greedy decode steps at positions 25 onward."""
    cfg, params, _, model, _ = paligemma
    toks, vis = _inputs(cfg, 2, 9, seed=2)
    want_logits, small = ref_prefill(cfg, params, {"tokens": toks, "vision_embeds": vis})
    logits, port_small = model.prefill(torch.from_numpy(toks).long(), vision_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)
    n = cfg.vision_tokens + 9
    for key in ("k", "v"):
        want = small["blocks"]["pos_0"]["mixer"][key]
        assert tuple(port_small[key].shape) == np.asarray(want).shape == (cfg.n_layers, 2, n, 1, 32)
        _close_cache(port_small[key], want)
    max_len = n + 12
    ref_cache = ref_transplant(ref_init_cache(cfg, 2, max_len, dtype=cfg.compute_jdtype()), small)
    cache = transplant(model.init_cache(2, max_len), port_small)
    pos = np.full((2,), n, np.int32)
    tok = np.asarray(want_logits).argmax(-1).astype(np.int32)
    assert np.array_equal(logits.argmax(-1).numpy(), tok)
    for _ in range(8):
        ref_logits, ref_cache = ref_decode_step(cfg, params, ref_cache, tok, pos)
        logits, _ = model.decode_step(cache, torch.from_numpy(tok).long(), torch.from_numpy(pos).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
        assert np.array_equal(logits.argmax(-1).numpy(), tok)
        pos = pos + 1
    for key in ("k", "v"):
        _close_cache(cache[key], ref_cache["blocks"]["pos_0"]["mixer"][key])


def test_three_train_steps_match_reference(paligemma):
    """Three train steps from the same weights on batches carrying stub patch
    embeddings (the data pipeline's ``vision_embeds``): loss, grad norm, step
    1's gradients, and the first layer's query projection after each step."""
    cfg, params, tree, _, _ = paligemma
    it = make_train_iter(DataConfig(global_batch=4, seq_len=16, vocab_size=cfg.vocab_size, seed=5,
                                    vision_tokens=cfg.vision_tokens, d_model=cfg.d_model))
    batches = [next(it) for _ in range(3)]
    it.close()
    assert batches[0]["vision_embeds"].shape == (4, cfg.vision_tokens, cfg.d_model)
    sched = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    ref_step = jax.jit(ref_make_train_step(cfg, RefTrainConfig(schedule=RefScheduleConfig(**sched), microbatches=2)))
    model = load_jax_params(Transformer(get_smoke_config(ARCH), device="cpu"), tree)
    step = make_train_step(model, TrainConfig(schedule=ScheduleConfig(**sched), microbatches=2))
    leaf = "layers.0.attn.wq"
    start = model.get_parameter(leaf).detach().numpy().copy()
    jp, jst, tst = params, ref_adamw_init(params), adamw_init(dict(model.named_parameters()))
    for i, batch in enumerate(batches):
        jp, jst, jm = ref_step(jp, jst, batch)
        tst, tm = step(tst, batch)
        first = i == 0
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6 if first else 1e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3 if first else 1e-1)
        assert int(tm["tokens"]) == int(jm["tokens"]) == 4 * 16
        want = flatten_jax_tree(jax.tree_util.tree_map(np.asarray, jp), cfg)[leaf]
        got = model.get_parameter(leaf).detach().numpy()
        assert np.linalg.norm((got - start) - (want - start)) <= (2e-3 if first else 0.5) * np.linalg.norm(want - start)
        if first:
            ref_m = flatten_jax_tree(jax.tree_util.tree_map(np.asarray, jst["m"]), cfg)
            gaps = {n: np.linalg.norm(m.numpy() - ref_m[n]) / max(np.linalg.norm(ref_m[n]), 1e-30)
                    for n, m in tst["m"].items()}
            assert max(gaps.values()) <= 2e-3, gaps


def test_two_tenant_replay_serves_text_only_as_the_reference(paligemma):
    """Both engines serve paligemma from its text alone (the reference's
    prefills with ``{"tokens": ...}``): equal tokens, statuses and lanes."""
    cfg, params, _, model, (prefill, decode) = paligemma
    tenants = (dict(name="online", rate=0.8, prompt_len=(4, 8), max_new_tokens=(2, 5), priority=5),
               dict(name="batch", rate=0.8, prompt_len=(4, 8), max_new_tokens=(2, 5)))
    kw = dict(steps=8, seed=11, burst_every=4, burst_factor=3.0)
    ref_load = ref_generate_load(RefLoadSpec(tenants=tuple(RefTenantSpec(**t) for t in tenants), **kw),
                                 cfg.vocab_size)
    load = generate_load(LoadSpec(tenants=tuple(TenantSpec(**t) for t in tenants), **kw), cfg.vocab_size)
    assert [(s, r.name, r.tenant) for s, r in ref_load] == [(s, r.name, r.tenant) for s, r in load]
    ref = RefEngine(cfg, params, RefServeConfig(n_slots=2, max_len=64, max_live=6))
    ref._prefill, ref._decode = prefill, decode
    eng = Engine(model, ServeConfig(n_slots=2, max_len=64, max_live=6))
    ref_rep, rep = ref_replay_load(ref, ref_load), replay_load(eng, load)
    assert len(load) > 3

    def outcome(e, reqs):
        frame = e.frame
        lanes = {r.name: (int(frame.filter(stream=r.stream_id, access_type="SLO", outcome="TOKENS_OUT").sum()),
                          int(frame.filter(stream=r.stream_id, access_type="KV_ACC_W").sum())) for r in reqs}
        return {r.name: (list(r.generated), r.status) for r in reqs}, lanes, e.fault_summary()

    assert outcome(eng, [r for _, r in load]) == outcome(ref, [r for _, r in ref_load])
    for tenant, row in rep.per_tenant.items():
        assert row["tokens_out"] == ref_rep.per_tenant[tenant]["tokens_out"] > 0


# ----------------------------------------------------------------------------- pricing
def test_flash_flops_count_the_prefix_pairs():
    """A causal launch counts half of its (Sq, Sk) square (the diagonal
    counted half) plus the upper half of the prefix's own square: a prefix of
    0 gives today's causal count, one of S or more the non-causal count."""
    B, S, H, D = 2, 512, 8, 256
    causal = fa.flash_flops(B, S, S, H, D, causal=True)
    assert causal == 2 * B * H * S * S // 2 * (2 * D)
    assert fa.flash_flops(B, S, S, H, D, causal=True, prefix_len=0) == causal
    for P in (S, S + 100):
        for backward in (False, True):
            assert fa.flash_flops(B, S, S, H, D, causal=True, prefix_len=P, backward=backward) == fa.flash_flops(
                B, S, S, H, D, causal=False, backward=backward)
    # paligemma's 256-row prefix of 512: 3/4 of the square ((S^2 + P^2) / 2), against 1/2 causal
    assert fa.flash_flops(B, S, S, H, D, causal=True, prefix_len=256) == 2 * B * H * (S * S + 256 * 256) // 2 * (2 * D)
    rec = fa.FlashLaunch(B, S, S, H, 1, D, D, True, 256, 2)
    assert rec.flops() == fa.flash_flops(B, S, S, H, D, causal=True, prefix_len=256)
    assert rec.bytes(backward=True) == fa.flash_bytes(B, S, S, H, 1, D, 2, backward=True)


def test_trainer_prices_each_flash_launch_at_its_own_shape():
    """whisper-medium's three launch shapes, as the wrapper records them for
    one microbatch of 4 rows: the encoder's non-causal 1,500 x 1,500, the
    cross-attention's 448 x 1,500 and the decoder's causal 448, each priced
    at its own shape; and paligemma's prefix launches at (S^2 + P^2) / 2."""
    cfg = get_config("whisper-medium")
    tr = Trainer(cfg, TrainConfig(microbatches=2), iter(()), device="cpu")
    H, D = cfg.n_heads, cfg.resolved_head_dim
    enc = fa.FlashLaunch(4, 1500, 1500, H, H, D, D, False, 0, 2)
    cross = fa.FlashLaunch(4, 448, 1500, H, H, D, D, False, 0, 2)
    dec = fa.FlashLaunch(4, 448, 448, H, H, D, D, True, 0, 2)
    fwd = Counter({enc: 48, cross: 48, dec: 48})  # 24 layers each, forward and remat recompute
    bwd = Counter({enc: 24, cross: 24, dec: 24})
    got = tr._kernel_costs({"tokens": np.zeros((8, 448), np.int32)},
                           {"ssd_kernel": 0, "flash_forward": fwd, "flash_backward": bwd})
    pairs = {enc: 1500 * 1500, cross: 448 * 1500, dec: 448 * 448 // 2}
    assert got["flash_forward"] == sum(n * 2 * 4 * H * pairs[r] * 2 * D for r, n in fwd.items())
    assert got["flash_backward"] == sum(n * 2 * 4 * H * pairs[r] * 5 * D for r, n in bwd.items())
    assert got["bytes_flash_forward"] == (48 * 2 * (4 * 1500 * H * 2 * D * 2) + 48 * 2 * (4 * (448 + 1500) * H * 2 * D)
                                         + 48 * 2 * (4 * 448 * H * 2 * D * 2))
    # the old pricing, every launch causal at the tokens' (S, S), would have counted one shape for all three
    assert got["flash_forward"] != 144 * fa.flash_flops(4, 448, 448, H, D, causal=True)
    pali = get_config(ARCH)
    rec = fa.FlashLaunch(4, 512, 512, pali.n_heads, 1, 256, 256, True, 256, 2)
    got = Trainer(pali, TrainConfig(microbatches=2), iter(()), device="cpu")._kernel_costs(
        {"tokens": np.zeros((8, 256), np.int32)}, {"ssd_kernel": 0, "flash_forward": Counter({rec: 36}),
                                                   "flash_backward": Counter({rec: 18})})
    assert got["flash_forward"] == 36 * 2 * 4 * 8 * (512 * 512 + 256 * 256) // 2 * 512
    assert got["flash_backward"] == 18 * 2 * 4 * 8 * (512 * 512 + 256 * 256) // 2 * 5 * 256


def test_flash_launch_records_come_from_cuda_launches_only():
    """On the CPU no kernel launches, so neither count nor record moves; the
    record counters exist beside the launch counts."""
    before = (fa.flash_attention.launches, Counter(fa.flash_attention.shapes))
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 32, 32, seed=1))
    fa.flash_attention(q, k, v, prefix_len=4)
    assert (fa.flash_attention.launches, fa.flash_attention.shapes) == before
    assert isinstance(fa.flash_attention_backward.shapes, Counter)
