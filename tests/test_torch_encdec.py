"""The port's encoder-decoder (whisper-medium's smoke config) against the
reference's, on the CPU in fp32.

Weights come from ``repro.models.init_params`` and move into the port
through ``load_jax_params`` (the reference's stacked ``encoder/blocks``
leaves become ``encoder.layers.<i>``); the stub frame embeddings come from
a numpy seed.  Tolerances, measured with these inputs:

* ``sinusoidal_positions``: atol 2e-5 at 40 frames, 2e-4 at whisper's
  1,500.  Both compute the angles in fp32, but the two frameworks' ``exp``
  give frequencies one ulp apart, which the angle carries: at position
  1,499 an ulp of the angle is 1.2e-4.  Measured 3.8e-6 and 1.2e-4.
* ``cross_attn_kv`` and ``cross_attn_apply``: atol 2e-5 (measured 0 and
  2.5e-6).
* Logits of the whole model: atol 5e-4, measured 1.3e-4 on logits up to
  4.0.  The reference's init draws the layer weights at std
  ``repeats^-0.5`` (0.71 at two layers, a gain of ~5.7 a projection at
  d_model 64), so fp32 summation-order noise grows through the encoder,
  the cross-attention and the decoder: at another seed the JAX package's
  own two attention forms (its blocked ``_xla_flash`` and its plain
  ``attention_ref``) give logits 9.7e-5 apart, and the port is 1.7e-4 and
  2.1e-4 from them.  Greedy tokens must be equal.
* The caches within 5e-5 of each leaf's largest magnitude, as the dense
  decoder's (``tests/test_torch_models.py``); measured 1.3e-5 (self) and
  6.4e-6 (cross).
* Three train steps (fp32, 2 microbatches): step 1's loss rtol 1e-6, its
  grad norm rtol 1e-3 and every leaf's gradient (AdamW's first moment)
  within 2e-3 relative L2, as ``tests/test_torch_train.py`` holds the
  decoder-only configs (measured 7.1e-8, 3.9e-5 and 3.5e-4), the encoder's
  first query projection's change within 2e-3 (measured 9.1e-4); the later
  steps' losses rtol 1e-3 and grad norms rtol 1e-1 and that change within
  0.5, deepseek-7b's later tolerances there (measured 4.9e-4, 4.0e-2 and
  2.4e-2 at step 3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.models import prefill as ref_prefill
from repro.models.attention import cross_attn_apply as ref_cross_apply
from repro.models.attention import cross_attn_kv as ref_cross_kv
from repro.models.layers import sinusoidal_positions as ref_sinusoidal
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import ScheduleConfig as RefScheduleConfig
from repro.serve.cache_utils import transplant as ref_transplant
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, make_train_iter
from repro_torch.models import Transformer, load_jax_params
from repro_torch.models.attention import cross_attn_apply, cross_attn_kv
from repro_torch.models.convert import flatten_jax_tree
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.optim import ScheduleConfig, adamw_init
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.cache_utils import transplant
from repro_torch.train import TrainConfig, make_train_step

ARCH = "whisper-medium"
ENC_LEN = 40
LOGITS_ATOL = 5e-4
CACHE_REL = 5e-5
CROSS_ATOL = 2e-5


@pytest.fixture(scope="module")
def whisper():
    cfg = ref_smoke(ARCH)
    params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(7), cfg.param_jdtype())
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = load_jax_params(Transformer(get_smoke_config(ARCH), device="cpu"), tree)
    return cfg, params, tree, model


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    enc = rng.standard_normal((B, ENC_LEN, cfg.d_model)).astype(np.float32)
    return toks, enc


def _close_cache(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, atol=CACHE_REL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("seq,d_model,atol", [(ENC_LEN, 64, 2e-5), (1500, 1024, 2e-4), (7, 6, 2e-5)])
def test_sinusoidal_positions_match_reference(seq, d_model, atol):
    got = sinusoidal_positions(seq, d_model)
    want = np.asarray(ref_sinusoidal(seq, d_model))
    assert got.dtype == torch.float32 and got.shape == want.shape == (seq, d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    assert sinusoidal_positions(seq, d_model, torch.bfloat16).dtype == torch.bfloat16


def test_cross_attention_matches_reference(whisper):
    """``cross_attn_kv`` over an encoder output, then ``cross_attn_apply``
    for a sequence (the flash path, non-causal at (Sq, S_enc)) and for one
    decode token (over the whole cross cache), with layer 1's weights."""
    cfg, params, tree, model = whisper
    ref_p = jax.tree_util.tree_map(lambda a: a[1], params["blocks"]["pos_0"]["cross"])
    port_p = model.layers[1]["cross"]
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, ENC_LEN, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    ref_kv = ref_cross_kv(ref_p, enc, cfg)
    kv = cross_attn_kv(port_p, torch.from_numpy(enc), cfg)
    for key in ("k", "v"):
        assert kv[key].shape == (2, ENC_LEN, cfg.n_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(kv[key].detach().numpy(), np.asarray(ref_kv[key]), atol=CROSS_ATOL, rtol=0)
    for xs in (x, x[:, 0]):
        got = cross_attn_apply(port_p, torch.from_numpy(np.ascontiguousarray(xs)), cfg, kv).detach().numpy()
        want = np.asarray(ref_cross_apply(ref_p, xs, cfg, ref_kv))
        assert got.shape == want.shape == xs.shape
        np.testing.assert_allclose(got, want, atol=CROSS_ATOL, rtol=0)


def test_forward_matches_reference(whisper):
    cfg, params, _, model = whisper
    toks, enc = _inputs(cfg, 2, 24, seed=1)
    want, want_aux = ref_forward(cfg, params, {"tokens": toks, "enc_embeds": enc})
    with torch.no_grad():
        got, aux = model(torch.from_numpy(toks).long(), enc_embeds=torch.from_numpy(enc))
    assert got.shape == (2, 24, cfg.padded_vocab) and float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL, rtol=0)
    assert np.array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))
    with pytest.raises(ValueError, match="enc_embeds"):
        model(torch.from_numpy(toks).long())


def test_prefill_and_every_cache_leaf_match_reference(whisper):
    """The prompt cache: the decoder's self-attention ``{"k", "v"}`` and the
    cross stack ``{"cross_k", "cross_v"}`` of (L, B, S_enc, Hkv, D), against
    the reference's ``blocks/pos_0/{mixer, cross}`` leaves."""
    cfg, params, _, model = whisper
    toks, enc = _inputs(cfg, 2, 13, seed=2)
    want_logits, want_cache = ref_prefill(cfg, params, {"tokens": toks, "enc_embeds": enc})
    logits, cache = model.prefill(torch.from_numpy(toks).long(), enc_embeds=torch.from_numpy(enc))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGITS_ATOL, rtol=0)
    ref = want_cache["blocks"]["pos_0"]
    pairs = {"k": ref["mixer"]["k"], "v": ref["mixer"]["v"], "cross_k": ref["cross"]["k"], "cross_v": ref["cross"]["v"]}
    assert sorted(cache) == sorted(pairs)
    H, D = cfg.n_kv_heads, cfg.resolved_head_dim
    for key, want in pairs.items():
        seq = ENC_LEN if key.startswith("cross") else 13
        assert tuple(cache[key].shape) == np.asarray(want).shape == (cfg.n_layers, 2, seq, H, D)
        _close_cache(cache[key], want)


def test_greedy_decode_over_the_cross_cache_matches_reference(whisper):
    """Prefill into a cache of ``max_len`` (``init_cache(..., enc_len=)``),
    then 10 greedy decode steps, each over the whole cross cache: logits and
    tokens at every step, and the caches at the end."""
    cfg, params, _, model = whisper
    toks, enc = _inputs(cfg, 2, 5, seed=4)
    max_len = 16
    ref_logits, small = ref_prefill(cfg, params, {"tokens": toks, "enc_embeds": enc})
    ref_cache = ref_transplant(ref_init_cache(cfg, 2, max_len, enc_len=ENC_LEN, dtype=cfg.compute_jdtype()), small)
    logits, port_small = model.prefill(torch.from_numpy(toks).long(), enc_embeds=torch.from_numpy(enc))
    cache = transplant(model.init_cache(2, max_len, enc_len=ENC_LEN), port_small)
    pos = np.full((2,), toks.shape[1], np.int32)
    tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    assert np.array_equal(logits.argmax(-1).numpy(), tok)
    for _ in range(10):
        ref_logits, ref_cache = ref_decode_step(cfg, params, ref_cache, tok, pos)
        logits, out = model.decode_step(cache, torch.from_numpy(tok).long(), torch.from_numpy(pos).long())
        assert out is cache
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=LOGITS_ATOL, rtol=0)
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
        assert np.array_equal(logits.argmax(-1).numpy(), tok)
        pos = pos + 1
    ref = ref_cache["blocks"]["pos_0"]
    for key, want in (("k", ref["mixer"]["k"]), ("v", ref["mixer"]["v"]), ("cross_k", ref["cross"]["k"]),
                      ("cross_v", ref["cross"]["v"])):
        _close_cache(cache[key], want)


def test_encoder_init_reads_the_stack_as_fan_in():
    """The reference initialises the encoder's layers as one (n_enc_layers,
    ...) leaf per parameter, so a normal init reads n_enc_layers as its
    fan-in (``src/repro/models/params.py:95``); the port's own init draws
    each encoder layer's leaf at that std, the decoder's cross-attention at
    the decoder's, and keeps the reference's names and shapes."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_enc_layers=4, d_model=128, d_ff=256)
    model = Transformer(cfg, device="cpu", seed=3)
    ref_cfg = dataclasses.replace(ref_smoke(ARCH), n_enc_layers=4, d_model=128, d_ff=256)
    shapes = jax.eval_shape(lambda: ref_init_params(ref_model_defs(ref_cfg), jax.random.PRNGKey(0), jax.numpy.float32))
    ref_flat = flatten_jax_tree(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes), ref_cfg)
    port = dict(model.named_parameters())
    assert sorted(port) == sorted(ref_flat)
    assert all(tuple(port[n].shape) == ref_flat[n].shape for n in port)
    wq = torch.stack([model.encoder.layers[i]["attn"]["wq"] for i in range(4)]).double()
    np.testing.assert_allclose(wq.std().item(), 4 ** -0.5, rtol=0.05)
    cross = torch.stack([lp["cross"]["wk"] for lp in model.layers]).double()
    np.testing.assert_allclose(cross.std().item(), cfg.n_layers ** -0.5, rtol=0.05)
    np.testing.assert_allclose(model.encoder.layers[0]["attn"]["wo"].double().std().item(), 0.02 / np.sqrt(2),
                               rtol=0.05)


def _batches(cfg, n):
    it = make_train_iter(DataConfig(global_batch=4, seq_len=16, vocab_size=cfg.vocab_size, seed=5,
                                    enc_len=ENC_LEN, d_model=cfg.d_model))
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def test_three_train_steps_match_reference(whisper):
    """Three train steps from the same weights on batches carrying stub frame
    embeddings (the data pipeline's ``enc_embeds``; the trainer moves them
    as floats in the compute dtype): loss, grad norm, step 1's gradients,
    and the encoder's first query projection after each step."""
    cfg, params, tree, _ = whisper
    batches = _batches(cfg, 3)
    assert batches[0]["enc_embeds"].shape == (4, ENC_LEN, cfg.d_model)
    ref_step = jax.jit(ref_make_train_step(cfg, RefTrainConfig(
        schedule=RefScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10), microbatches=2)))
    model = load_jax_params(Transformer(get_smoke_config(ARCH), device="cpu"), tree)
    step = make_train_step(model, TrainConfig(schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10),
                                              microbatches=2))
    leaf = "encoder.layers.0.attn.wq"
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


def test_engine_refuses_an_encoder_decoder_config(whisper):
    """The reference's engine prefills with the tokens alone and fails on
    whisper (a KeyError on ``enc_embeds``); the port's refuses it up front,
    naming that failure."""
    model = whisper[3]
    with pytest.raises(NotImplementedError, match="encoder-decoder.*src/repro/serve/engine.py:383"):
        Engine(model, ServeConfig(n_slots=2, max_len=32))
