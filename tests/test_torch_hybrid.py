"""The port's hybrid decoder (jamba: Mamba-2 and attention layers, MoE every
second layer) against the reference's, on the CPU in fp32.

Weights come from ``repro.models.init_params`` and move into the port
through ``load_jax_params``; inputs come from numpy with a seed.  The
config is jamba's smoke config: one 8-layer superblock, attention at
position 4, SSM layers elsewhere, MoE (4 experts top-2) at the odd
positions.  The port keeps one cache stack per kind of layer (``k``/``v``
over the attention layers, the conv windows and ``h`` over the SSM ones);
the reference keeps one per superblock position, and each port row is
held against its layer's ``blocks/pos_<p>/mixer`` leaf.

Tolerances:

* Logits within ``LOGITS_ATOL`` (1e-4), ``tests/test_torch_models.py``'s
  tolerance for the dense smokes after deepseek-7b: the forward of a batch
  of two measured 2.6e-5 on logits up to 4.1, the prefill 6.3e-6.  (At one
  repeat the reference's normal init draws the layer weights at std 1, so
  activations are large and fp32 summation order shows.)  The 7-layer cut
  draws other weights and measured 1.7e-4: held, as the 16-layer config,
  to ``MOE_LOGITS_ATOL`` (5e-4), ``tests/test_torch_moe.py``'s tolerance
  for whole MoE models.
* The MoE aux loss within ``AUX_RTOL`` (1e-6 relative,
  ``tests/test_torch_moe.py``'s).
* Each K/V and conv-window leaf within ``CACHE_REL`` (5e-5) of its largest
  magnitude, ``tests/test_torch_models.py``'s cache tolerance (measured up
  to 6.8e-6).  The SSD state ``h`` within ``CACHE_REL`` in relative L2:
  its entries span six decades (1e-6 to ~2e4), the scan sums whole chunks
  of them in another order than the reference (S = 29 runs as one chunk of
  29 in both), and its largest entry's error reached 6.3e-5 of the largest
  magnitude in layer 3 at S = 29, where the relative L2 error was 2.2e-5
  (at most 3.8e-6 at S = 37).
* The serving engines' greedy tokens, statuses, ``TOKENS_OUT`` and
  ``KV_ACC_W`` lanes and ``fault_summary()`` exactly.
"""

import dataclasses
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.models import prefill as ref_prefill
from repro.serve import Engine as RefEngine
from repro.serve import LoadSpec as RefLoadSpec
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import TenantSpec as RefTenantSpec
from repro.serve import generate_load as ref_generate_load
from repro.serve import replay_load as ref_replay_load
from repro.serve.cache_utils import transplant as ref_transplant
from repro.serve.engine import _write_slot as ref_write_slot
from repro_torch.configs import get_smoke_config
from repro_torch.core.faults import FaultPlan
from repro_torch.models import Transformer, load_jax_params
from repro_torch.models.convert import flatten_jax_tree
from repro_torch.models.params import iter_leaves
from repro_torch.models.transformer import cache_rows
from repro_torch.serve import Engine, LoadSpec, Request, ServeConfig, TenantSpec, generate_load, replay_load
from repro_torch.serve.cache_utils import transplant

ARCH = "jamba-1.5-large-398b"
LOGITS_ATOL = 1e-4
MOE_LOGITS_ATOL = 5e-4
AUX_RTOL = 1e-6
CACHE_REL = 5e-5
SSM_KEYS = ("conv_x", "conv_B", "conv_C", "h")


def _setup(n_layers=None, seed=7):
    cfg, pcfg = ref_smoke(ARCH), get_smoke_config(ARCH)
    if n_layers is not None:
        cfg, pcfg = replace(cfg, n_layers=n_layers), replace(pcfg, n_layers=n_layers)
    params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(seed), cfg.param_jdtype())
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = load_jax_params(Transformer(pcfg, device="cpu"), tree)
    return cfg, params, tree, model


@pytest.fixture(scope="module")
def jamba():
    cfg, params, tree, model = _setup()
    jits = (
        jax.jit(lambda p, b: ref_prefill(cfg, p, b)),
        jax.jit(lambda p, c, t, q: ref_decode_step(cfg, p, c, t, q), donate_argnums=(1,)),
    )
    return cfg, params, tree, model, jits


def _ref_leaf(cache, cfg, layer: int, key: str) -> np.ndarray:
    """The reference's cache leaf ``key`` of one layer: repeat ``layer //
    period`` of its ``blocks/pos_<layer % period>/mixer`` stack."""
    period = cfg.superblock_period
    return np.asarray(cache["blocks"][f"pos_{layer % period}"]["mixer"][key][layer // period])


def _close_leaves(cache, ref_cache, cfg) -> None:
    """Every row of every port leaf against its layer's reference leaf."""
    rows = cache_rows(cfg)
    seen = {k: 0 for k in cache}
    for layer in range(cfg.n_layers):
        keys = ("k", "v") if cfg.layer_is_attn(layer) else SSM_KEYS
        for key in keys:
            want = _ref_leaf(ref_cache, cfg, layer, key)
            got = cache[key][rows[layer]]
            assert tuple(got.shape) == want.shape, (layer, key)
            if key == "h":
                rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
                assert rel <= CACHE_REL, (layer, rel)
            else:
                np.testing.assert_allclose(got.numpy(), want, atol=CACHE_REL * np.abs(want).max(), rtol=0,
                                           err_msg=f"layer {layer} {key}")
            seen[key] += 1
    assert seen == {k: v.shape[0] for k, v in cache.items()}  # every row held, none twice


def test_cache_layout_one_stack_per_kind(jamba):
    """Attention's K/V stack over the one attention layer (position 4), the
    SSM leaves over the seven others, each layer at its row of its kind; h
    in fp32 whatever the cache dtype."""
    cfg, _, _, model, _ = jamba
    assert cache_rows(cfg) == (0, 1, 2, 3, 0, 4, 5, 6) == model.cache_rows
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    cache = model.init_cache(3, 40, dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "k": (1, 3, 40, cfg.n_kv_heads, cfg.resolved_head_dim),
        "v": (1, 3, 40, cfg.n_kv_heads, cfg.resolved_head_dim),
        "conv_x": (7, 3, s.conv_width - 1, H, s.head_dim),
        "conv_B": (7, 3, s.conv_width - 1, s.n_groups, s.d_state),
        "conv_C": (7, 3, s.conv_width - 1, s.n_groups, s.d_state),
        "h": (7, 3, H, s.head_dim, s.d_state),
    }
    assert cache["h"].dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
    assert not any(v.any() for v in cache.values())


def test_forward_logits_and_aux_match_reference(jamba):
    cfg, params, _, model, _ = jamba
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    want_logits, want_aux = ref_forward(cfg, params, {"tokens": toks})
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(toks).long())
    assert logits.shape == (2, 37, cfg.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    assert n_moe == 4 and float(aux) > 0.9 * n_moe  # the Switch loss is >= 1 a layer


def test_prefill_logits_and_every_cache_leaf_match_reference(jamba):
    cfg, params, _, model, _ = jamba
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 29)).astype(np.int32)
    want_logits, want_cache = ref_prefill(cfg, params, {"tokens": toks})
    logits, cache = model.prefill(torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGITS_ATOL, rtol=0)
    assert np.array_equal(logits.argmax(-1).numpy(), np.asarray(want_logits).argmax(-1))
    assert sorted(cache) == ["conv_B", "conv_C", "conv_x", "h", "k", "v"]
    assert cache["k"].shape[2] == 29  # the prompt cache holds the prompt's K/V only
    _close_leaves(cache, want_cache, cfg)


def test_decode_steps_at_per_sequence_positions(jamba):
    """Prompts of 11 and 23 tokens transplanted into a shared two-slot
    cache, then 8 batched decode steps, each sequence at its own position;
    logits every step and every cache leaf at the end."""
    cfg, params, _, model, (prefill, decode) = jamba
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in (11, 23)]
    max_len = 40
    ref_cache = ref_init_cache(cfg, 2, max_len, dtype=cfg.compute_jdtype())
    cache = model.init_cache(2, max_len)
    tokens = []
    for slot, prompt in enumerate(prompts):
        ref_logits, small = prefill(params, {"tokens": prompt[None]})
        one = ref_transplant(ref_init_cache(cfg, 1, max_len, dtype=cfg.compute_jdtype()), small)
        ref_cache = jax.tree_util.tree_map(lambda b, o: ref_write_slot(b, o, slot), ref_cache, one)
        logits, port_small = model.prefill(torch.from_numpy(prompt[None]).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=LOGITS_ATOL, rtol=0)
        transplant({k: v[:, slot:slot + 1] for k, v in cache.items()}, port_small)
        tokens.append(int(np.asarray(ref_logits).argmax(-1)[0]))
    pos = np.array([len(p) for p in prompts], np.int32)
    tok = np.array(tokens, np.int32)
    for _ in range(8):
        ref_logits, ref_cache = decode(params, ref_cache, tok, pos)
        logits, out_cache = model.decode_step(cache, torch.from_numpy(tok).long(), torch.from_numpy(pos).long())
        assert out_cache is cache  # written in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=LOGITS_ATOL, rtol=0)
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
        assert np.array_equal(logits.argmax(-1).numpy(), tok)
        pos = pos + 1
    _close_leaves(cache, ref_cache, cfg)


@pytest.mark.parametrize("n_layers,period,repeats", [(16, 8, 2), (7, 7, 1)])
def test_flatten_jax_tree_at_two_repeats_and_the_fallback_period(n_layers, period, repeats):
    """jamba's smoke config at 16 layers (period 8, repeats 2) and at 7
    (the layer count does not divide by 8, so the period falls back to the
    whole stack): the reference's ``blocks/pos_<p>`` leaf, repeat ``r``,
    lands on layer ``8r + p`` leaf for leaf, each layer of the kind the
    reference gives that position, and the forward logits agree."""
    cfg, params, tree, model = _setup(n_layers)
    assert (cfg.superblock_period, n_layers // cfg.superblock_period) == (period, repeats)
    assert model.cfg.superblock_period == period
    flat = flatten_jax_tree(tree, cfg)
    port = dict(model.named_parameters())
    assert sorted(port) == sorted(flat)
    for layer in range(n_layers):
        src = jax.tree_util.tree_map(lambda a: a[layer // period], tree["blocks"][f"pos_{layer % period}"])
        assert ("attn" in src) == cfg.layer_is_attn(layer) and ("moe" in src) == cfg.layer_is_moe(layer)
        for path, arr in iter_leaves(src):
            assert np.array_equal(port[f"layers.{layer}." + path.replace("/", ".")].detach().numpy(), arr), (
                layer, path)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 21)).astype(np.int32)
    want, _ = ref_forward(cfg, params, {"tokens": toks})
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=MOE_LOGITS_ATOL, rtol=0)


# ---------------------------------------------------------------------------- the serving engine
def _engines(jamba, **scfg):
    cfg, params, _, model, (prefill, decode) = jamba
    plan = scfg.pop("fault_plan", None)
    ref = RefEngine(cfg, params, RefServeConfig(
        **scfg, fault_plan=RefFaultPlan(**dataclasses.asdict(plan)) if plan else None))
    ref._prefill, ref._decode = prefill, decode
    return ref, Engine(model, ServeConfig(**scfg, fault_plan=plan))


def _outcome(eng, reqs):
    frame = eng.frame
    lanes = {
        r.name: (int(frame.filter(stream=r.stream_id, access_type="SLO", outcome="TOKENS_OUT").sum()),
                 int(frame.filter(stream=r.stream_id, access_type="KV_ACC_W").sum()))
        for r in reqs
    }
    return {r.name: (list(r.generated), r.status, r.retries) for r in reqs}, lanes, eng.fault_summary()


@pytest.mark.parametrize("buckets", [(), (1, 2)], ids=["one-bucket", "buckets-1-2"])
def test_two_tenant_replay_matches_reference(jamba, buckets):
    """Greedy tokens, statuses, the TOKENS_OUT and KV_ACC_W lanes (K/V bytes
    of the one attention layer a token) and fault_summary() equal the
    reference engine's on a bursty two-tenant trace under a fault plan,
    decoding at one bucket and at buckets (1, 2)."""
    cfg = jamba[0]
    tenants = (
        dict(name="online", rate=0.8, prompt_len=(4, 12), max_new_tokens=(2, 6), priority=5),
        dict(name="batch", rate=0.8, prompt_len=(4, 12), max_new_tokens=(2, 6)),
    )
    kw = dict(steps=10, seed=7, burst_every=4, burst_factor=3.0)
    ref_load = ref_generate_load(
        RefLoadSpec(tenants=tuple(RefTenantSpec(**t) for t in tenants), **kw), cfg.vocab_size)
    load = generate_load(LoadSpec(tenants=tuple(TenantSpec(**t) for t in tenants), **kw), cfg.vocab_size)
    plan = FaultPlan(seed=5, queue_limit=3, max_retries=1, backoff_base=1, deadline_steps=12)
    ref, eng = _engines(jamba, n_slots=2, max_len=64, max_live=6, batch_buckets=buckets, fault_plan=plan)
    ref_rep, rep = ref_replay_load(ref, ref_load), replay_load(eng, load)
    assert rep.steps == ref_rep.steps
    assert _outcome(eng, [r for _, r in load]) == _outcome(ref, [r for _, r in ref_load])
    assert eng._kv_bytes_per_token == ref._kv_bytes_per_token == 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 4
    assert {r.status for r in rep.requests} > {"done"}  # the load really shed or timed out


def test_greedy_tokens_invariant_across_buckets(jamba):
    """A decode bucket is a view of the first slots of every stack, the SSM
    state and conv windows among them, so the batch size a decode runs at
    moves no live row's tokens, in either engine."""
    cfg = jamba[0]
    lens = (9, 5, 3)
    outcomes = []
    for buckets in ((), (1, 2)):
        ref, eng = _engines(jamba, n_slots=4, max_len=64, batch_buckets=buckets)
        for e, cls in ((ref, RefRequest), (eng, Request)):
            rng = np.random.default_rng(4)
            rs = [cls(prompt=rng.integers(0, cfg.vocab_size, (5 + 3 * i,)).astype(np.int32), max_new_tokens=m,
                      name=f"r{i}") for i, m in enumerate(lens)]
            for r in rs:
                e.submit(r)
            e.run_until_idle()
            outcomes.append(_outcome(e, rs))
    assert all(o == outcomes[0] for o in outcomes[1:])
