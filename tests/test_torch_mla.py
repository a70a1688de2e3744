"""The port's MLA attention, its flash attention at a value width other than
the key width, and the MoE/MLA serving engine, against the reference's on
the CPU in fp32.

Inputs come from numpy with a seed and go through both packages.  Two MLA
widths: the deepseek-v2-lite smoke config's own (q/k 16 + 8 rope, v 16,
latent 32) and the same config at deepseek-v2's published head dims (q/k
128 + 64, v 128), the pair (192, 128) the card's kernels take.

Tolerances: the modules within ``FP32_TOL`` (atol 2e-5, rtol 1e-4, as
``tests/test_kernels.py``), measured ~1.3e-7 on outputs up to 0.35; the
serving engines' tokens, statuses and count lanes exactly.
"""

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MLAConfig as RefMLAConfig
from repro.configs import get_smoke_config as ref_smoke
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.kernels import ops as ref_ops
from repro.models import attention as ref_attn
from repro.models import decode_step as ref_decode_step
from repro.models import init_params, model_defs
from repro.models import prefill as ref_prefill
from repro.serve import Engine as RefEngine
from repro.serve import LoadSpec as RefLoadSpec
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import TenantSpec as RefTenantSpec
from repro.serve import generate_load as ref_generate_load
from repro.serve import replay_load as ref_replay_load
from repro_torch.configs import MLAConfig, get_smoke_config
from repro_torch.core.faults import FaultPlan
from repro_torch.kernels import ops
from repro_torch.models import Transformer, load_jax_params
from repro_torch.models import attention as port_attn
from repro_torch.serve import Engine, LoadSpec, Request, ServeConfig, TenantSpec, generate_load, replay_load

FP32_TOL = dict(atol=2e-5, rtol=1e-4)
ARCH = "deepseek-v2-lite-16b"
#: deepseek-v2's published MLA head dims on the smoke config's latent
PUBLISHED = dict(kv_lora_rank=32, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)


def _cfgs(published: bool):
    cfg, pcfg = ref_smoke(ARCH), get_smoke_config(ARCH)
    if published:
        cfg = replace(cfg, mla=RefMLAConfig(**PUBLISHED))
        pcfg = replace(pcfg, mla=MLAConfig(**PUBLISHED))
    return cfg, pcfg


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _mla_params(cfg, seed=4):
    params = init_params(ref_attn.mla_defs(cfg), jax.random.PRNGKey(seed), jnp.float32)
    return params, _torch_tree(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("published", [False, True], ids=["smoke-widths", "published-head-dims"])
def test_mla_apply_matches_reference(published):
    cfg, pcfg = _cfgs(published)
    params, tparams = _mla_params(cfg)
    B, S = 2, 37
    x = np.random.default_rng(0).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    out, cache = ref_attn.mla_apply(params, jnp.asarray(x), cfg, jnp.asarray(pos), return_cache=True)
    pout, pcache = port_attn.mla_apply(tparams, torch.from_numpy(x), pcfg, torch.from_numpy(pos))
    m = cfg.mla
    assert tuple(pcache["ckv"].shape) == (B, S, m.kv_lora_rank + m.qk_rope_dim)
    np.testing.assert_allclose(pout.numpy(), np.asarray(out), **FP32_TOL)
    np.testing.assert_allclose(pcache["ckv"].numpy(), np.asarray(cache["ckv"]), **FP32_TOL)


@pytest.mark.parametrize("published", [False, True], ids=["smoke-widths", "published-head-dims"])
def test_mla_decode_matches_reference(published):
    """Weight-absorbed decode over a filled latent cache, each sequence at
    its own position: the output and the cache written in place."""
    cfg, pcfg = _cfgs(published)
    params, tparams = _mla_params(cfg, seed=5)
    rng = np.random.default_rng(1)
    B, S_max = 3, 40
    m = cfg.mla
    ckv = rng.standard_normal((B, S_max, m.kv_lora_rank + m.qk_rope_dim)).astype(np.float32)
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 17, 39], np.int32)
    out, new = ref_attn.mla_decode(params, jnp.asarray(x), cfg, {"ckv": jnp.asarray(ckv)}, jnp.asarray(pos))
    cache = {"ckv": torch.from_numpy(ckv.copy())}
    pout = port_attn.mla_decode(tparams, torch.from_numpy(x), pcfg, cache, torch.from_numpy(pos).long())
    np.testing.assert_allclose(pout.numpy(), np.asarray(out), **FP32_TOL)
    np.testing.assert_allclose(cache["ckv"].numpy(), np.asarray(new["ckv"]), **FP32_TOL)
    untouched = np.ones((B, S_max), bool)
    untouched[np.arange(B), pos] = False
    assert np.array_equal(cache["ckv"].numpy()[untouched], ckv[untouched])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 70, 16, 16, 192, 128), (2, 33, 4, 4, 24, 16), (1, 50, 8, 2, 192, 128)])
def test_flash_attention_at_a_narrower_value_width_matches_xla_flash(shape, causal):
    """``ops.flash_attention`` with Dv < D (MLA's prefill) against the
    reference's blocked jnp form, which it sends every MLA call to."""
    B, S, Hq, Hkv, D, Dv = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dv)).astype(np.float32)
    scale = D ** -0.5
    want = ref_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, scale=scale, impl="xla")
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, scale=scale)
    assert got.shape == (B, S, Hq, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


# ---------------------------------------------------------------------------- the serving engine
@pytest.fixture(scope="module", params=["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"])
def setup(request):
    arch = request.param
    cfg = ref_smoke(arch)
    params = init_params(model_defs(cfg), jax.random.PRNGKey(7), cfg.param_jdtype())
    model = load_jax_params(Transformer(get_smoke_config(arch), device="cpu"), jax.tree_util.tree_map(np.asarray, params))
    jits = (
        jax.jit(lambda p, b: ref_prefill(cfg, p, b)),
        jax.jit(lambda p, c, t, q: ref_decode_step(cfg, p, c, t, q), donate_argnums=(1,)),
    )
    return cfg, params, model, jits


def _engines(setup, **scfg):
    cfg, params, model, (prefill, decode) = setup
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


def test_two_tenant_replay_matches_reference(setup):
    """Greedy tokens, statuses, the TOKENS_OUT and KV_ACC_W lanes (MLA's
    latent bytes a token) and fault_summary() equal the reference engine's
    on a bursty two-tenant trace under a fault plan."""
    cfg = setup[0]
    tenants = (
        dict(name="online", rate=0.8, prompt_len=(4, 12), max_new_tokens=(2, 6), priority=5),
        dict(name="batch", rate=0.8, prompt_len=(4, 12), max_new_tokens=(2, 6)),
    )
    kw = dict(steps=10, seed=7, burst_every=4, burst_factor=3.0)
    ref_load = ref_generate_load(
        RefLoadSpec(tenants=tuple(RefTenantSpec(**t) for t in tenants), **kw), cfg.vocab_size)
    load = generate_load(LoadSpec(tenants=tuple(TenantSpec(**t) for t in tenants), **kw), cfg.vocab_size)
    plan = FaultPlan(seed=5, queue_limit=3, max_retries=1, backoff_base=1, deadline_steps=12)
    ref, eng = _engines(setup, n_slots=2, max_len=64, max_live=6, fault_plan=plan)
    ref_rep, rep = ref_replay_load(ref, ref_load), replay_load(eng, load)
    assert rep.steps == ref_rep.steps
    assert _outcome(eng, [r for _, r in load]) == _outcome(ref, [r for _, r in ref_load])
    assert eng._kv_bytes_per_token == ref._kv_bytes_per_token
    assert {r.status for r in rep.requests} > {"done"}  # the load really shed or timed out


def test_greedy_tokens_invariant_across_buckets(setup):
    """MoE routes each decode row as its own group, so the batch size a
    decode runs at (its bucket) moves no live row's experts or tokens."""
    cfg = setup[0]
    lens = (9, 5, 3)
    outcomes = []
    for buckets in ((), (1, 2)):
        ref, eng = _engines(setup, n_slots=4, max_len=64, batch_buckets=buckets)
        for e, cls in ((ref, RefRequest), (eng, Request)):
            rng = np.random.default_rng(4)
            rs = [cls(prompt=rng.integers(0, cfg.vocab_size, (5 + 3 * i,)).astype(np.int32), max_new_tokens=m,
                      name=f"r{i}") for i, m in enumerate(lens)]
            for r in rs:
                e.submit(r)
            e.run_until_idle()
            outcomes.append(_outcome(e, rs))
    assert all(o == outcomes[0] for o in outcomes[1:])
