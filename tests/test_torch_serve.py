"""The port's serving engine against the reference's, on the CPU.

Both engines serve the same deepseek-7b smoke weights.  Greedy tokens,
request statuses, the per-stream count lanes (``TOKENS_OUT``, ``KV_ACC_W``)
and ``fault_summary()`` must be equal.  Wall-clock lanes (``TTFT_US``,
``LATENCY_US``) and sampled decoding are not compared: the reference
samples with ``jax.random``.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke
from repro.core.faults import FaultPlan as RefFaultPlan
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
from repro_torch.configs import get_smoke_config
from repro_torch.core.faults import FaultPlan
from repro_torch.models import Transformer, load_jax_params
from repro_torch.serve import Engine, LoadSpec, Request, ServeConfig, TenantSpec
from repro_torch.serve import generate_load, replay_load


@pytest.fixture(scope="module")
def setup():
    cfg = ref_smoke("deepseek-7b")
    params = init_params(model_defs(cfg), jax.random.PRNGKey(7), cfg.param_jdtype())
    model = Transformer(get_smoke_config("deepseek-7b"), device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    # one compiled prefill/decode for every reference engine of this module
    # (each engine would otherwise trace and compile its own)
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


def _lanes(eng, reqs):
    frame = eng.frame
    return {
        r.name: (
            int(frame.filter(stream=r.stream_id, access_type="SLO", outcome="TOKENS_OUT").sum()),
            int(frame.filter(stream=r.stream_id, access_type="KV_ACC_W").sum()),
        )
        for r in reqs
    }


def _outcome(eng, reqs):
    return (
        {r.name: (list(r.generated), r.status, r.retries) for r in reqs},
        _lanes(eng, reqs),
        eng.fault_summary(),
    )


def _requests(cls, cfg, seed, n, max_new=5, **kw):
    rng = np.random.default_rng(seed)
    return [
        cls(prompt=rng.integers(0, cfg.vocab_size, (4 + i % 4,)).astype(np.int32),
            max_new_tokens=max_new, name=f"r{i}", **kw)
        for i in range(n)
    ]


def _same_trace(ref_load, load):
    assert [(s, r.name, r.tenant, r.priority, r.max_new_tokens) for s, r in ref_load] == [
        (s, r.name, r.tenant, r.priority, r.max_new_tokens) for s, r in load
    ]
    assert all(np.array_equal(a.prompt, b.prompt) for (_, a), (_, b) in zip(ref_load, load))


def test_single_tenant_trace_matches_reference(setup):
    cfg = setup[0]
    kw = dict(tenants=(dict(name="solo", rate=0.7, prompt_len=(4, 8), max_new_tokens=(2, 6)),),
              steps=8, seed=3)
    ref_spec = RefLoadSpec(**dict(kw, tenants=tuple(RefTenantSpec(**t) for t in kw["tenants"])))
    spec = LoadSpec(**dict(kw, tenants=tuple(TenantSpec(**t) for t in kw["tenants"])))
    ref_load, load = ref_generate_load(ref_spec, cfg.vocab_size), generate_load(spec, cfg.vocab_size)
    _same_trace(ref_load, load)
    ref, eng = _engines(setup, n_slots=2, max_len=64)
    ref_rep, rep = ref_replay_load(ref, ref_load), replay_load(eng, load)
    assert rep.steps == ref_rep.steps and len(rep.requests) == len(load) > 3
    assert _outcome(eng, [r for _, r in load]) == _outcome(ref, [r for _, r in ref_load])
    assert all(r.status == "done" for _, r in load)


def test_greedy_tokens_invariant_across_buckets(setup):
    cfg = setup[0]
    lens = (7, 4, 2)  # longest in slot 0, so retirements shrink the active span
    outcomes = []
    for buckets in ((), (1, 2)):
        ref, eng = _engines(setup, n_slots=4, max_len=64, batch_buckets=buckets)
        for e, cls in ((ref, RefRequest), (eng, Request)):
            rs = _requests(cls, cfg, seed=4, n=3)
            for r, m in zip(rs, lens):
                r.max_new_tokens = m
                e.submit(r)
            e.run_until_idle()
            outcomes.append(_outcome(e, rs))
    assert all(o == outcomes[0] for o in outcomes[1:])


def test_fault_summary_matches_under_fault_plan(setup):
    cfg = setup[0]
    plan = FaultPlan(seed=5, queue_limit=2, max_retries=1, backoff_base=1, deadline_steps=4)
    ref, eng = _engines(setup, n_slots=1, max_len=64, fault_plan=plan)
    outcomes = []
    for e, cls in ((ref, RefRequest), (eng, Request)):
        rs = _requests(cls, cfg, seed=10, n=6, max_new=3)
        for r in rs:
            e.submit(r)
        e.run_until_idle()
        outcomes.append(_outcome(e, rs))
    assert outcomes[1] == outcomes[0]
    lanes = outcomes[1][2]["lanes"]
    assert lanes["SHED"] > 0 and lanes["RETRY"] > 0 and lanes["TIMEOUT_EXPIRED"] > 0
    assert set(outcomes[1][2]["statuses"]) == {"done", "shed", "timeout"}


def test_prefill_terminations_match(setup):
    """``max_new_tokens=1`` and EOS as the first token retire at prefill
    with exactly one token, in both engines."""
    cfg = setup[0]
    ref, eng = _engines(setup, n_slots=1, max_len=64)
    outcomes = []
    for e, cls in ((ref, RefRequest), (eng, Request)):
        probe = _requests(cls, cfg, seed=11, n=1, max_new=1)[0]
        e.submit(probe)
        e.run_until_idle()
        eos = _requests(cls, cfg, seed=11, n=1, max_new=8, eos_id=probe.generated[0])[0]
        eos.name = "eos"
        normal = _requests(cls, cfg, seed=12, n=2, max_new=3)[1]
        e.submit(eos)
        e.submit(normal)
        assert e.step() == 1 and eos.done and e.slots[0] is normal
        e.run_until_idle()
        outcomes.append(_outcome(e, [probe, eos, normal]))
    assert outcomes[1] == outcomes[0]
    gen = outcomes[1][0]
    assert len(gen["r0"][0]) == 1 and len(gen["eos"][0]) == 1


def test_two_tenant_replay_matches_reference(setup):
    cfg = setup[0]
    tenants = (
        dict(name="online", rate=0.8, prompt_len=(4, 8), max_new_tokens=(2, 5), priority=5),
        dict(name="batch", rate=0.8, prompt_len=(4, 8), max_new_tokens=(2, 5)),
    )
    kw = dict(steps=10, seed=7, burst_every=4, burst_factor=3.0)
    ref_load = ref_generate_load(
        RefLoadSpec(tenants=tuple(RefTenantSpec(**t) for t in tenants), **kw), cfg.vocab_size)
    load = generate_load(LoadSpec(tenants=tuple(TenantSpec(**t) for t in tenants), **kw), cfg.vocab_size)
    _same_trace(ref_load, load)
    plan = FaultPlan(seed=5, queue_limit=3, max_retries=1, backoff_base=1, deadline_steps=12)
    ref, eng = _engines(setup, n_slots=2, max_len=64, max_live=6, fault_plan=plan)
    ref_rep, rep = ref_replay_load(ref, ref_load), replay_load(eng, load)
    assert {r.name: r.status for r in rep.requests} == {r.name: r.status for r in ref_rep.requests}
    assert _outcome(eng, [r for _, r in load]) == _outcome(ref, [r for _, r in ref_load])
    for tenant, row in rep.per_tenant.items():
        want = ref_rep.per_tenant[tenant]
        for key in ("requests", "tokens_out", "shed_events", "retry_events", "timeout_count"):
            assert row[key] == want[key], (tenant, key)
    assert {r.status for r in rep.requests} > {"done"}  # the load really shed or timed out


def test_exit_report_is_a_declared_field(setup):
    assert "exit_report" in {f.name for f in dataclasses.fields(Request)}
    _, eng = _engines(setup, n_slots=1, max_len=64)
    req = _requests(Request, setup[0], seed=13, n=1, max_new=2)[0]
    eng.submit(req)
    eng.run_until_idle()
    assert req.exit_report.startswith("Serve_stats_breakdown (stream")
    assert "TOKENS_OUT] = 2" in req.exit_report


def test_sampled_decoding_is_seeded(setup):
    """Sampled runs repeat for one ``sample_seed`` and change with it (the
    draws are the port's own, so they are not compared with the reference)."""
    cfg, _, model, _ = setup

    def run(seed):
        eng = Engine(model, ServeConfig(n_slots=2, max_len=64, greedy=False, temperature=1.5,
                                        sample_seed=seed))
        rs = _requests(Request, cfg, seed=14, n=3, max_new=6)
        for r in rs:
            eng.submit(r)
        eng.run_until_idle()
        return [r.generated for r in rs]

    first = run(0)
    assert run(0) == first
    assert run(1) != first
    assert all(0 <= t < cfg.vocab_size for gen in first for t in gen)
