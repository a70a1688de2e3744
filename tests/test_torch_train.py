"""The port's training stack against the reference's, on the CPU.

Weights come from ``repro.models.init_params`` and move into the port with
``load_jax_params``; batches come from each package's own copy of the data
pipeline, which must agree bit for bit.  Tolerances:

* AdamW parameters and moments: rtol 1e-5, atol 1e-7 after 3 steps (fp32;
  the two differ by the order of the elementwise fp32 operations).
* The schedule: rtol 1e-6 (the reference computes in fp32, the port in
  Python floats).
* Cross-entropy: rtol 1e-6.
* Three train steps from the same weights, the first held tightly: its
  loss and grad norm differ only by fp32 summation order, and AdamW's first
  moment after it is (1 - b1) times the clipped gradient, so every leaf's
  gradient is compared.  Step 1: loss rtol 1e-6, grad norm rtol 1e-3, each
  leaf's gradient (first moment) within 2e-3 of the reference's in relative
  L2, each leaf's parameter change within 1e-1 in relative L2 (AdamW's
  first step is g / (|g| + eps) · lr, so an entry whose gradient sits near
  eps moves by a fraction of the lr that the noise sets).  Measured, deepseek-7b
  smoke: loss 7.0e-8, grad norm 2.4e-4, gradients 4.5e-4 (layers.1.attn.wq),
  changes 3.2e-2 (layers.0.attn.wo); mamba2-130m smoke: 0, 4.9e-5, 7.6e-5,
  1.5e-3.  A zeroed, negated or 1 % too large attention gradient fails step
  1 (``test_three_train_steps_catch_a_wrong_attention_gradient``): grad norm
  off by 0.85, 0.25 and 2.0e-2, gradients by 5.8, 2.3 and 1.9e-2.
* The later steps drift, more for deepseek-7b: the reference's init (layer
  weights at std n_layers^-0.5) makes attention near one-hot, and its
  backward (dS = P ∘ (dP − D)) turns summation-order noise into whole-step
  sign flips under AdamW.  mamba2-130m smoke (fp32, remat, 2 microbatches,
  peak lr 1e-3): losses rtol 1e-5 (measured ≤ 3.1e-7), grad norms rtol
  5e-3 (measured 2.1e-3 at the third step), parameters within atol 5e-4
  after the three steps (measured 1.9e-4).  deepseek-7b smoke (fp32, no
  remat, the same schedule): losses rtol 1e-3 (measured 1.7e-4), grad norms
  rtol 1e-1 (measured 5.2e-2 at the third step), and each leaf's change
  over the three steps within 0.5 of the reference's in relative L2
  (measured 0.22; the zeroed and negated controls reach 1.4 and 1.9).  An
  absolute parameter tolerance cannot fail there: three steps of at most the
  lr each keep any two runs from the same weights within 5e-3.  gemma-7b
  smoke (fp32, no remat; GeGLU, tied and scaled embedding) takes
  deepseek-7b's tolerances: measured at head dim 32 step 1 loss 0, grad
  norm 4.1e-6, gradients 6.8e-5, changes 1.0e-2, then losses 6.6e-6, grad
  norms 1.1e-2, changes 5.0e-2 over three steps; at its published head dim
  of 256, 1.5e-7, 2.4e-5, 3.9e-4 and 1.2e-2 at step 1, then 9.3e-5, 5.3e-2
  and 0.23, where attention is as near one-hot as deepseek-7b's.
* The MoE smoke configs are held to the same step-1 tolerances, and each
  microbatch of step 1 first routes every token to the same experts in
  both packages, or to experts whose top-(k+1) router probabilities tie
  within TIE_EPS (1e-5; none did).  llama4-scout (GQA, 4 experts top-1 and
  a shared one) takes deepseek-7b's later tolerances: measured step 1 loss
  0, grad norm 4.8e-6, gradients 9.1e-5, changes 1.9e-2, then losses
  1.9e-5, grad norms 7.8e-3, changes 5.1e-2 over three steps.
  deepseek-v2-lite (MLA at q/k 24, v 16; a dense first layer, then 8
  experts top-2 and a shared one): step 1 loss 7.0e-8, grad norm 2.0e-4,
  gradients 4.8e-4, changes 2.5e-2.  After step 1 the two packages' weights
  differ by AdamW's amplified fp32 noise, and the router sends the tokens
  whose top-k margin sits below that difference to other experts: 1 token
  at step 2 (margins 9.7e-4 and 2.7e-5), 46 at step 3 (margins up to
  2.3e-2).  So its later losses take rtol 1e-2 (measured 5.9e-5 at step 2,
  5.6e-3 at step 3), its grad norms deepseek-7b's 1e-1 (measured 5.9e-2 and
  7.2e-2) and its changes 0.5 (measured 0.40).  A zeroed, negated or 1 %
  too large attention gradient still fails step 1
  (``test_three_train_steps_catch_a_wrong_attention_gradient_in_mla_and_moe``).
* qwen2-72b (QKV bias, head dim 16), phi3-medium-14b (5 heads of 32 on 5
  kv heads) and jamba-1.5-large-398b (8 layers: SSD, attention at position
  4, MoE at odd positions; its routes tie as the other MoE configs' must,
  none differed) take deepseek-7b's tolerances.  Measured, step 1 loss /
  grad norm / gradients / changes, then the worst later loss, grad norm
  and change over three steps: qwen2 7.0e-8, 5.6e-6, 1.0e-4, 6.4e-3, then
  6.9e-5, 1.2e-2, 0.19; phi3 0, 1.6e-5, 2.3e-4, 1.6e-2, then 3.7e-4,
  1.6e-2, 0.13; jamba 1.4e-7, 1.2e-5, 3.9e-4, 1.5e-2, then 5.8e-5,
  5.1e-2, 0.28.
* Moments are built in ``cfg.opt_state_dtype`` on both sides, and a bf16
  moment is compared through its fp32 value.  qwen2-72b also trains with
  its published bf16 moments: step 1's gradients (the bf16 first moment)
  8.3e-4 (one bf16 rounding apart at most, on both sides), the rest as
  with fp32 moments (7.1e-5, 1.0e-2, 0.19).
* Microbatch 1 against 2 on the port: losses rtol 1e-5, parameters atol
  1e-5 (the reference's own test, ``test_train_serve.py:54``).
* Checkpoint round trip and resume: bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as ref_smoke
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import make_train_iter as ref_make_train_iter
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import ScheduleConfig as RefScheduleConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import learning_rate as ref_learning_rate
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import cross_entropy as ref_cross_entropy
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import torch_dtype
from repro_torch.data import DataConfig, make_train_iter
from repro_torch.models import Transformer, load_jax_params
from repro_torch.models.convert import flatten_jax_tree
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw_init, adamw_update, clip_by_global_norm, learning_rate
from repro_torch.train import TrainConfig, Trainer, cross_entropy, init_train_state, make_loss_fn, make_train_step
from repro_torch.train.__main__ import main as train_main


# --------------------------------------------------------------------------- optimizer
def test_adamw_and_clip_match_reference_over_three_steps():
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "n": (4, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 2).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    cfg = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    sched = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = ref_adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = adamw_init(tp)
    for g in grads:
        jg, jnorm = ref_clip({k: jnp.asarray(v) for k, v in g.items()}, cfg["grad_clip"])
        lr = ref_learning_rate(jst["step"], RefScheduleConfig(**sched))
        jp, jst = ref_adamw_update(jg, jst, jp, lr, RefAdamWConfig(**cfg))
        tg, tnorm = clip_by_global_norm({k: torch.from_numpy(v.copy()) for k, v in g.items()}, cfg["grad_clip"])
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-8)
        tst = adamw_update(tg, tst, tp, learning_rate(int(tst["step"]), ScheduleConfig(**sched)), AdamWConfig(**cfg))
    assert int(tst["step"]) == int(jst["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tst["m"][k].numpy(), np.asarray(jst["m"][k]), rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tst["v"][k].numpy(), np.asarray(jst["v"][k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_adamw_keeps_moment_and_param_dtypes():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(p, torch.bfloat16)
    st = adamw_update({"w": torch.full((4,), 0.5)}, st, p, 1e-2)
    assert st["m"]["w"].dtype == p["w"].dtype == torch.bfloat16 and int(st["step"]) == 1
    assert (p["w"] < 1).all()  # weight decay and the step both pull it down


@torch.no_grad()
def _whole_tree_update(grads, opt_state, params, lr, cfg=AdamWConfig()):
    """``adamw_update`` as it was before it went slice by slice: every
    ``_foreach`` op over all leaves at once."""
    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    c1 = float(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf)
    c2 = float(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf)
    names = list(params)
    p_store = [params[n] for n in names]
    m_store = [opt_state["m"][n] for n in names]
    v_store = [opt_state["v"][n] for n in names]
    g = [grads[n] for n in names]
    p32 = [t.float() for t in p_store]
    m32 = [t.float() for t in m_store]
    v32 = [t.float() for t in v_store]
    torch._foreach_mul_(m32, cfg.b1)
    torch._foreach_add_(m32, g, alpha=1.0 - cfg.b1)
    torch._foreach_mul_(v32, cfg.b2)
    torch._foreach_addcmul_(v32, g, g, value=1.0 - cfg.b2)
    denom = torch._foreach_div(v32, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(m32, c1)
    torch._foreach_div_(delta, denom)
    torch._foreach_add_(delta, p32, alpha=cfg.weight_decay)
    torch._foreach_add_(p32, delta, alpha=-float(lr))
    for store, new in zip(p_store + m_store + v_store, p32 + m32 + v32):
        if new is not store:
            store.copy_(new)
    return {**opt_state, "step": step}


@pytest.mark.parametrize("chunk_elems", [1, 7, 64, 1000])
@pytest.mark.parametrize("param_dtype,moment_dtype,grad_dtype", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
])
def test_adamw_slices_are_bit_for_bit_the_whole_tree_update(chunk_elems, param_dtype, moment_dtype, grad_dtype,
                                                            monkeypatch):
    """Groups of small leaves, large leaves cut into runs, a non-contiguous
    leaf kept whole: three steps bit for bit the update over the whole tree."""
    from repro_torch.optim import adamw as adamw_module

    monkeypatch.setattr(adamw_module, "CHUNK_ELEMS", chunk_elems)
    rng = np.random.default_rng(4)
    shapes = {"emb": (37, 19), "b": (5,), "w": (8, 12), "n": (3, 4, 2), "t": (6, 9)}
    base = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}

    def leaves():
        out = {k: torch.from_numpy(v.copy()).to(param_dtype) for k, v in base.items()}
        out["t"] = out["t"].t()  # a transposed view: not contiguous
        return out

    runs = []
    for update in (_whole_tree_update, adamw_update):
        params = leaves()
        st = adamw_init(params, moment_dtype)
        for i in range(3):
            g = {k: torch.from_numpy(np.random.default_rng(10 + i).standard_normal(p.shape).astype(np.float32))
                 .to(grad_dtype) for k, p in params.items()}
            st = update(g, st, params, 1e-2 * (i + 1), AdamWConfig())
        runs.append((params, st))
    (p0, s0), (p1, s1) = runs
    assert int(s0["step"]) == int(s1["step"]) == 3
    for k in shapes:
        assert p1[k].dtype == param_dtype and s1["m"][k].dtype == s1["v"][k].dtype == moment_dtype
        for a, b in ((p0[k], p1[k]), (s0["m"][k], s1["m"][k]), (s0["v"][k], s1["v"][k])):
            assert torch.equal(a, b), k


def test_adamw_slices_cover_every_element_once():
    from repro_torch.optim.adamw import _slices

    rows = [tuple(torch.zeros(n) for _ in range(4)) for n in (3, 10, 2, 25, 1)]
    groups = _slices(rows, 8)
    assert all(sum(p[0].numel() for p in grp) <= 8 for grp in groups)
    for grp in groups:
        for piece in grp:
            for t in piece:
                t += 1
    assert all(bool((t == 1).all()) for row in rows for t in row)
    assert len(_slices(rows, 1 << 30)) == 1


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(kind):
    kw = dict(peak_lr=6e-4, warmup_steps=20, decay_steps=300, min_lr_ratio=0.1, kind=kind)
    steps = [0, 1, 5, 19, 20, 21, 100, 299, 300, 1000]
    want = [float(ref_learning_rate(s, RefScheduleConfig(**kw))) for s in steps]
    got = [learning_rate(s, ScheduleConfig(**kw)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -100
    for z in (0.0, 1e-4):
        wl, wn = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z)
        gl, gn = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long(), z)
        np.testing.assert_allclose(float(gl), float(wl), rtol=1e-6)
        assert int(gn) == int(wn) == 8


# --------------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(global_batch=4, seq_len=16, vocab_size=512),
                                dict(global_batch=8, seq_len=33, vocab_size=50280, seed=9, host_id=1, n_hosts=2)])
def test_data_batches_are_bit_identical_to_reference(kw):
    port, ref = make_train_iter(DataConfig(**kw), start_index=3), ref_make_train_iter(RefDataConfig(**kw), start_index=3)
    try:
        for _ in range(3):
            a, b = next(port), next(ref)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    finally:
        port.close()
        ref.close()


# --------------------------------------------------------------------------- train step
def _batches(cfg, n, batch=4, seq=32, seed=1234):
    it = make_train_iter(DataConfig(global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size, seed=seed))
    out = [next(it) for _ in range(n)]
    it.close()
    return out


#: step 1 of three: loss rtol, grad norm rtol, per-leaf relative L2 of the
#: gradient and of the parameter change; see the module docstring
STEP1_TOL = dict(loss=1e-6, grad_norm=1e-3, grad=2e-3, change=1e-1)
#: steps 2 and 3: (loss rtol, grad norm rtol, parameter atol or None, per-leaf
#: relative L2 of the parameter change over the three steps); see the module
#: docstring for deepseek-v2-lite's loss rtol
LATER_TOL = {"mamba2-130m": (1e-5, 5e-3, 5e-4, 1e-2), "deepseek-7b": (1e-3, 1e-1, None, 0.5),
             "gemma-7b": (1e-3, 1e-1, None, 0.5), "deepseek-v2-lite-16b": (1e-2, 1e-1, None, 0.5),
             "llama4-scout-17b-a16e": (1e-3, 1e-1, None, 0.5), "qwen2-72b": (1e-3, 1e-1, None, 0.5),
             "phi3-medium-14b": (1e-3, 1e-1, None, 0.5), "jamba-1.5-large-398b": (1e-3, 1e-1, None, 0.5)}


def _f32(a):
    """A leaf as fp32 numpy (a bf16 moment compared through its fp32 value)."""
    return np.asarray(a, dtype=np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


#: step 1 of a MoE config: where the two packages route a token to different experts from the same
#: weights, its top-(k+1) router probabilities must lie within TIE_EPS of each other on both sides (a tie
#: that fp32 summation order decides, not an error); chip_smoke.py's TIE_EPS
TIE_EPS = 1e-5


def _router_trace(module, record):
    """``module.router_topk`` wrapped to hand each call's expert indices and
    its top-(k+1) probabilities to ``record``."""
    real = module.router_topk

    def traced(params, x, moe):
        w, idx, aux = real(params, x, moe)
        more = dataclasses.replace(moe, top_k=min(moe.top_k + 1, moe.n_experts), router_scale=False)
        record(idx, real(params, x, more)[0])
        return w, idx, aux

    return real, traced


def _reference_routes(cfg, params, batch, n_micro):
    """Each microbatch's router calls in the reference's forward: (expert
    indices, smallest gap between the top-(k+1) probabilities) per token."""
    from repro.models import forward as ref_forward
    from repro.models import moe as ref_moe

    calls = []

    def record(idx, top):
        top = top.astype(jnp.float32)
        jax.debug.callback(lambda i, g: calls.append((np.asarray(i), np.asarray(g))), idx,
                           (top[..., :-1] - top[..., 1:]).min(-1))

    real, ref_moe.router_topk = _router_trace(ref_moe, record)
    try:
        size = len(batch["tokens"]) // n_micro
        for i in range(n_micro):
            logits, _ = ref_forward(cfg, params, {"tokens": jnp.asarray(batch["tokens"][i * size:(i + 1) * size])})
            logits.block_until_ready()
    finally:
        ref_moe.router_topk = real
    return calls


def _port_routes(model, batch, n_micro):
    """The same of the port's forward."""
    from repro_torch.models import moe as port_moe

    calls = []

    def record(idx, top):
        top = top.detach().float()
        calls.append((idx.numpy(), (top[..., :-1] - top[..., 1:]).min(-1).values.numpy()))

    real, port_moe.router_topk = _router_trace(port_moe, record)
    try:
        size = len(batch["tokens"]) // n_micro
        with torch.no_grad():
            for i in range(n_micro):
                model(torch.as_tensor(np.asarray(batch["tokens"][i * size:(i + 1) * size]), dtype=torch.long))
    finally:
        port_moe.router_topk = real
    return calls


def _assert_routes_tie(ref_calls, port_calls):
    """Router call by call, every token whose experts differ between the two
    packages is a tie (TIE_EPS); returns how many differed."""
    assert len(ref_calls) == len(port_calls) > 0, (len(ref_calls), len(port_calls))
    differ = 0
    for n, ((ri, rg), (pi, pg)) in enumerate(zip(ref_calls, port_calls)):
        for t in np.nonzero((ri != pi).any(-1))[0]:
            margin = max(float(rg[t]), float(pg[t]))
            assert margin < TIE_EPS, (f"step 1, router call {n}, token {t}: experts {ri[t].tolist()} in the "
                                      f"reference, {pi[t].tolist()} in the port, top-k margin {margin}")
            differ += 1
    return differ


#: the reference's three train steps of each smoke config, run once and
#: shared by the comparison and its controls
_REFERENCE_RUNS = {}


def _reference_run(arch, overrides):
    """The reference's side of ``_three_steps_against_reference``: the config,
    the starting weights, the batches, step 1's routes (MoE) and each step's
    metrics, first moments and parameters."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _REFERENCE_RUNS:
        cfg = dataclasses.replace(ref_smoke(arch), **overrides)
        rkw = dict(schedule=RefScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10), microbatches=2)
        params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(3), cfg.param_jdtype())
        start = jax.tree_util.tree_map(np.asarray, params)
        batches = _batches(cfg, 3)
        routes = _reference_routes(cfg, params, batches[0], 2) if cfg.moe is not None else None
        jst = ref_adamw_init(params, jnp.dtype(cfg.opt_state_dtype))
        ref_step = jax.jit(ref_make_train_step(cfg, RefTrainConfig(**rkw)))
        steps = []
        for batch in batches:
            params, jst, jm = ref_step(params, jst, batch)
            steps.append({"metrics": {k: float(jm[k]) for k in ("loss", "grad_norm", "lr", "tokens")},
                          "m": flatten_jax_tree(jax.tree_util.tree_map(_f32, jst["m"]), cfg),
                          "params": flatten_jax_tree(jax.tree_util.tree_map(np.asarray, params), cfg)})
        _REFERENCE_RUNS[key] = (cfg, start, batches, routes, steps)
    return _REFERENCE_RUNS[key]


def _three_steps_against_reference(arch, **overrides):
    """Train three steps of the smoke config (with ``overrides`` of its
    fields) on the port and on the reference from the same weights and hold
    them together; raises AssertionError naming the step that fails.  A MoE
    config's experts are compared first, on each microbatch of step 1."""
    loss_rtol, gnorm_rtol, param_atol, change_rel = LATER_TOL[arch]
    cfg, params, batches, routes, ref_steps = _reference_run(arch, overrides)
    assert cfg.compute_dtype == "float32" and cfg.remat == ("full" if arch == "mamba2-130m" else "none")
    model = load_jax_params(Transformer(dataclasses.replace(get_smoke_config(arch), **overrides), device="cpu"),
                            params)
    start = {name: p.detach().numpy().copy() for name, p in model.named_parameters()}
    if routes is not None:
        _assert_routes_tie(routes, _port_routes(model, batches[0], 2))
    tcfg = TrainConfig(schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10), microbatches=2)
    step = make_train_step(model, tcfg)
    tst = adamw_init(dict(model.named_parameters()), torch_dtype(cfg.opt_state_dtype))
    assert all(m.dtype == torch_dtype(cfg.opt_state_dtype) for m in tst["m"].values())

    def change_gaps(ref):  # each leaf's change since the start, port against reference
        return {name: _rel(p.detach().numpy() - start[name], ref[name] - start[name])
                for name, p in model.named_parameters()}

    for i, (batch, ref) in enumerate(zip(batches, ref_steps)):
        jm = ref["metrics"]
        tst, tm = step(tst, batch)
        first = i == 0
        what = f"step {i + 1}"
        np.testing.assert_allclose(float(tm["loss"]), jm["loss"], err_msg=f"{what} loss",
                                   rtol=STEP1_TOL["loss"] if first else loss_rtol)
        np.testing.assert_allclose(float(tm["grad_norm"]), jm["grad_norm"], err_msg=f"{what} grad norm",
                                   rtol=STEP1_TOL["grad_norm"] if first else gnorm_rtol)
        np.testing.assert_allclose(float(tm["lr"]), jm["lr"], rtol=1e-6)
        assert int(tm["tokens"]) == int(jm["tokens"]) == 4 * 32
        if first:
            grad = {name: _rel(tst["m"][name].float().numpy(), ref["m"][name]) for name in start}
            assert max(grad.values()) <= STEP1_TOL["grad"], f"{what} gradients: {grad}"
            change = change_gaps(ref["params"])
            assert max(change.values()) <= STEP1_TOL["change"], f"{what} parameter changes: {change}"
    change = change_gaps(ref_steps[-1]["params"])
    assert max(change.values()) <= change_rel, f"parameter changes over three steps: {change}"
    if param_atol is not None:
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref_steps[-1]["params"][name], rtol=0, atol=param_atol,
                                       err_msg=name)


#: the smoke configs trained against the reference, and gemma-7b's at its
#: published head dim of 256 (16 x 256 on the card runs the tensor-core
#: flash kernels at D = 256 forward and backward)
TRAINED = [("mamba2-130m", {}), ("deepseek-7b", {}), ("gemma-7b", {}), ("gemma-7b", {"head_dim": 256}),
           ("deepseek-v2-lite-16b", {}), ("llama4-scout-17b-a16e", {}), ("qwen2-72b", {}),
           ("qwen2-72b", {"opt_state_dtype": "bfloat16"}), ("phi3-medium-14b", {}), ("jamba-1.5-large-398b", {})]
TRAINED_IDS = ["mamba2-130m", "deepseek-7b", "gemma-7b", "gemma-7b-head_dim256", "deepseek-v2-lite-16b",
               "llama4-scout-17b-a16e", "qwen2-72b", "qwen2-72b-bf16_moments", "phi3-medium-14b",
               "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch,overrides", TRAINED, ids=TRAINED_IDS)
def test_three_train_steps_match_reference(arch, overrides):
    _three_steps_against_reference(arch, **overrides)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward multiplies the gradient by ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


@pytest.mark.parametrize("scale", [0.0, -1.0, 1.01], ids=["zeroed", "negated", "one_percent_large"])
def test_three_train_steps_catch_a_wrong_attention_gradient(monkeypatch, scale):
    """The control of the comparison above: with the gradient into attention's
    q, k and v scaled by ``scale`` on the port's side it fails at step 1."""
    from repro_torch.kernels import ops

    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: _ScaleGrad.apply(flash(*a, **kw), scale))
    with pytest.raises(AssertionError, match="step 1"):
        _three_steps_against_reference("deepseek-7b")


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-130m"])
def test_microbatch_equivalence(arch):
    """Grad accumulation over 2 microbatches == a single-batch step (fp32)."""
    cfg = get_smoke_config(arch)
    batch = _batches(cfg, 1, batch=4, seq=16)[0]
    outs = {}
    for n_micro in (1, 2):
        tcfg = TrainConfig(microbatches=n_micro, seed=5)
        model, opt = init_train_state(cfg, tcfg, device="cpu")
        _, m = make_train_step(model, tcfg)(opt, batch)
        outs[n_micro] = ([p.detach().clone() for p in model.parameters()], float(m["loss"]))
    assert outs[1][1] == pytest.approx(outs[2][1], rel=1e-5)
    for a, b in zip(outs[1][0], outs[2][0]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_bf16_gradients_add_into_the_fp32_accumulator_bit_for_bit():
    """bf16 weights, 2 microbatches, fp32 accumulator: the step adds each
    bf16 gradient into the accumulator op by op; the result is bit for bit
    that of adding fp32 copies of the gradients, as the step did before."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-7b"), param_dtype="bfloat16", compute_dtype="bfloat16",
                              opt_state_dtype="bfloat16")
    batch = _batches(cfg, 1, batch=4, seq=16)[0]
    tcfg = TrainConfig(microbatches=2, seed=5)
    runs = []
    for copies in (False, True):
        model, opt = init_train_state(cfg, tcfg, device="cpu")
        if not copies:
            opt, metrics = make_train_step(model, tcfg)(opt, batch)
        else:
            params = dict(model.named_parameters())
            loss_fn, acc = make_loss_fn(model, tcfg), None
            for i in range(2):
                total, _ = loss_fn({k: v[2 * i:2 * i + 2] for k, v in batch.items()})
                grads = [g.float() for g in torch.autograd.grad(total, list(params.values()))]
                if acc is None:
                    acc = grads
                else:
                    torch._foreach_add_(acc, grads)
            torch._foreach_div_(acc, 2.0)
            grads, _ = clip_by_global_norm(dict(zip(params, acc)), tcfg.adamw.grad_clip)
            opt = adamw_update(grads, opt, params, learning_rate(0, tcfg.schedule), tcfg.adamw)
        runs.append([p.detach().clone() for p in model.parameters()] + list(opt["m"].values()))
    assert all(a.dtype == torch.bfloat16 for a in runs[0])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_is_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = {"a.w": torch.randn(3, 4, generator=g), "b": torch.randn(5, generator=g).to(torch.bfloat16)}
    opt = adamw_init(params)
    opt["step"] = torch.tensor(7)
    ck = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(params, opt, {"step": step, "note": "x"}, step=step)
    ck.wait()
    assert ck.committed_steps() == [2, 3]  # retention
    p2, o2, meta = ck.restore_latest()
    assert meta == {"step": 3, "note": "x"}
    for k, v in params.items():
        assert p2[k].dtype == v.dtype and torch.equal(p2[k], v), k
    assert torch.equal(o2["step"], opt["step"]) and torch.equal(o2["m"]["b"], opt["m"]["b"])
    # a save without its COMMIT marker is invisible
    (tmp_path / "step_00000009").mkdir()
    assert ck.committed_steps() == [2, 3]
    # the snapshot is taken at save(): later in-place updates do not leak into it
    ck.save(params, opt, {}, step=4)
    params["a.w"].add_(1.0)
    ck.wait()
    assert not torch.equal(ck.restore_latest()[0]["a.w"], params["a.w"])


def test_resume_replays_the_same_losses(tmp_path):
    cfg = get_smoke_config("mamba2-130m")
    tcfg = TrainConfig(microbatches=1)
    dcfg = DataConfig(global_batch=2, seq_len=16, vocab_size=cfg.vocab_size)
    it = make_train_iter(dcfg)
    tr = Trainer(cfg, tcfg, it, ckpt_manager=CheckpointManager(str(tmp_path)), ckpt_every=2, device="cpu")
    model, opt = tr.restore_or_init()
    _, _, hist_a = tr.run(model, opt, 3)  # commits step 2 only
    tr.ckpt.wait()
    it.close()
    tr2 = Trainer(cfg, tcfg, make_train_iter(dcfg, start_index=2),
                  ckpt_manager=CheckpointManager(str(tmp_path)), device="cpu")
    model2, opt2 = tr2.restore_or_init()
    assert tr2.step == 2 and int(opt2["step"]) == 2
    _, _, hist_b = tr2.run(model2, opt2, 1)
    tr2.data_iter.close()
    assert hist_b[0]["loss"] == hist_a[2]["loss"]


# --------------------------------------------------------------------------- trainer lanes
def test_train_and_eval_lanes_stay_separate(tmp_path):
    cfg = get_smoke_config("mamba2-130m")
    dcfg = DataConfig(global_batch=2, seq_len=16, vocab_size=cfg.vocab_size)
    it, ev = make_train_iter(dcfg), make_train_iter(DataConfig(global_batch=2, seq_len=16,
                                                                vocab_size=cfg.vocab_size, seed=9))
    tr = Trainer(cfg, TrainConfig(), it, eval_iter=ev, ckpt_manager=CheckpointManager(str(tmp_path)),
                 ckpt_every=2, eval_every=2, device="cpu")
    model, opt = tr.restore_or_init()
    _, _, hist = tr.run(model, opt, 4)
    tr.ckpt.wait()
    it.close()
    ev.close()
    train, evals = tr.stats.summary(tr.train_stream), tr.stats.summary(tr.eval_stream)
    assert len(hist) == train["steps"] == 4 and evals["steps"] == 2 == len(tr.eval_history)
    assert train["tokens"] == 4 * 2 * 16 and evals["tokens"] == 0
    # the cost is counted once, on fake copies, and lands on the train lane
    # only; a fake tensor takes the kernel's path on either device, so the SSD
    # scan's launches are priced by formula as on the card
    assert tr.cost_parts["ssd_kernel"] > 0 and tr.cost_parts["counted"] > 0
    assert train["flops"] == 4 * tr.step_cost.flops and evals["flops"] == 0
    assert tr.ckpt.committed_steps() == [2, 4]
    frame = tr.frame()
    assert frame.filter(stream="train").sum() == frame.filter(stream=tr.train_stream).sum()


@pytest.mark.parametrize("scale", [0.0, -1.0, 1.01], ids=["zeroed", "negated", "one_percent_large"])
def test_three_train_steps_catch_a_wrong_attention_gradient_in_mla_and_moe(monkeypatch, scale):
    """The same control on deepseek-v2-lite's smoke config: MLA's attention
    (q/k 24, v 16) between a dense first layer and MoE layers."""
    from repro_torch.kernels import ops

    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: _ScaleGrad.apply(flash(*a, **kw), scale))
    with pytest.raises(AssertionError, match="step 1"):
        _three_steps_against_reference("deepseek-v2-lite-16b")


@pytest.mark.parametrize("scale", [0.0, -1.0, 1.01], ids=["zeroed", "negated", "one_percent_large"])
def test_three_train_steps_catch_a_wrong_attention_gradient_at_head_dim_256(monkeypatch, scale):
    """The same control on gemma-7b's smoke config at head dim 256."""
    from repro_torch.kernels import ops

    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: _ScaleGrad.apply(flash(*a, **kw), scale))
    with pytest.raises(AssertionError, match="step 1"):
        _three_steps_against_reference("gemma-7b", head_dim=256)


@pytest.mark.parametrize("arch,overrides", TRAINED, ids=TRAINED_IDS)
def test_train_lane_counts_hbm_bytes(arch, overrides):
    """The train lane's ``GLOBAL_ACC_R`` MISS counter reads steps × the first
    step's counted bytes (the reference fills it from its compiled cost);
    the eval lane carries none."""
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    dcfg = DataConfig(global_batch=2, seq_len=16, vocab_size=cfg.vocab_size)
    it, ev = make_train_iter(dcfg), make_train_iter(DataConfig(global_batch=2, seq_len=16,
                                                                vocab_size=cfg.vocab_size, seed=9))
    tr = Trainer(cfg, TrainConfig(), it, eval_iter=ev, eval_every=2, device="cpu")
    model, opt = tr.restore_or_init()
    tr.run(model, opt, 3)
    it.close()
    ev.close()
    # the count takes every kernel's path (fake tensors on any device): the
    # bytes are what the dispatch counter saw and each kernel's launches by formula
    parts = tr.cost_parts
    assert parts["bytes_counted"] > 0
    assert tr.step_cost.hbm_bytes == sum(v for k, v in parts.items() if k.startswith("bytes_"))
    assert parts["bytes_flash_forward"] + parts["bytes_ssd_kernel"] > 0
    # an fp32 model moves at least its parameters, their gradients and AdamW's two moments
    n_params = sum(p.numel() for p in model.parameters())
    assert tr.step_cost.hbm_bytes > 4 * 4 * n_params
    frame = tr.frame()
    miss = dict(access_type="GLOBAL_ACC_R", outcome="MISS")
    assert frame.filter(stream="train", **miss).sum() == 3 * int(tr.step_cost.hbm_bytes)
    assert frame.filter(stream="eval", **miss).sum() == 0
    assert tr.stats.summary(tr.eval_stream)["hbm_bytes"] == 0


def test_kernel_launches_add_their_cost_by_formula():
    """Kernels launched through ctypes are invisible to both counters: each
    launch adds the FLOPs and bytes of its bound (here the launches of one
    card step of deepseek-7b smoke with 2 microbatches: 4 layers × 2 forward
    and backward, as the wrapper records them; the SSD kernel did not
    launch), priced by ``perf.cost.kernel_costs``, the trainer's count."""
    from collections import Counter

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.perf.cost import kernel_costs

    cfg = get_smoke_config("deepseek-7b")
    shape, D = (2, 64, 64, cfg.n_heads), cfg.resolved_head_dim
    rec = fa.FlashLaunch(*shape, cfg.n_kv_heads, D, D, causal=True, prefix_len=0, esize=4)
    got = kernel_costs({"ssd_kernel": Counter(), "flash_forward": Counter({rec: 8}),
                        "flash_backward": Counter({rec: 8})})
    # two products of 2·B·H·S²·D, halved by causality
    assert got["flash_forward"] == 8 * fa.flash_flops(*shape, D, causal=True) == 8 * 2 * 2 * cfg.n_heads * 64 * 64 * D
    assert got["flash_backward"] == 8 * fa.flash_flops(*shape, D, causal=True, backward=True)
    assert got["flash_backward"] == 2.5 * got["flash_forward"]
    assert got["bytes_flash_forward"] == 8 * 4 * 4 * (2 * 64 * cfg.n_heads * D)  # q, k, v, out in fp32
    assert got["bytes_flash_backward"] == 8 * (4 * 8 * (2 * 64 * cfg.n_heads * D) + 4 * 2 * cfg.n_heads * 64)
    assert got["ssd_kernel"] == got["bytes_ssd_kernel"] == 0


def test_train_entry_point_runs_and_resumes(tmp_path, capsys):
    args = ["--small", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    train_main(args)
    out = capsys.readouterr().out
    assert "training mamba2-130m" in out and "loss:" in out and "stream" in out
    train_main(args[:4] + ["3"] + args[5:])
    assert "resumed from checkpoint at step 2" in capsys.readouterr().out
