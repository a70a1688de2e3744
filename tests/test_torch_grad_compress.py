"""Int8 gradient compression, the compressed train step and multi-host
checkpoints of the port against the reference's, on the CPU.

* ``quantize_int8``: the int8 payload equal element for element, the scale
  and the dequantised values within 1e-7 relative, over seeded shapes (a
  zero tensor, ties at .5 and a single outlier among them).
* ``ef_compress``: each step's output and error-feedback state against the
  reference's over 50 steps, and the long-run sum: the compressed
  gradients add up to the true ones less the last residual.
* The deepseek-7b smoke config trained three steps with ``compress_grads``
  at ``accum_dtype`` fp32 and bf16, in 1 and 2 microbatches, against the
  reference's ``make_train_step``, each step from the reference's state
  before it and held to ``tests/test_torch_train.py``'s step-1 tolerances
  (``STEP1_TOL``) where the step is continuous and exactly where int8
  rounding is not (the block above ``_compressed_steps_against_reference``
  says why); a zeroed, negated or 1 % too large attention gradient fails
  it.
* ``CheckpointManager(host_id, n_hosts)``: a two-host save restored whole,
  the error-feedback state with it; a save without COMMIT invisible; an
  elastic restore onto a ``DeviceMesh`` (torch's ``fake`` backend) through
  ``sharding_fn``.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as ref_smoke
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.optim import ScheduleConfig as RefScheduleConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import dequantize_int8 as ref_dequantize
from repro.optim import ef_compress as ref_ef_compress
from repro.optim import ef_state_init as ref_ef_state_init
from repro.optim import quantize_int8 as ref_quantize
from repro.optim import wire_bytes as ref_wire_bytes
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.models import Transformer, load_jax_params
from repro_torch.models.convert import flatten_jax_tree
from repro_torch.optim import (
    ScheduleConfig,
    adamw_init,
    dequantize_int8,
    ef_compress,
    ef_state_init,
    quantize_int8,
    wire_bytes,
)
from repro_torch.train import TrainConfig, Trainer, init_train_state, make_train_step
from test_torch_train import STEP1_TOL, _batches, _rel

QUANT_REL = 1e-7


def _seeded(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


QUANT_CASES = {
    "matrix": _seeded((64, 48), 0),
    "vector": _seeded((1000,), 1, 1e-3),
    "stack": _seeded((3, 16, 8), 2, 50.0),
    "zeros": np.zeros((5, 7), np.float32),
    "ties": (np.arange(-254, 255, dtype=np.float32) / 2.0),  # max 127: every k + .5 a tie, half to even
    "outlier": np.concatenate([_seeded((511,), 3, 1e-4), np.array([10.0], np.float32)]),
    "tiny": np.full((4,), 1e-14, np.float32),  # below the 1e-12 floor
}


@pytest.mark.parametrize("name", list(QUANT_CASES))
def test_quantize_matches_reference(name):
    x = QUANT_CASES[name]
    q, s = quantize_int8(torch.from_numpy(x.copy()))
    rq, rs = ref_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and q.shape == x.shape and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=QUANT_REL, atol=0)
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(), np.asarray(ref_dequantize(rq, rs)), rtol=QUANT_REL,
                               atol=0)
    assert q.abs().max() <= 127
    if name == "ties":  # round half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        assert q[254 + 1] == 0 and q[254 + 3] == 2 and q[254 - 5] == -2


def test_quantize_takes_bf16_and_keeps_its_input():
    x = torch.from_numpy(_seeded((32, 32), 4)).to(torch.bfloat16)
    before = x.clone()
    q, s = quantize_int8(x)
    rq, rs = ref_quantize(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=QUANT_REL)
    assert torch.equal(x, before)


def test_ef_compress_matches_reference_over_steps_and_sums_to_the_true_gradient():
    shapes = {"w": (64, 32), "b": (32,), "e": (4, 8, 16)}
    grads = [{k: _seeded(s, 100 * i + j, 0.1) for j, (k, s) in enumerate(shapes.items())} for i in range(50)]
    ef = ef_state_init({k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()})
    ref_ef = ref_ef_state_init({k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()})
    assert all(e.dtype == torch.float32 and not e.any() for e in ef.values())
    total = {k: np.zeros(s, np.float64) for k, s in shapes.items()}
    sent = {k: np.zeros(s, np.float64) for k, s in shapes.items()}
    for g in grads:
        deq, ef = ef_compress({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ef)
        rdeq, ref_ef = ref_ef_compress({k: jnp.asarray(v) for k, v in g.items()}, ref_ef)
        for k in shapes:
            assert deq[k].dtype == torch.float32
            np.testing.assert_allclose(deq[k].numpy(), np.asarray(rdeq[k]), rtol=QUANT_REL, atol=1e-12, err_msg=k)
            np.testing.assert_allclose(ef[k].numpy(), np.asarray(ref_ef[k]), rtol=1e-6, atol=1e-9, err_msg=k)
            total[k] += g[k]
            sent[k] += deq[k].numpy()
    for k in shapes:
        # what was sent plus what is still owed is what was computed
        np.testing.assert_allclose(sent[k] + ef[k].numpy(), total[k], rtol=0, atol=1e-4)
        # and the residual stays below one quantisation step of the last call
        assert np.abs(ef[k].numpy()).max() <= np.abs(total[k]).max()


def test_a_group_shares_the_scale_of_the_reference_stacked_leaf():
    """Three layers' leaves of one group against the reference's stacked
    leaf of the three: one scale, the same payload and state."""
    layers = [_seeded((16, 8), 10 + i, 10.0 ** -i) for i in range(3)]
    stacked = np.stack(layers)
    names = [f"layers.{i}.attn.wq" for i in range(3)]
    groups = {n: "blocks/pos_0/attn/wq" for n in names}
    ef = ef_state_init({n: torch.zeros(16, 8) for n in names})
    ref_ef = jnp.zeros(stacked.shape)
    for step in range(3):
        g = {n: torch.from_numpy(x.copy() * (step + 1)) for n, x in zip(names, layers)}
        deq, ef = ef_compress(g, ef, groups)
        rdeq, ref_ef = ref_ef_compress({"w": jnp.asarray(stacked * (step + 1))}, {"w": ref_ef})
        rdeq, ref_ef = rdeq["w"], ref_ef["w"]
        for i, n in enumerate(names):
            np.testing.assert_allclose(deq[n].numpy(), np.asarray(rdeq[i]), rtol=QUANT_REL, atol=1e-12, err_msg=n)
            np.testing.assert_allclose(ef[n].numpy(), np.asarray(ref_ef[i]), rtol=1e-6, atol=1e-9, err_msg=n)
    # layer 2's gradients are 100x below layer 0's: the shared scale leaves them mostly zero, as in the reference
    assert (deq[names[2]] == 0).float().mean() > 0.5
    assert wire_bytes({n: torch.zeros(16, 8) for n in names}, groups) == 3 * 128 + 4
    assert ref_wire_bytes({"w": stacked}) == 3 * 128 + 4


def test_compress_groups_follow_the_reference_stack():
    from repro_torch.train.trainer import compress_groups

    cfg = get_smoke_config("deepseek-v2-lite-16b")  # a dense first layer before the stack
    names = [n for n, _ in Transformer(cfg, device="cpu").named_parameters()]
    groups = compress_groups(cfg, names)
    ref_leaves = {"/".join(str(getattr(p, "key", p)) for p in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(ref_model_defs(ref_smoke("deepseek-v2-lite-16b")),
                                                       is_leaf=lambda x: hasattr(x, "logical_axes"))[0]}
    assert set(groups.values()) == ref_leaves
    assert groups["layers.0.attn.wq"] == "prefix_0/attn/wq" and groups["embed.embedding"] == "embed/embedding"
    assert groups["layers.1.attn.wq"] == groups[f"layers.{cfg.n_layers - 1}.attn.wq"] == "blocks/pos_0/attn/wq"


def test_ef_compress_updates_the_state_in_place():
    g = {"w": torch.from_numpy(_seeded((8, 8), 5))}
    ef = ef_state_init(g)
    buf = ef["w"]
    _, new = ef_compress(g, ef)
    assert new["w"] is buf and buf.any()


def test_wire_bytes_matches_reference():
    params = {"a": np.zeros((64, 32), np.float32), "b": np.zeros((7,), np.float32)}
    assert wire_bytes({k: torch.from_numpy(v) for k, v in params.items()}) == ref_wire_bytes(params) == 64 * 32 + 7 + 8


# --------------------------------------------------------------------------- the compressed train step
# Int8 rounding is a step function: where the two packages' fp32 gradients (which differ by summation
# order, up to 7.3e-4 relative L2 in this config at step 1) straddle a rounding boundary, their payloads
# differ by a whole quantum, the error feedback carries that quantum on, and AdamW turns an entry that one
# package sends as 0 and the other as one quantum into a whole step of the lr (measured: 2 of the 4
# variants' third-step grad norms 12.7 % apart when the two run free).  So each of the three steps starts
# the port from the reference's state before it (weights, moments, error feedback, step count) and is held
# at STEP1_TOL, where the step is continuous, and exactly where it is not: (a) each microbatch's fp32
# gradient, the compressor's input before its error feedback, within STEP1_TOL["grad"] of the reference's;
# (b) the port's compression of its own inputs equal to the reference's ef_compress of the same inputs (its
# stacked leaf, one scale; QUANT_REL); (c) the rest of the port's step (the accumulator in accum_dtype, the
# mean, the clip, AdamW) equal to the reference's arithmetic on the port's compressed gradients
# (test_torch_train's AdamW tolerances, rtol 1e-5, atol 1e-7); (d) the step's loss and grad norm within
# STEP1_TOL.
_REF_RUNS = {}


def _reference_compressed_run(n_micro: int, accum: str):
    """The reference's three compressed steps of the deepseek-7b smoke config:
    the batches and, per step, the state before it (weights, moments, error
    feedback, step count; by port name), its compressor calls (each
    microbatch's fp32 gradient) and its metrics."""
    import repro.train.trainer as ref_trainer

    key = (n_micro, accum)
    if key not in _REF_RUNS:
        cfg = ref_smoke("deepseek-7b")
        tcfg = RefTrainConfig(schedule=RefScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10),
                              microbatches=n_micro, compress_grads=True, accum_dtype=accum)
        params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(3), cfg.param_jdtype())
        jst = ref_adamw_init(params)
        jst["ef"] = ref_ef_state_init(params)
        flat = lambda t: flatten_jax_tree(jax.tree_util.tree_map(np.asarray, t), cfg)
        calls = []
        real = ref_trainer.ef_compress

        def recorded(grads, ef):
            jax.debug.callback(lambda g: calls.append(flat(g)),
                               jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), grads), ordered=True)
            return real(grads, ef)

        ref_trainer.ef_compress = recorded
        try:
            step = jax.jit(ref_make_train_step(cfg, tcfg))
            batches = _batches(cfg, 3)
            steps = []
            for batch in batches:
                before = {"tree": jax.tree_util.tree_map(np.asarray, params), "m": flat(jst["m"]),
                          "v": flat(jst["v"]), "ef": flat(jst["ef"]), "step": int(jst["step"])}
                params, jst, jm = step(params, jst, batch)
                jax.block_until_ready(jm)
                steps.append({"before": before, "calls": calls[-n_micro:],
                              "metrics": {k: float(jm[k]) for k in ("loss", "grad_norm", "lr", "tokens")}})
        finally:
            ref_trainer.ef_compress = real
        assert len(calls) == 3 * n_micro
        _REF_RUNS[key] = (batches, steps)
    return _REF_RUNS[key]


def _reference_tail(port_calls, before, n_micro, accum, grad_norm, lr):
    """The reference's arithmetic after the compressor (``train/trainer.py``:
    the accumulator in ``accum``, the mean, the clip at ``grad_norm``, AdamW
    from ``before``'s moments and step) on the port's compressed microbatch
    gradients → ``(first moments, parameters)`` by port name."""
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import adamw_update as ref_adamw_update

    names = sorted(port_calls[0])
    if n_micro == 1:
        grads = {n: jnp.asarray(port_calls[0][n]["deq"]) for n in names}
    else:
        acc_dt = jnp.dtype(accum)
        acc = {n: jnp.zeros(port_calls[0][n]["deq"].shape, acc_dt) for n in names}
        for call in port_calls:
            acc = {n: (acc[n].astype(jnp.float32) + jnp.asarray(call[n]["deq"])).astype(acc_dt) for n in names}
        grads = {n: acc[n] / n_micro for n in names}
    scale = jnp.minimum(1.0, 1.0 / jnp.maximum(jnp.float32(grad_norm), 1e-12))
    grads = {n: (g.astype(jnp.float32) * scale).astype(g.dtype) for n, g in grads.items()}
    state = {"m": {n: jnp.asarray(before["m"][n]) for n in names}, "v": {n: jnp.asarray(before["v"][n]) for n in names},
             "step": jnp.asarray(before["step"], jnp.int32)}
    params = {n: jnp.asarray(before["params"][n]) for n in names}
    new_params, st = ref_adamw_update(grads, state, params, jnp.float32(lr), RefAdamWConfig())
    return {n: np.asarray(st["m"][n]) for n in names}, {n: np.asarray(new_params[n]) for n in names}


def _compressed_steps_against_reference(n_micro: int, accum: str):
    """Three compressed steps of the smoke config, each from the reference's
    state before it, held as the block above says; raises AssertionError
    naming the step that fails."""
    import repro_torch.train.trainer as port_trainer
    from repro_torch.train import compress_groups

    batches, ref_steps = _reference_compressed_run(n_micro, accum)
    tcfg = TrainConfig(schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10), microbatches=n_micro,
                       compress_grads=True, accum_dtype=accum)
    model = Transformer(get_smoke_config("deepseek-7b"), device="cpu")
    step = make_train_step(model, tcfg)
    names = [n for n, _ in model.named_parameters()]
    groups = compress_groups(model.cfg, names)
    real = port_trainer.ef_compress
    calls = []  # a step's compressor calls by microbatch: each leaf's input gradient, error feedback, output

    def recorded(grads, ef, groups_):
        if not calls or set(grads) & set(calls[-1]):  # a leaf seen again: the next microbatch
            calls.append({})
        before = {n: ef[n].clone() for n in grads}  # read before the in-place update
        g32 = {n: g.float().clone() for n, g in grads.items()}
        deq, new = real(grads, ef, groups_)
        calls[-1].update({n: {"g": g32[n].numpy(), "e": before[n].numpy(), "deq": deq[n].numpy().copy(),
                              "e_new": new[n].numpy().copy()} for n in grads})
        return deq, new

    for i, (batch, ref) in enumerate(zip(batches, ref_steps)):
        what = f"step {i + 1}"
        before = ref["before"]
        load_jax_params(model, before["tree"])
        before["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        tst = {k: {n: torch.from_numpy(before[k][n].copy()) for n in names} for k in ("m", "v", "ef")}
        tst["step"] = torch.tensor(before["step"])
        calls.clear()
        port_trainer.ef_compress = recorded
        try:
            tst, tm = step(tst, batch)
        finally:
            port_trainer.ef_compress = real
        jm = ref["metrics"]
        np.testing.assert_allclose(float(tm["loss"]), jm["loss"], rtol=STEP1_TOL["loss"], err_msg=f"{what} loss")
        np.testing.assert_allclose(float(tm["grad_norm"]), jm["grad_norm"], rtol=STEP1_TOL["grad_norm"],
                                   err_msg=f"{what} grad norm")
        np.testing.assert_allclose(float(tm["lr"]), jm["lr"], rtol=1e-6)
        assert int(tm["tokens"]) == int(jm["tokens"]) == 4 * 32
        assert len(calls) == n_micro and all(sorted(c) == sorted(names) for c in calls), what
        for k, (mine, theirs) in enumerate(zip(calls, ref["calls"])):
            grad = {n: _rel(mine[n]["g"], theirs[n]) for n in names}
            assert max(grad.values()) <= STEP1_TOL["grad"], f"{what}, microbatch {k + 1} gradients: {grad}"
            for key in sorted(set(groups.values())):
                members = [n for n in sorted(names) if groups[n] == key]
                flat = lambda f: jnp.concatenate([jnp.asarray(mine[n][f]).ravel() for n in members])
                rdeq, ref_e = ref_ef_compress({"w": flat("g")}, {"w": flat("e")})
                np.testing.assert_allclose(np.concatenate([mine[n]["deq"].ravel() for n in members]),
                                           np.asarray(rdeq["w"]), rtol=QUANT_REL, atol=1e-12,
                                           err_msg=f"{what}, microbatch {k + 1}: {key}'s compression")
                np.testing.assert_allclose(np.concatenate([mine[n]["e_new"].ravel() for n in members]),
                                           np.asarray(ref_e["w"]), rtol=1e-6, atol=1e-9,
                                           err_msg=f"{what}, microbatch {k + 1}: {key}'s error feedback")
        want_m, want_p = _reference_tail(calls, before, n_micro, accum, float(tm["grad_norm"]), float(tm["lr"]))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(tst["m"][n].numpy(), want_m[n], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what}: {n}'s first moment after the compressor")
            np.testing.assert_allclose(p.detach().numpy(), want_p[n], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what}: {n} after the compressor")
        assert all(e.dtype == torch.float32 for e in tst["ef"].values()) and int(tst["step"]) == i + 1


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_compressed_train_steps_match_reference(n_micro, accum):
    _compressed_steps_against_reference(n_micro, accum)


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
def test_compressed_comparison_catches_a_wrong_attention_gradient(monkeypatch, scale):
    """The control: with the gradient into attention's q, k and v scaled on
    the port's side, the compressed comparison fails at step 1."""
    from repro_torch.kernels import ops

    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: _ScaleGrad.apply(flash(*a, **kw), scale))
    with pytest.raises(AssertionError, match="step 1"):
        _compressed_steps_against_reference(2, "bfloat16")


def test_bf16_accumulator_rounds_each_microbatch():
    """Two microbatches into a bf16 accumulator: the step's gradient is
    ``bf16(bf16(bf16(g1) + g2) / 2)`` of the fp32 gradients (no compression),
    which an fp32 accumulator does not round."""
    cfg = get_smoke_config("deepseek-7b")
    batch = _batches(cfg, 1, batch=4, seq=16)[0]
    grads = {}
    for accum in ("float32", "bfloat16"):
        tcfg = TrainConfig(microbatches=2, accum_dtype=accum, seed=5)
        model, opt = init_train_state(cfg, tcfg, device="cpu")
        seen = {}
        import repro_torch.train.trainer as trainer_mod

        real = trainer_mod.clip_by_global_norm
        trainer_mod.clip_by_global_norm = lambda tree, c: (seen.update({k: v.clone() for k, v in tree.items()}),
                                                            real(tree, c))[1]
        try:
            make_train_step(model, tcfg)(opt, batch)
        finally:
            trainer_mod.clip_by_global_norm = real
        grads[accum] = seen
    name = "layers.0.attn.wq"
    assert grads["bfloat16"][name].dtype == torch.bfloat16 and grads["float32"][name].dtype == torch.float32
    # the bf16 mean is the fp32 one within bf16's rounding of the two additions, and not equal to it
    diff = (grads["bfloat16"][name].float() - grads["float32"][name]).abs()
    assert diff.max() <= 2 * 2 ** -8 * grads["float32"][name].abs().max() and diff.max() > 0


def test_init_train_state_adds_the_error_feedback_buffers():
    cfg = get_smoke_config("deepseek-7b")
    model, opt = init_train_state(cfg, TrainConfig(compress_grads=True), device="cpu")
    assert sorted(opt["ef"]) == sorted(n for n, _ in model.named_parameters())
    assert all(e.dtype == torch.float32 and e.shape == p.shape and not e.any()
               for (n, p), e in zip(model.named_parameters(), opt["ef"].values()))
    assert "ef" not in init_train_state(cfg, TrainConfig(), device="cpu")[1]


def test_compressed_training_checkpoints_and_resumes_with_its_error_feedback(tmp_path):
    """The trainer saves ``opt_state["ef"]`` with the moments and a resumed
    run continues bit for bit as the uninterrupted one does."""
    from repro_torch.data import DataConfig, make_train_iter

    cfg = get_smoke_config("deepseek-7b")
    tcfg = TrainConfig(microbatches=2, compress_grads=True, accum_dtype="bfloat16",
                       schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10))
    dcfg = DataConfig(global_batch=4, seq_len=16, vocab_size=cfg.vocab_size, seed=3)

    def run(steps, ckpt=None, start_index=0):
        it = make_train_iter(dcfg, start_index=start_index)
        tr = Trainer(cfg, tcfg, it, ckpt_manager=ckpt, ckpt_every=2 if ckpt else 0, device="cpu")
        model, opt = tr.restore_or_init()
        model, opt, hist = tr.run(model, opt, steps)
        it.close()
        return tr, model, opt, hist

    _, _, straight_opt, straight_hist = run(3)
    _, _, two_opt, _ = run(2)
    ck = CheckpointManager(str(tmp_path))
    run(3, ck)  # commits step 2 only
    ck.wait()
    _, saved_opt, meta = ck.restore_latest()
    assert meta["step"] == 2 and sorted(saved_opt["ef"]) == sorted(two_opt["ef"])
    for n, e in two_opt["ef"].items():
        assert e.any() and torch.equal(saved_opt["ef"][n], e), n
    tr, _, _, hist = run(1, CheckpointManager(str(tmp_path)), start_index=2)
    assert tr.step == 3 and hist[0]["loss"] == straight_hist[2]["loss"]


# --------------------------------------------------------------------------- multi-host checkpoints
def _trees(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"a": {"w": torch.randn(8, 4, generator=g)}, "b": torch.randn(6, generator=g).to(torch.bfloat16)}
    opt = {"m": {"a": {"w": torch.randn(8, 4, generator=g)}}, "step": torch.tensor(5)}
    return params, opt


def test_two_hosts_save_and_a_restore_merges_them(tmp_path):
    params, opt = _trees()
    host0 = CheckpointManager(str(tmp_path), host_id=0, n_hosts=2)
    host1 = CheckpointManager(str(tmp_path), host_id=1, n_hosts=2)
    # each host writes the leaves it holds: host 1 its half first, then host 0 (manifest, leaves, COMMIT)
    host1.save({"b": params["b"]}, {"m": opt["m"]}, {"note": "h1"}, step=10, blocking=True)
    assert host0.committed_steps() == []
    host0.save({"a": params["a"]}, {"step": opt["step"]}, {"note": "run"}, step=10, blocking=True)
    d = tmp_path / "step_00000010"
    assert sorted(os.listdir(d)) == ["COMMIT", "host_0.npz", "host_1.npz", "manifest.json"]
    p2, o2, meta = CheckpointManager(str(tmp_path)).restore_latest()
    assert meta == {"note": "run", "step": 10}
    assert torch.equal(p2["a"]["w"], params["a"]["w"]) and torch.equal(p2["b"], params["b"])
    assert p2["b"].dtype == torch.bfloat16
    assert torch.equal(o2["m"]["a"]["w"], opt["m"]["a"]["w"]) and torch.equal(o2["step"], opt["step"])


def test_a_save_without_commit_stays_invisible(tmp_path):
    params, opt = _trees()
    ck = CheckpointManager(str(tmp_path), keep=3)
    ck.save(params, opt, {"n": 1}, step=1, blocking=True)
    # a preempted step-2 save: host 1's file and no COMMIT from host 0
    CheckpointManager(str(tmp_path), host_id=1, n_hosts=2).save(*_trees(1), {"n": 2}, step=2, blocking=True)
    assert os.path.exists(tmp_path / "step_00000002" / "host_1.npz")
    assert ck.committed_steps() == [1]
    p2, _, meta = ck.restore_latest()
    assert meta["step"] == 1 and torch.equal(p2["a"]["w"], params["a"]["w"])


@contextlib.contextmanager
def _fake_world(size: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_elastic_restore_places_leaves_on_a_new_mesh(tmp_path):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_tiny_mesh

    params, opt = _trees()
    CheckpointManager(str(tmp_path)).save(params, opt, {}, step=3, blocking=True)
    with _fake_world(4):
        mesh = make_tiny_mesh(device_type="cpu")
        asked = []

        def sharding_fn(key, shape):
            asked.append((key, shape))
            return (mesh, [Shard(0), Replicate()]) if key == "params/a/w" else None

        p2, o2, _ = CheckpointManager(str(tmp_path)).restore_latest(sharding_fn=sharding_fn)
        w = p2["a"]["w"]
        assert isinstance(w, DTensor) and w.placements == (Shard(0), Replicate())
        assert w.shape == (8, 4) and w.to_local().shape == (4, 4)
        assert not isinstance(p2["b"], DTensor) and torch.equal(p2["b"], params["b"])
        assert ("params/a/w", (8, 4)) in asked and ("opt_state/step", ()) in asked
    assert torch.equal(o2["m"]["a"]["w"], opt["m"]["a"]["w"])


def test_adamw_reads_bf16_gradients_as_their_fp32_copies():
    """A bf16 accumulator's gradients go into AdamW without an fp32 copy of
    them; the update is bit for bit the one their fp32 copies give."""
    from repro_torch.optim import adamw_update

    g = torch.Generator().manual_seed(0)
    params = {f"p{i}": torch.randn(64, 33, generator=g).to(torch.bfloat16) for i in range(3)}
    params["f"] = torch.randn(17, generator=g)
    grads = {n: (torch.randn(p.shape, generator=g) * 3).to(torch.bfloat16) for n, p in params.items()}
    runs = []
    for upcast in (True, False):
        p = {n: t.clone() for n, t in params.items()}
        st = adamw_init(p)
        for _ in range(3):
            st = adamw_update({n: t.float() if upcast else t for n, t in grads.items()}, st, p, 1e-2)
        runs.append((p, st))
    (a, sa), (b, sb) = runs
    for n in params:
        assert torch.equal(a[n], b[n]) and torch.equal(sa["m"][n], sb["m"][n]) and torch.equal(sa["v"][n], sb["v"][n])
