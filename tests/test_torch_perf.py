"""The port's cost tooling (``repro_torch.perf``, ``repro_torch.sim.hlo_costs``)
against closed forms and against the reference's ``perf/`` and
``sim/hlo_costs.py``, on the CPU, both packages in one process.

* ``count_step`` counts a Python loop of ``L`` N×N matmuls as ``L·2N³``
  (an eager step dispatches every trip: no loop multiplier) and counts
  batched einsums; exact.
* The smoke deepseek-7b prefill and train cells counted by the port equal
  the reference's loop-aware count (``analyze_compiled`` of the jitted cell
  on a one-device mesh) in everything but attention, exactly (the stated
  tolerance is 0); the attention gap is explained in its test.
* ``kernels_from_summary`` and the record (``to_dict`` / ``from_dict``)
  equal the reference's on one summary dict; exact.
* The roofline on ``H100_SXM`` uses that chip's peak; the reference's
  ``roofline_fraction`` reads its TPU's whatever chip it was given.
* Fault 10: a ``Trainer`` run that counts its cost (on fake copies) leaves
  step 1's parameters and AdamW moments bit for bit those of a run that
  does not; its counted FLOPs against the old in-step count: equal but for
  the plain attention the old count saw on the CPU (stated below).
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import repro.launch.steps as ref_steps
from repro.configs import ShapeConfig as RefShape, get_smoke_config as ref_smoke
from repro.perf import hlo_cost_model as ref_cost_model
from repro.perf.hlo import HloCostSummary
from repro.perf.roofline import roofline_from_summary as ref_roofline
from repro.sim.hlo_costs import kernels_from_summary as ref_kernels_from_summary
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.perf import H100_PCIE, H100_SXM, StepCostSummary, chip_for, count_step, roofline_from_summary
from repro_torch.perf.cost import ByteCounter, count_cell, kernel_costs, plan_collectives
from repro_torch.sim import kernels_from_step, kernels_from_summary


@pytest.fixture
def one_rank():
    """A one-rank (data 1, model 1) mesh over torch's ``fake`` process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_tiny_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield make_tiny_mesh(data=1, model=1, device_type="cpu")
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- closed forms
@pytest.mark.parametrize("L,N", [(1, 16), (4, 32), (7, 24)])
def test_a_loop_of_matmuls_counts_its_closed_form(L, N):
    """A Python loop of L (N, N) matmuls counts L·2N³ FLOPs and, unfused,
    L·3N² fp32 elements moved: every trip is dispatched, so the count needs
    no trip multiplier (the reference's ``test_scan_equals_unrolled_equals_closed_form``)."""
    ws = [torch.randn(N, N) for _ in range(L)]

    def loop(x, ws):
        for w in ws:
            x = x @ w
        return x

    def unrolled(x, ws):
        return unrolled(x @ ws[0], ws[1:]) if ws else x

    got = count_step(loop, torch.randn(N, N), ws)
    assert got.flops_per_device == L * 2 * N ** 3 == count_step(unrolled, torch.randn(N, N), ws).flops_per_device
    assert got.hbm_bytes_per_device == L * 3 * N * N * 4
    assert got.argument_bytes == (L + 1) * N * N * 4 and got.output_bytes == N * N * 4


def test_batched_einsums_are_counted():
    B, M, K, N = 3, 8, 16, 4
    a, b = torch.randn(B, M, K), torch.randn(B, K, N)
    got = count_step(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b) + torch.einsum("bmk,bkn->bmn", a, b), a, b)
    assert got.flops_per_device == 2 * (2 * B * M * K * N)
    assert got.parts["flash_forward"] == got.parts["ssd_kernel"] == 0


def test_count_runs_on_fake_copies_and_splits_over_chips():
    """The counted function sees fake tensors: its in-place update reaches
    none of the real inputs; ``chips`` splits the totals evenly; a zero-dim
    CPU tensor is a constant the step can read."""
    w, step = torch.ones(4, 4), torch.tensor(3)

    def fn(w, step):
        w.mul_(float(step))
        return w @ w

    got = count_step(fn, w, step, chips=2)
    assert torch.equal(w, torch.ones(4, 4))
    assert got.flops_per_device == 2 * 4 ** 3 / 2 and got.chips == 2
    assert got.alias_bytes == 0


# --------------------------------------------------------------------------- against the reference's count
@pytest.mark.parametrize("kind,batch,attn_passes", [("prefill", 2, 1), ("train", 4, 3)])
def test_cell_count_matches_the_reference_loop_aware_count(one_rank, monkeypatch, kind, batch, attn_passes):
    """deepseek-7b's smoke cell (4 layers, d_model 128, 4 heads of 32, S = 64):
    the port's count equals the reference's ``analyze_compiled`` of its jitted
    cell in everything but attention, exactly (tolerance 0; the reference's
    attention dots are its only dots of rank 4 or more on the CPU).

    The attention gap, over 2 %: the reference's blocked attention
    (``_xla_flash``, ``repro/kernels/ops.py:38``) pads the 64 keys to its
    1,024-key block and computes every block in full, 2·B·H·S·1024·D a product
    (two forward; the train step's backward four more, so three passes of two),
    where the port counts the function's causal FLOPs by formula
    (``flash_flops``: half the square; the backward 2.5× the forward)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref_cfg = ref_smoke("deepseek-7b")
    ref = ref_steps.build_cell("deepseek-7b", ref_cfg, RefShape("smoke", 64, batch, kind), mesh)
    with mesh:
        text = jax.jit(ref.fn, donate_argnums=ref.donate_argnums).lower(*ref.args).compile().as_text()
    ref_all = ref_cost_model.analyze_hlo_text(text).flops
    dot = ref_cost_model._dot_flops
    monkeypatch.setattr(ref_cost_model, "_dot_flops",
                        lambda op, sizes: 0.0 if len(ref_cost_model._shape_dims(op.ret)[0][1]) >= 4 else dot(op, sizes))
    ref_rest = ref_cost_model.analyze_hlo_text(text).flops
    monkeypatch.undo()

    from repro_torch.launch.steps import build_cell

    cfg = get_smoke_config("deepseek-7b")
    got = count_cell(build_cell("deepseek-7b", cfg, ShapeConfig("smoke", 64, batch, kind), one_rank), device="cpu")
    assert got.parts["counted"] == ref_rest
    L, H, D, S = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim, 64
    assert ref_all - ref_rest == attn_passes * L * 2 * (2 * batch * H * S * 1024 * D)
    per_layer = fa.flash_flops(batch, S, S, H, D, causal=True)
    assert got.parts["flash_forward"] == L * per_layer
    assert got.parts["flash_backward"] == (L * 2.5 * per_layer if kind == "train" else 0)
    assert got.flops_per_device == got.parts["counted"] + got.parts["flash_forward"] + got.parts["flash_backward"]


# --------------------------------------------------------------------------- the record, the simulator's kernels
SUMMARY = {"flops_per_device": 1.0360e14, "hbm_bytes_per_device": 3.67e11, "collective_wire_bytes_per_device": 4.5e9,
           "collective_breakdown": {"all-gather": 4.5e9}, "collective_count": 1, "output_bytes": 4.03e9,
           "argument_bytes": 1.38e10, "temp_bytes": 0.0, "generated_code_bytes": 0.0, "peak_hbm_bytes": 0.0}


def test_summary_record_is_the_references():
    ours, theirs = StepCostSummary.from_dict(SUMMARY), HloCostSummary.from_dict(SUMMARY)
    assert ours.to_dict() == theirs.to_dict() == SUMMARY
    assert sorted(StepCostSummary(1.0, 2.0, 3.0).to_dict()) == sorted(HloCostSummary(1.0, 2.0, 3.0).to_dict())
    assert StepCostSummary(1.0, 2.0, 3.0).temp_bytes is None  # not counted, not 0


@pytest.mark.parametrize("n_kernels", [1, 8])
def test_kernels_from_summary_equal_the_references(n_kernels):
    ours = kernels_from_summary(StepCostSummary.from_dict(SUMMARY), "deepseek7b_prefill", n_kernels)
    theirs = ref_kernels_from_summary(HloCostSummary.from_dict(SUMMARY), "deepseek7b_prefill", n_kernels)
    fields = ("name", "flops", "hbm_rd_bytes", "hbm_wr_bytes", "ici_bytes", "addr_base")
    assert [tuple(getattr(k, f) for f in fields) for k in ours] == [tuple(getattr(k, f) for f in fields)
                                                                    for k in theirs]


def test_kernels_from_step_counts_the_step():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    ks = kernels_from_step(lambda a, b: a @ b, a, b, name="mm", n_kernels=2)
    assert [k.name for k in ks] == ["mm_0", "mm_1"] and sum(k.flops for k in ks) == 2 * 64 * 32 * 16
    assert sum(k.hbm_wr_bytes for k in ks) == 64 * 16 * 4


# --------------------------------------------------------------------------- hardware and roofline
def test_h100_constants_and_chip_for():
    assert (H100_SXM.peak_bf16_flops, H100_SXM.peak_fp32_flops, H100_SXM.hbm_bw) == (989e12, 67e12, 3.35e12)
    assert (H100_PCIE.peak_bf16_flops, H100_PCIE.peak_fp32_flops, H100_PCIE.hbm_bw) == (756e12, 51e12, 2.0e12)
    assert H100_SXM.hbm_bytes == H100_PCIE.hbm_bytes == 80 * 10 ** 9 and H100_SXM.ici_link_bw == 50e9
    assert chip_for("NVIDIA H100 80GB HBM3, 700.00 W") is H100_SXM
    assert chip_for("NVIDIA H100 PCIe, 350.00 W") is H100_PCIE


def test_roofline_uses_the_peak_of_its_chip():
    """The port's ``roofline_fraction`` divides by the peak of the chip the
    terms were built with; the reference's reads its TPU's peak whatever
    chip it was given (a stated difference)."""
    kw = dict(arch="deepseek-7b", shape="prefill_2k", mesh="1x1", chips=1, model_flops_total=1.132e14)
    ours = roofline_from_summary(StepCostSummary.from_dict(SUMMARY), **kw)
    assert ours.chip is H100_SXM and ours.compute_s == SUMMARY["flops_per_device"] / 989e12
    assert ours.memory_s == SUMMARY["hbm_bytes_per_device"] / 3.35e12 and ours.dominant == "memory"
    assert ours.roofline_fraction == pytest.approx((1.132e14 / 989e12) / ours.memory_s, rel=1e-12)
    pcie = roofline_from_summary(StepCostSummary.from_dict(SUMMARY), chip=H100_PCIE, **kw)
    assert pcie.roofline_fraction == pytest.approx((1.132e14 / 756e12) / pcie.bound_s, rel=1e-12)
    theirs = ref_roofline(HloCostSummary.from_dict(SUMMARY), chip=H100_SXM, **kw)
    assert (theirs.compute_s, theirs.memory_s, theirs.useful_flops_ratio) == (
        ours.compute_s, ours.memory_s, ours.useful_flops_ratio)
    assert theirs.roofline_fraction == pytest.approx(ours.roofline_fraction * 989 / 197, rel=1e-12)


def test_plan_collectives_gather_what_fsdp_shards():
    """On (data 2, model 2) every parameter the plan shards over "data" is
    gathered once a step, half of it crossing the wire (g = 2); a train step
    also reduce-scatters the same volume; decode gathers and scatters
    nothing else."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_tiny_mesh
    from repro_torch.launch.steps import build_cell

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_tiny_mesh(device_type="cpu")
        cfg = get_smoke_config("deepseek-7b")
        train = build_cell("deepseek-7b", cfg, ShapeConfig("t", 64, 4, "train"), mesh)
        decode = build_cell("deepseek-7b", cfg, ShapeConfig("d", 64, 4, "decode"), mesh)
    finally:
        dist.destroy_process_group()
    from repro_torch.models.params import iter_leaves

    specs = dict(iter_leaves(train.plan.param_specs))
    params = dict(iter_leaves(train.args[0]))
    sharded = sum(params[n].nbytes for n, s in specs.items() if any(
        e == "data" or (isinstance(e, tuple) and "data" in e) for e in s))
    assert sharded > 0
    got = plan_collectives(train.args[0], train.in_shardings[0], train.plan.mesh, train.plan.dp, train=True)
    assert got == {"all-gather": sharded / 2, "reduce-scatter": sharded / 2}
    got = plan_collectives(decode.args[0], decode.in_shardings[0], decode.plan.mesh, decode.plan.dp, train=False)
    assert got == {"all-gather": sharded / 2}


def test_kernel_costs_price_each_launch():
    rec = fa.FlashLaunch(2, 64, 64, 4, 4, 32, 32, True, 0, 4)
    from repro_torch.kernels.ssd_scan import SSDLaunch, ssd_bytes, ssd_flops

    ssd = SSDLaunch(2, 64, 4, 16, 8, 1, 4)
    got = kernel_costs({"flash_forward": {rec: 3}, "flash_backward": {rec: 1}, "ssd_kernel": {ssd: 2}})
    assert got["flash_forward"] == 3 * fa.flash_flops(2, 64, 64, 4, 32, causal=True)
    assert got["flash_backward"] == fa.flash_flops(2, 64, 64, 4, 32, causal=True, backward=True)
    assert got["ssd_kernel"] == 2 * ssd_flops(2, 64, 4, 16, 8, 1)
    assert got["bytes_ssd_kernel"] == 2 * ssd_bytes(2, 64, 4, 16, 8, 1, 4)


# --------------------------------------------------------------------------- fault 10: the counted step
def _trainer_run(arch, counted: bool, steps: int = 1):
    from repro_torch.core import StepCost
    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke_config(arch)
    it = make_train_iter(DataConfig(global_batch=4, seq_len=32, vocab_size=cfg.vocab_size))
    tr = Trainer(cfg, TrainConfig(microbatches=2), it, device="cpu")
    if not counted:
        tr.step_cost = StepCost(flops=0.0, hbm_bytes=0.0)  # a cost already known: nothing is counted
    model, opt = tr.restore_or_init()
    model, opt, _ = tr.run(model, opt, steps)
    it.close()
    return tr, model, opt


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-130m", "deepseek-v2-lite-16b"])
def test_the_counted_first_step_is_the_uncounted_step(arch):
    """Fault 10: the trainer counts its cost on fake copies, so step 1 (and
    the next) of a counting run are bit for bit a run's that counts
    nothing."""
    tr, m1, o1 = _trainer_run(arch, counted=True, steps=2)
    _, m2, o2 = _trainer_run(arch, counted=False, steps=2)
    assert tr.step_cost.flops > 0 and tr.step_cost.hbm_bytes > 0
    p1, p2 = dict(m1.named_parameters()), dict(m2.named_parameters())
    assert [n for n in p1 if not torch.equal(p1[n], p2[n])] == []
    for key in ("m", "v"):
        assert [n for n in o1[key] if not torch.equal(o1[key][n], o2[key][n])] == []


def test_the_count_against_the_old_in_step_count():
    """The old count ran the real first step under ``FlopCounterMode`` and
    the dispatch byte counter.  On the CPU that step took the plain
    attention (``attention_ref``: the full S×S square in fp32, its gradient
    by autograd: six batched products of 2·B·H·S²·D a layer and microbatch);
    the count on fake tensors takes the kernels' path, priced by formula.
    Everything else is counted the same, exactly: the old FLOPs are the new
    count's own plus the plain attention's, less the kernels' formula."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.train import TrainConfig, Trainer, functional_train_step
    from repro_torch.models import param_tree

    arch = "deepseek-7b"
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(microbatches=2)
    it = make_train_iter(DataConfig(global_batch=4, seq_len=32, vocab_size=cfg.vocab_size))
    batch = next(it)
    it.close()
    tr = Trainer(cfg, tcfg, iter(()), device="cpu")
    model, opt = tr.restore_or_init()
    new = count_step(functional_train_step(cfg, tcfg), param_tree(model), opt, batch)
    with FlopCounterMode(display=False) as flops, ByteCounter() as moved:  # the old in-step count
        functional_train_step(cfg, tcfg)(param_tree(model), opt, batch)
    B, S, L, H, D = 2, 32, cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    plain_attention = tcfg.microbatches * L * 6 * (2 * B * H * S * S * D)
    assert flops.get_total_flops() == new.parts["counted"] + plain_attention
    assert new.parts["flash_forward"] == tcfg.microbatches * L * fa.flash_flops(B, S, S, H, D, causal=True)
    # bytes: the plain attention's fp32 scores and their gradients are gone from the count, the formula's
    # q, k, v, out (and the backward's) come in
    assert new.parts["bytes_counted"] < moved.bytes
    assert new.parts["bytes_flash_forward"] == tcfg.microbatches * L * fa.flash_bytes(B, S, S, H, H, D, 4)
