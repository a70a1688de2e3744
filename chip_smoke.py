#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources (one ``nvcc`` per
source, all started together) and drives the port's three paths:

* serving: the flash-attention kernel held against its plain version and
  timed; the deepseek-7b smoke config served on the card and on the CPU and
  compared; deepseek-7b at full width (30 layers, d_model 4096, bf16, random
  weights from a seed) served through the continuous-batching engine, with
  the per-stream lanes checked and every prefill through the flash kernel;
* training: the SSD-scan kernel held against the sequential plain scan and
  timed; the mamba2 smoke config trained, prefilled and decoded on the card
  and on the CPU and compared; mamba2-130m at its published shape (24
  layers, d_model 768, bf16 compute, fp32 parameters) trained for a few tens
  of steps with an eval lane, with the loss, the per-stream lanes and the
  exact number of SSD launches checked, the kernel held against the plain
  version on every layer's real inputs, one step at seq 4096, and decode
  against forward in fp32;
* the simulator: the segment-scatter kernel (the batched sweep's stat
  landing), its accumulate entry and the sequential-fold kernel held bit for
  bit against their plain versions, on test shapes and on the sweep's real
  landing inputs, and the segment kernel timed beside ``index_add_``; then
  the full scenario registry at 64 divergent draws each (1,088 jobs) run
  through ``BatchRunner(backend="batched")`` on ``array_backend="torch"``,
  with its signature held against the same jobs on NumPy, zero failed jobs
  and oracle failures, every kernel's launches equal to the calls that
  handed it work, the landing traced for the device's idle share, and a
  compiled-engine sweep whose running sums fold on the card.

Each phase prints one JSON line; then a ``{"kernels": [...]}`` line, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before that line; without a GPU it fails at
once.  The compiler's full report is written beside the built libraries,
``build/repro_torch/build.log``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: tests/test_kernels.py's shape set (B, S, Hq, Hkv, D): MHA, GQA, MQA ragged, S < block
KERNEL_SHAPES = [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 192, 6, 1, 64), (2, 64, 2, 2, 128)]
#: the main path's prefill attention: deepseek-7b, one prompt, 32 heads of 128
MAIN_SEQS = (1, 17, 128, 500, 1024)
TIMED_SEQS = (512, 1024)
FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=1e-2)  # as tests/test_kernels.py: bf16 keeps 8 significant bits
#: smoke parity, card against CPU, both fp32 with TF32 off: the two differ
#: only by summation order (cuBLAS and the kernel against the CPU's BLAS and
#: the plain attention), ~1e-6 relative on logits of magnitude ~4
SMOKE_LOGITS_ATOL = 1e-4
#: Full width, bf16: the kernel is held against the plain version on the
#: q/k/v that every layer hands to ops.flash_attention while one real prompt
#: is prefilled, at BF16_TOL.  The logits are not a bf16 check: the
#: reference's init (layer weights at std n_layers^-0.5) makes attention
#: scores ~100 wide and softmax near one-hot, so one bf16 rounding that
#: flips a near-tied key in one layer moves the last logits far after 30
#: layers.  In fp32 (the same weights, converted exactly) the two paths'
#: last-position logits must agree to FULL_FP32_REL, relative L2.
FULL_FP32_REL = 1e-2
#: timing: each reading is the mean of LAUNCHES back-to-back calls, replayed
#: from one CUDA graph between a pair of CUDA events; ROUNDS readings per
#: function, the functions alternating within each round
LAUNCHES, ROUNDS = 50, 9

#: SSD kernel checks against the sequential plain scan: tests/test_kernels.py's
#: SSD shapes (B, S, H, P, N, G), grouped B/C among them, plus a P that is not
#: a multiple of the kernel's 32-row state slice and an S that is not a
#: multiple of its 64-row tile
SSD_SHAPES = [(1, 64, 2, 16, 8, 1), (2, 128, 4, 8, 16, 2), (2, 96, 6, 8, 16, 3), (1, 100, 2, 48, 8, 1)]
SSD_FP32_TOL = dict(atol=5e-5, rtol=1e-3)  # tests/test_kernels.py's SSD tolerance
SSD_BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # tests/test_kernels.py's bf16 SSD tolerance
#: mamba2-130m's SSD shape (H, P, N, G); bf16 checks at these lengths
SSD_WIDTH = (24, 64, 128, 1)
SSD_SEQS = (1, 37, 256, 1000)
#: timed: the training microbatch (B=4, S=256) and the train_4k length (B=1, 16 chunks of 256)
SSD_TIMED = ((4, 256), (1, 4096))
#: The final state's relative L2 error, kernel against the sequential plain
#: scan, on each layer's real inputs: both compute in fp32 from the same
#: bf16 inputs, so they differ by summation order; relative, because
#: exp(cum) can underflow over a chunk and shrink the state.
SSD_H_REL = 1e-3
#: smoke parity, card against CPU, fp32 with TF32 off.  Losses differ by
#: summation order (the kernel's 64-row tiles against 32-row chunks on the
#: CPU), ~1e-6 relative.  Grad norms: the CPU tests measured 4.9e-5 at the
#: first step and 2.0e-3 by the third between two fp32 implementations
#: (tests/test_torch_train.py), because AdamW's normalisation turns fp32
#: noise on near-zero gradients into whole steps.  Greedy decode logits
#: within 1e-4 on logits of magnitude ~1.
SSM_LOSS_RTOL, SSM_GNORM_RTOL, SSM_LOGITS_ATOL = 1e-4, 1e-2, 1e-4
#: full-width training: examples/train_100m.py's settings (batch 8 x 256, 2
#: microbatches, AdamW, warm-up 20 steps, cosine over its default 300 steps),
#: the first TRAIN_STEPS steps of that run.  At the reference's init the loss
#: sits at ~ln(vocab) for ~40 steps before it falls, so fewer steps show no fall.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, EVAL_EVERY, SCHEDULE_STEPS = 60, 8, 256, 2, 10, 300
#: the loss on one fixed held-out batch must fall by at least this much over the run
EVAL_DROP = 0.05
#: decode after prefill against forward on the extended sequence, fp32,
#: relative L2 of each step's logits: the same weights and math, the SSD
#: state handed from the kernel to the exact recurrence
DECODE_FP32_REL = 1e-3
#: the simulator's batched sweep: the full scenario registry at SIM_DRAWS
#: divergent draws a scenario (1,088 jobs), event engine, as a validation
#: sweep of the per-kernel, per-stream counts runs it; the segment kernel is
#: also timed on the SIM_SMALL_DRAWS sweep's landing; the compiled engine
#: runs SIM_COMPILED_DRAWS draws, whose trace workloads fold bandwidth
#: pointers through running_sum.  Everything here is compared bit for bit.
SIM_DRAWS, SIM_SMALL_DRAWS, SIM_COMPILED_DRAWS, SIM_SEED = 64, 2, 2, 0
#: segment-kernel checks (events, n_segs, row_size): tests/test_batched.py's
#: shapes, with events on two rows past the table that must drop
SEG_SHAPES = [(2000, 1, 8), (2000, 5, 64), (2000, 16, 300)]
#: host-clock readings of the landing op with its copies (median taken)
HOST_ROUNDS = 3


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks(smi_name: str):
    """Datasheet peaks (bf16 dense FLOP/s, HBM bytes/s) of the card nvidia-smi names."""
    if "PCIe" in smi_name:
        return 756e12, 2.0e12, "H100 PCIe datasheet"
    return 989e12, 3.35e12, "H100 SXM datasheet"


def time_interleaved(fns, warmup: int = 3, eager=()):
    """Device ms per call of each function in ``fns`` (name → callable).

    Each function's ``LAUNCHES`` back-to-back calls are captured once into
    a CUDA graph; a reading is one replay between a pair of CUDA events,
    divided by ``LAUNCHES``, so it holds device time without the host's
    per-call cost (an SDPA call costs the host about as long as the card).
    A function named in ``eager`` cannot be captured (its output shape
    depends on the data, which needs a sync): a reading of it is its
    ``LAUNCHES`` calls run back to back between the two events, so it also
    holds whatever host time the card waits for.  Each round takes one
    reading of every function in turn; returns per name the median, min and
    max of ``ROUNDS`` readings."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as graph capture wants
        for fn in fns.values():
            for _ in range(warmup):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = {}
    for name, fn in fns.items():
        if name in eager:
            continue
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(LAUNCHES):
                fn()
    torch.cuda.synchronize()

    def run_eager(fn):
        for _ in range(LAUNCHES):
            fn()

    readings = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay() if name in graphs else run_eager(fn)
            end.record()
            end.synchronize()
            readings[name].append(start.elapsed_time(end) / LAUNCHES)
    return {name: {"median": statistics.median(r), "min": min(r), "max": max(r)}
            for name, r in readings.items()}


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


def phase_device():
    if not torch.cuda.is_available():
        raise CheckFailed("no CUDA device: the port's entry points and kernels need an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
    })
    return smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    info = build.build()
    wall = time.perf_counter() - t0
    (build.BUILD_DIR / "build.log").write_text(
        "\n".join(f"== {name}\n{i['log']}" for name, i in info.items())
    )
    ptxas = {
        name: [ln.strip() for ln in str(i["log"]).splitlines() if "registers" in ln or "spill" in ln]
        for name, i in info.items()
    }
    emit({"phase": "build", "seconds": round(wall, 3),
          "per_kernel_s": {n: round(float(i["seconds"]), 3) for n, i in info.items()},
          "ptxas": ptxas})


def phase_kernel(smi: str):
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa

    fp32_err = 0.0
    for i, (B, S, Hq, Hkv, D) in enumerate(KERNEL_SHAPES):
        q, k, v = (randn(s, torch.float32, 10 * i + j) for j, s in
                   enumerate(((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))))
        for causal in (True, False):
            out = ops.flash_attention(q, k, v, causal=causal)
            want = ops.flash_attention(q, k, v, causal=causal, impl="plain")
            torch.cuda.synchronize()
            fp32_err = max(fp32_err, (out - want).abs().max().item())
            check(torch.allclose(out, want, **FP32_TOL),
                  f"fp32 kernel disagrees with plain at {(B, S, Hq, Hkv, D)} causal={causal}")
    empty_k = torch.empty((1, 0, 2, 32), device="cuda")
    edge = ops.flash_attention(randn((1, 5, 2, 32), torch.float32, 99), empty_k, empty_k, causal=False)
    check(torch.count_nonzero(edge).item() == 0, "rows that see no key must give 0")

    bf16_err = 0.0
    for S in MAIN_SEQS:
        q, k, v = (randn((1, S, 32, 128), torch.bfloat16, 100 + S + j) for j in range(3))
        out = ops.flash_attention(q, k, v, causal=True)
        want = ops.flash_attention(q, k, v, causal=True, impl="plain")
        torch.cuda.synchronize()
        bf16_err = max(bf16_err, (out.float() - want.float()).abs().max().item())
        check(torch.allclose(out.float(), want.float(), **BF16_TOL),
              f"bf16 kernel disagrees with plain at S={S}")

    peak_flops, peak_bw, peak_src = peaks(smi)
    timings = {}
    for S in TIMED_SEQS:
        B, H, D = 1, 32, 128
        q, k, v = (randn((B, S, H, D), torch.bfloat16, 200 + S + j) for j in range(3))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = time_interleaved({
            "kernel": lambda: ops.flash_attention(q, k, v, causal=True),
            "plain": lambda: ops.flash_attention(q, k, v, causal=True, impl="plain"),
            "library": lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
        })
        flops = 2 * B * H * S * S * D
        nbytes = 2 * (2 * B * H * S * D + 2 * B * H * S * D)
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        timings[S] = {
            "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"],
            "library_ms": ms["library"]["median"],
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "kernel_tflops": flops / (ms["kernel"]["median"] * 1e-3) / 1e12,
            "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()},
        }
    emit({"phase": "kernel", "name": "flash_attention", "fp32_max_abs_err": fp32_err,
          "bf16_max_abs_err": bf16_err, "tolerances": {"fp32": FP32_TOL, "bf16": BF16_TOL},
          "peaks": {"bf16_flops": peak_flops, "hbm_bytes_s": peak_bw, "source": peak_src},
          "timing": {str(S): t for S, t in timings.items()},
          "timing_note": f"median of {ROUNDS} readings, each the mean of {LAUNCHES} back-to-back "
                         "calls replayed from one CUDA graph between CUDA events; kernel, plain and "
                         "SDPA alternate; inputs warm in L2"})
    fa.flash_attention.launches = 0  # comparisons and timings are not the main path's launches
    return bf16_err, timings


def _replay(model, scfg, spec, vocab):
    from repro_torch.serve import Engine, generate_load, replay_load

    eng = Engine(model, scfg)
    load = generate_load(spec, vocab)
    rep = replay_load(eng, load)
    return eng, [r for _, r in load], rep


def _lanes(eng, reqs):
    frame = eng.frame
    return {
        r.name: (int(frame.filter(stream=r.stream_id, access_type="SLO", outcome="TOKENS_OUT").sum()),
                 int(frame.filter(stream=r.stream_id, access_type="KV_ACC_W").sum()))
        for r in reqs
    }


def phase_parity():
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Transformer
    from repro_torch.serve import LoadSpec, ServeConfig, TenantSpec

    cfg = get_smoke_config("deepseek-7b")
    cpu_model = Transformer(cfg, device="cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    spec = LoadSpec(tenants=(TenantSpec("solo", rate=0.6, prompt_len=(8, 48), max_new_tokens=(4, 12)),),
                    steps=12, seed=11)
    scfg = ServeConfig(n_slots=4, max_len=128, batch_buckets=(1, 2))
    before = fa.flash_attention.launches
    cpu_eng, cpu_reqs, _ = _replay(cpu_model, scfg, spec, cfg.vocab_size)
    gpu_eng, gpu_reqs, _ = _replay(gpu_model, scfg, spec, cfg.vocab_size)
    gpu_launches = fa.flash_attention.launches - before
    check(gpu_launches == cfg.n_layers * len(gpu_reqs), "every card prefill runs the kernel once per layer")
    check([r.status for r in gpu_reqs] == [r.status for r in cpu_reqs], "request statuses differ")
    check([r.generated for r in gpu_reqs] == [r.generated for r in cpu_reqs],
          "greedy tokens differ between card and CPU")
    check(_lanes(gpu_eng, gpu_reqs) == _lanes(cpu_eng, cpu_reqs), "per-stream TOKENS_OUT/KV_ACC_W differ")
    check(gpu_eng.fault_summary() == cpu_eng.fault_summary(), "fault_summary differs")
    tokens = torch.as_tensor(cpu_reqs[0].prompt, dtype=torch.long)[None]
    cpu_logits, _ = cpu_model.prefill(tokens)
    gpu_logits, _ = gpu_model.prefill(tokens.cuda())
    err = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    check(err <= SMOKE_LOGITS_ATOL, f"smoke logits card vs CPU differ by {err}")
    fa.flash_attention.launches = before
    emit({"phase": "parity", "config": "deepseek-7b SMOKE", "requests": len(gpu_reqs),
          "tokens_out": sum(len(r.generated) for r in gpu_reqs),
          "statuses": {s: sum(r.status == s for r in gpu_reqs) for s in {r.status for r in gpu_reqs}},
          "lanes_equal": True, "fault_summary": gpu_eng.fault_summary(),
          "logits_max_abs_err": err, "logits_atol": SMOKE_LOGITS_ATOL,
          "card_kernel_launches": gpu_launches})


def phase_full_width():
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer
    from repro_torch.serve import Engine, LoadSpec, ServeConfig, TenantSpec, generate_load, replay_load

    cfg = get_config("deepseek-7b")
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    eng = Engine(model, ServeConfig(n_slots=4, max_len=1024, batch_buckets=(1, 2)))
    spec = LoadSpec(
        tenants=(TenantSpec("interactive", rate=0.5, prompt_len=(128, 512), max_new_tokens=(16, 32), priority=1),
                 TenantSpec("batch", rate=0.4, prompt_len=(128, 512), max_new_tokens=(16, 32))),
        steps=12, seed=1,
    )
    load = generate_load(spec, cfg.vocab_size)
    check(8 <= len(load) <= 12, f"trace has {len(load)} requests, want 8-12")

    # warm-up outside the measured run: cuBLAS handles, allocator, the kernel library
    warm = torch.randint(0, cfg.vocab_size, (1, 64), device="cuda")
    model.prefill(warm)
    scratch = model.init_cache(1, 80)
    model.decode_step(scratch, warm[:, 0], torch.zeros(1, dtype=torch.long, device="cuda"))
    del scratch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.flash_attention.launches = 0
    rep = replay_load(eng, load)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches

    reqs = [r for _, r in load]
    check(all(r.status == "done" for r in reqs), f"statuses {[r.status for r in reqs]}")
    kvb = eng._kv_bytes_per_token
    check(kvb == 2 * cfg.n_kv_heads * cfg.resolved_head_dim * cfg.n_layers * 2, "kv bytes per token")
    lanes = _lanes(eng, reqs)
    for r in reqs:
        tok_out, kv = lanes[r.name]
        check(tok_out == len(r.generated), f"{r.name}: TOKENS_OUT {tok_out} != {len(r.generated)}")
        want_kv = (len(r.prompt) + len(r.generated) - 1) * kvb
        check(kv == want_kv, f"{r.name}: KV_ACC_W {kv} != {want_kv}")
        check(len(r.generated) == r.max_new_tokens, f"{r.name}: {len(r.generated)} tokens")
    check(launches == cfg.n_layers * len(reqs), f"flash launches {launches} != 30 x {len(reqs)} prefills")

    prompt_tokens = sum(len(r.prompt) for r in reqs)
    prefill_s = sum(r.prefill_s for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    decode_s = sum(r.decode_s for r in reqs)
    ttft_ms = sorted(r.ttft_s * 1e3 for r in reqs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one real prompt: keep the q/k/v every layer hands to the attention op,
    # then hold the kernel against the plain version on each layer's inputs
    probe = torch.as_tensor(reqs[0].prompt, dtype=torch.long, device="cuda")[None]
    V = cfg.vocab_size
    flash, captured = ops.flash_attention, []

    def capture(q, k, v, **kw):
        captured.append((q, k, v, kw))
        return flash(q, k, v, **kw)

    ops.flash_attention = capture
    try:
        k_logits = model.prefill(probe)[0][..., :V]
    finally:
        ops.flash_attention = flash
    check(len(captured) == cfg.n_layers, f"{len(captured)} attention calls in one prefill")
    op_err, op_scale = 0.0, 0.0
    for layer, (q, k, v, kw) in enumerate(captured):
        out = flash(q, k, v, **kw).float()
        want = flash(q, k, v, **{**kw, "impl": "plain"}).float()
        op_err = max(op_err, (out - want).abs().max().item())
        op_scale = max(op_scale, want.abs().max().item())
        check(torch.allclose(out, want, **BF16_TOL),
              f"bf16 kernel disagrees with plain on layer {layer}'s prefill attention inputs")
    del captured, out, want
    p_logits = model.prefill(probe, attn_impl="plain")[0][..., :V]
    check(bool(torch.isfinite(k_logits).all()), "non-finite logits")
    del eng
    model.to(torch.float32)  # the same weights, exactly, as the fp32 model both bf16 paths round
    model.cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    f_kernel = model.prefill(probe)[0][..., :V]
    f_plain = model.prefill(probe, attn_impl="plain")[0][..., :V]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    logits = {
        "bf16_kernel_vs_plain": rel(k_logits, p_logits),
        "bf16_plain_vs_fp32": rel(p_logits, f_plain),
        "bf16_kernel_vs_fp32": rel(k_logits, f_plain),
        "fp32_kernel_vs_plain": rel(f_kernel, f_plain),
        "bf16_kernel_vs_plain_max_abs": (k_logits - p_logits).abs().max().item(),
        "scale_max_abs": p_logits.abs().max().item(),
        "argmax_equal_bf16": bool(k_logits.argmax() == p_logits.argmax()),
        "argmax_equal_fp32": bool(f_kernel.argmax() == f_plain.argmax()),
    }
    check(logits["fp32_kernel_vs_plain"] <= FULL_FP32_REL, f"fp32 logits kernel vs plain: {logits}")
    emit({
        "phase": "full_width", "config": "deepseek-7b", "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.param_dtype,
        "params": n_params, "init_s": init_s, "requests": len(reqs), "engine_steps": rep.steps,
        "statuses": {s: sum(r.status == s for r in reqs) for s in {r.status for r in reqs}},
        "flash_launches": launches, "prefills": len(reqs),
        "prompt_tokens": prompt_tokens, "prefill_tok_s": prompt_tokens / prefill_s,
        "decode_tokens": decode_tokens, "decode_tok_s": decode_tokens / decode_s,
        "ttft_p50_ms": statistics.median(ttft_ms), "ttft_max_ms": ttft_ms[-1],
        "wall_s": rep.wall_s, "goodput_tok_s": rep.total_goodput_tok_s,
        "per_tenant_ttft_p50_us": {t: row["ttft_us"]["p50"] for t, row in rep.per_tenant.items()},
        "max_memory_allocated_gb": peak_gb,
        "attention_op_bf16": {"layers": cfg.n_layers, "prompt_len": probe.shape[1],
                              "max_abs_err": op_err, "max_abs_out": op_scale, "tolerance": BF16_TOL},
        "logits_rel_l2": logits, "logits_tolerance": {"fp32_kernel_vs_plain": FULL_FP32_REL},
    })
    return launches, op_err


def _ssd_inputs(B, S, H, P, N, G, dtype, seed, h0=False):
    """Seeded SSD inputs on the card: x, B, C in ``dtype``; dt, A, D, h0 fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    x = rn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H) - 1.0)
    A = -torch.exp(rn(H) * 0.5)
    Bm, Cm = (rn(B, S, G, N) * 0.3).to(dtype), (rn(B, S, G, N) * 0.3).to(dtype)
    D = rn(H) * 0.2
    return x, dt, A, Bm, Cm, D, (rn(B, H, P, N) * 0.1 if h0 else None)


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


def phase_ssd_kernel(smi: str):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import ssd_ref

    fp32_err = 0.0
    for i, shape in enumerate(SSD_SHAPES):
        for with_h0 in (False, True):
            x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(*shape, torch.float32, 300 + i, with_h0)
            y, h = sk.ssd_scan(x, dt, A, Bm, Cm, D, h0, chunk=32)
            want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h0, return_state=True)
            torch.cuda.synchronize()
            fp32_err = max(fp32_err, (y - want_y).abs().max().item(), (h - want_h).abs().max().item())
            check(torch.allclose(y, want_y, **SSD_FP32_TOL) and torch.allclose(h, want_h, **SSD_FP32_TOL),
                  f"fp32 SSD kernel disagrees with ssd_ref at {shape} h0={with_h0}")
    H, P, N, G = SSD_WIDTH
    bf16_err, h_rel = 0.0, 0.0
    for S in SSD_SEQS:
        x, dt, A, Bm, Cm, D, _ = _ssd_inputs(1, S, H, P, N, G, torch.bfloat16, 400 + S)
        y, h = sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256)
        want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, return_state=True)
        torch.cuda.synchronize()
        bf16_err = max(bf16_err, (y.float() - want_y.float()).abs().max().item())
        h_rel = max(h_rel, _rel(h, want_h))
        check(y.dtype == torch.bfloat16 and h.dtype == torch.float32, "SSD output dtypes")
        check(torch.allclose(y.float(), want_y.float(), **SSD_BF16_TOL), f"bf16 SSD kernel disagrees on y at S={S}")
        check(torch.allclose(h, want_h, **SSD_BF16_TOL), f"bf16 SSD kernel disagrees on h_final at S={S}")

    peak_flops, peak_bw, peak_src = peaks(smi)
    timings = {}
    for B, S in SSD_TIMED:
        x, dt, A, Bm, Cm, D, _ = _ssd_inputs(B, S, H, P, N, G, torch.bfloat16, 500 + S)
        ms = time_interleaved({
            "kernel": lambda: sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256),
            "plain": lambda: ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, impl="plain"),
        })
        flops = sk.ssd_flops(B, S, H, P, N)
        # each input read once, each output written once: x, y (bf16), dt (fp32),
        # B and C once per group (bf16), A and D (fp32), h_final (fp32); no h0
        nbytes = 2 * 2 * B * S * H * P + 4 * B * S * H + 2 * 2 * B * S * G * N + 2 * 4 * H + 4 * B * H * P * N
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        timings[f"B{B}_S{S}"] = {
            "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"], "library_ms": None,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()},
        }
    emit({"phase": "ssd_kernel", "name": "ssd_scan", "fp32_max_abs_err": fp32_err, "bf16_max_abs_err": bf16_err,
          "bf16_h_final_rel_l2": h_rel, "tolerances": {"fp32": SSD_FP32_TOL, "bf16": SSD_BF16_TOL},
          "bound": "FLOPs 2L^2N + 2L^2P + 4LNP per (batch, head, 64-row tile), the causal half counted "
                   "(the kernel computes it); bytes as listed, at the bf16 dense peak and HBM rate",
          "timing": timings,
          "timing_note": f"median of {ROUNDS} readings, each the mean of {LAUNCHES} back-to-back calls "
                         "replayed from one CUDA graph between CUDA events; kernel and plain alternate; "
                         "inputs warm in L2; no single PyTorch call computes the SSD scan (library: none)"})
    return max(bf16_err, fp32_err), timings


def phase_ssm_parity():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.optim import ScheduleConfig, adamw_init
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = get_smoke_config("mamba2-130m")
    check(cfg.compute_dtype == "float32" and cfg.remat == "full", "mamba2 smoke is fp32 with full remat")
    tcfg = TrainConfig(schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10), microbatches=2)
    cpu_model, cpu_opt = init_train_state(cfg, tcfg, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gpu_opt = adamw_init(dict(gpu_model.named_parameters()))

    # greedy prefill + decode from the same weights
    prompt = torch.as_tensor(np.random.default_rng(21).integers(0, cfg.vocab_size, (2, 40)), dtype=torch.long)
    c_logits, c_cache = cpu_model.prefill(prompt)
    before = sk.ssd_scan.launches
    g_logits, g_cache = gpu_model.prefill(prompt.cuda())
    check(sk.ssd_scan.launches - before == cfg.n_layers, "every card prefill layer runs the SSD kernel once")
    logits_err, tokens = (g_logits.cpu() - c_logits).abs().max().item(), []
    pos = torch.full((2,), prompt.shape[1], dtype=torch.long)
    for _ in range(12):
        tok = c_logits.argmax(-1)
        check(torch.equal(g_logits.argmax(-1).cpu(), tok), "greedy tokens differ between card and CPU")
        tokens.append(tok.tolist())
        c_logits, c_cache = cpu_model.decode_step(c_cache, tok, pos)
        g_logits, g_cache = gpu_model.decode_step(g_cache, tok.cuda(), pos.cuda())
        logits_err = max(logits_err, (g_logits.cpu() - c_logits).abs().max().item())
        pos = pos + 1
    check(logits_err <= SSM_LOGITS_ATOL, f"smoke prefill/decode logits card vs CPU differ by {logits_err}")

    it = make_train_iter(DataConfig(global_batch=4, seq_len=64, vocab_size=cfg.vocab_size, seed=5))
    batches = [next(it) for _ in range(3)]
    it.close()
    cpu_step, gpu_step = make_train_step(cpu_model, tcfg), make_train_step(gpu_model, tcfg)
    before = sk.ssd_scan.launches
    rows = []
    for b in batches:
        cpu_opt, cm = cpu_step(cpu_opt, b)
        gpu_opt, gm = gpu_step(gpu_opt, b)
        rows.append({k: (float(gm[k]), float(cm[k])) for k in ("loss", "grad_norm")})
    launches = sk.ssd_scan.launches - before
    for i, r in enumerate(rows):
        (gl, cl), (gg, cg) = r["loss"], r["grad_norm"]
        check(abs(gl - cl) <= SSM_LOSS_RTOL * abs(cl), f"step {i}: loss card {gl} vs CPU {cl}")
        check(abs(gg - cg) <= SSM_GNORM_RTOL * abs(cg), f"step {i}: grad norm card {gg} vs CPU {cg}")
    # each microbatch: one launch per layer forward, one per layer recompute under remat
    want = len(batches) * tcfg.microbatches * 2 * cfg.n_layers
    check(launches == want, f"SSD launches in 3 smoke steps: {launches}, want {want}")
    emit({"phase": "ssm_parity", "config": "mamba2-130m SMOKE", "dtype": "float32, TF32 off",
          "steps": [{k: {"card": v[0], "cpu": v[1]} for k, v in r.items()} for r in rows],
          "decode_tokens": tokens, "logits_max_abs_err": logits_err, "card_ssd_launches": launches,
          "tolerances": {"loss_rtol": SSM_LOSS_RTOL, "grad_norm_rtol": SSM_GNORM_RTOL,
                         "logits_atol": SSM_LOGITS_ATOL}})


def phase_train_full_width():
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import TrainConfig, Trainer, make_loss_fn, make_train_step

    cfg = get_config("mamba2-130m")
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    check((cfg.n_layers, cfg.d_model, H, s.head_dim, s.d_state, s.n_groups, s.chunk, cfg.vocab_size)
          == (24, 768, 24, 64, 128, 1, 256, 50280), "mamba2-130m's published shape")
    tcfg = TrainConfig(adamw=AdamWConfig(weight_decay=0.1, grad_clip=1.0),
                       schedule=ScheduleConfig(peak_lr=6e-4, warmup_steps=20, decay_steps=SCHEDULE_STEPS),
                       microbatches=TRAIN_MICRO)
    dcfg = DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size)
    train_it = make_train_iter(dcfg)
    eval_it = make_train_iter(dataclasses.replace(dcfg, seed=99))
    probe_it = make_train_iter(dataclasses.replace(dcfg, seed=7))
    probe = next(probe_it)  # one fixed held-out batch
    probe_it.close()
    trainer = Trainer(cfg, tcfg, train_it, eval_iter=eval_it, eval_every=EVAL_EVERY, device="cuda")
    t0 = time.perf_counter()
    model, opt = trainer.restore_or_init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    held_out = make_loss_fn(model, tcfg)
    with torch.no_grad():
        probe_before = float(held_out(probe)[1]["loss"])
    torch.cuda.reset_peak_memory_stats()

    sk.ssd_scan.launches = fa.flash_attention.launches = 0
    model, opt, hist = trainer.run(model, opt, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches, flash_launches = sk.ssd_scan.launches, fa.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_it.close()
    eval_it.close()

    with torch.no_grad():
        probe_after = float(held_out(probe)[1]["loss"])
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(e["loss"]) for e in trainer.eval_history), "non-finite loss")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first, f"train loss does not fall: first-10 mean {first}, last-10 mean {last}")
    check(probe_after < probe_before - EVAL_DROP,
          f"held-out loss does not fall by {EVAL_DROP}: {probe_before} -> {probe_after}")
    n_evals = TRAIN_STEPS // EVAL_EVERY
    train, evals = trainer.stats.summary(trainer.train_stream), trainer.stats.summary(trainer.eval_stream)
    check(train["steps"] == TRAIN_STEPS == len(hist), f"train lane steps {train['steps']}")
    check(evals["steps"] == n_evals == len(trainer.eval_history), f"eval lane steps {evals['steps']}")
    check(train["tokens"] == TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ, f"train lane tokens {train['tokens']}")
    per_launch = sk.ssd_flops(TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, H, s.head_dim, s.d_state)
    per_step = TRAIN_MICRO * 2 * cfg.n_layers  # a forward and a remat recompute per layer and microbatch
    check(trainer.cost_parts["ssd_kernel"] == per_step * per_launch, f"scan FLOPs {trainer.cost_parts}")
    lane_flops = TRAIN_STEPS * (trainer.cost_parts["counted"] + trainer.cost_parts["ssd_kernel"])
    check(abs(train["flops"] - lane_flops) <= 1e-9 * lane_flops, "the train lane's FLOPs are the counted plus the scan's")
    check(evals["flops"] == 0 and flash_launches == 0, "the eval lane carries no cost; no attention here")
    want = TRAIN_STEPS * per_step + n_evals * cfg.n_layers
    check(launches == want, f"SSD launches {launches}, want {want} = {TRAIN_STEPS} steps x {per_step} + "
                            f"{n_evals} evals x {cfg.n_layers}")
    step_ms = [r.seconds * 1e3 for r in trainer.stats.records if r.stream_id == trainer.train_stream]
    steady_ms = statistics.median(step_ms[2:])

    # the device's busy time over one more step, traced (the counts were read above); the
    # idle share is taken against the unprofiled median step, since the profiler's own host
    # cost would otherwise count as device idle
    from torch.profiler import ProfilerActivity, profile

    step = make_train_step(model, tcfg)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        opt, _ = step(opt, probe)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t1
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    idle = {"device_busy_ms": busy_s * 1e3, "kernel_launches": len(kernels), "step_ms_median": steady_ms,
            "idle_share": max(0.0, 1.0 - busy_s * 1e3 / steady_ms) if kernels else "not measured",
            "traced_step_ms": traced_s * 1e3, "profiler_s": time.perf_counter() - t0}

    # one step at the train_4k length
    long_batch = {k: np.concatenate([v] * (4096 // TRAIN_SEQ), axis=1)[:2] for k, v in probe.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt, m4k = step(opt, long_batch)
    loss_4k = float(m4k["loss"])
    step_4k_ms = (time.perf_counter() - t0) * 1e3
    peak_4k_gb = torch.cuda.max_memory_allocated() / 1e9
    check(np.isfinite(loss_4k), "non-finite loss at seq 4096")

    emit({
        "phase": "train_full_width", "config": "mamba2-130m", "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "ssd": {"H": H, "P": s.head_dim, "N": s.d_state, "G": s.n_groups, "chunk": s.chunk},
        "vocab": cfg.vocab_size, "dtype": {"compute": cfg.compute_dtype, "params": cfg.param_dtype},
        "remat": cfg.remat, "params": n_params, "init_s": init_s,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS,
        "schedule_steps": SCHEDULE_STEPS, "loss_first10": first, "loss_last10": last, "losses": losses,
        "held_out_loss": {"before": probe_before, "after": probe_after, "min_drop": EVAL_DROP},
        "eval_losses": [e["loss"] for e in trainer.eval_history],
        "lanes": {"train": train, "eval": evals}, "step_cost": trainer.cost_parts,
        "ssd_launches": launches, "ssd_launches_expected": want,
        "tokens_per_s": train["tokens_per_s"], "step_ms_median": steady_ms,
        "step_ms_first": step_ms[0], "max_memory_allocated_gb": peak_gb, "device_idle": idle,
        "seq4096": {"batch": 2, "microbatches": TRAIN_MICRO, "loss": loss_4k, "step_ms": step_4k_ms,
                    "max_memory_allocated_gb": peak_4k_gb},
    })
    return model, launches, probe


def phase_ssd_op(model, probe):
    """The SSD inputs every layer hands to ``ops.ssd_scan`` in one forward of
    a real training microbatch: the kernel against the sequential plain scan
    (the oracle), with the plain chunked form and an fp64 sequential scan
    beside them.  All pairings are emitted before any check fails."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_ref

    ssd_op, captured = ops.ssd_scan, []

    def capture(*args, **kw):
        captured.append((args, kw))
        return ssd_op(*args, **kw)

    ops.ssd_scan = capture
    try:
        with torch.no_grad():
            model(torch.as_tensor(probe["tokens"][: TRAIN_BATCH // TRAIN_MICRO], device="cuda").long())
    finally:
        ops.ssd_scan = ssd_op
    check(len(captured) == model.cfg.n_layers, f"{len(captured)} SSD calls in one forward")

    def close(a, b):
        return bool(torch.allclose(a.float(), b.float(), **SSD_BF16_TOL))

    rows = []
    for args, kw in captured:
        with torch.no_grad():
            y, h = ssd_op(*args, **kw)
            py, ph = ssd_op(*args, **{**kw, "impl": "plain"})
            sy, sh = ssd_ref(*args, h0=kw.get("h0"), return_state=True)
            wide = [a.double() if torch.is_tensor(a) else a for a in args]
            dy, dh = ssd_ref(*wide, return_state=True)
        x, dt = args[0], args[1]
        worst = int((y.double() - dy).abs().argmax())
        rows.append({
            "kernel_vs_seq": (y.float() - sy.float()).abs().max().item(), "kernel_vs_plain":
                (y.float() - py.float()).abs().max().item(),
            "err_vs_fp64": {n: (v.double() - dy).abs().max().item() for n, v in (("kernel", y), ("plain", py),
                                                                                   ("seq", sy))},
            "outside_bf16_tol_vs_fp64": {n: int((~torch.isclose(v.double(), dy, **SSD_BF16_TOL)).sum())
                                         for n, v in (("kernel", y), ("plain", py), ("seq", sy))},
            "max_abs_out": dy.abs().max().item(), "max_abs_x": x.float().abs().max().item(),
            "max_dt": dt.max().item(),
            "worst": {"kernel": y.flatten()[worst].item(), "plain": py.flatten()[worst].item(),
                      "seq": sy.flatten()[worst].item(), "fp64": dy.flatten()[worst].item()},
            "h_rel": {"kernel_vs_seq": _rel(h, sh), "kernel_vs_plain": _rel(h, ph), "kernel_vs_fp64": _rel(h, dh)},
            "ok": {"y_vs_seq": close(y, sy), "y_vs_plain": close(y, py), "h": _rel(h, sh) <= SSD_H_REL},
        })
    emit({"phase": "ssd_op", "config": "mamba2-130m", "inputs": "one training microbatch (4 x 256), every layer",
          "layers": rows, "tolerance": SSD_BF16_TOL, "h_rel_tolerance": SSD_H_REL})
    for layer, r in enumerate(rows):
        check(r["ok"]["y_vs_seq"], f"bf16 SSD kernel disagrees with ssd_ref on layer {layer}'s training inputs")
        check(r["ok"]["h"], f"h_final kernel vs ssd_ref on layer {layer}: {r['h_rel']}")
    return max(r["kernel_vs_seq"] for r in rows)


def phase_decode_full_width(model):
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, compute_dtype="float32")  # params are fp32 already
    g = torch.Generator(device="cuda").manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size, (1, 108), generator=g, device="cuda")
    V = cfg.vocab_size  # the padded entries are -1e9 on every path and would swamp the norm
    with torch.no_grad():
        full = model(toks)[0][..., :V]
    last, cache = model.prefill(toks[:, :100])
    rels = [_rel(last[..., :V], full[:, 99])]
    for t in range(100, 108):
        logits, cache = model.decode_step(cache, toks[:, t], torch.tensor([t], device="cuda"))
        rels.append(_rel(logits[..., :V], full[:, t]))
    model.cfg = cfg
    check(max(rels) <= DECODE_FP32_REL, f"fp32 decode vs forward logits rel L2 {rels}")
    emit({"phase": "decode_full_width", "config": "mamba2-130m", "dtype": "float32, TF32 off",
          "prefill_len": 100, "decode_steps": 8, "logits_rel_l2": rels, "tolerance": DECODE_FP32_REL})


def _u64_on_card(a: np.ndarray) -> torch.Tensor:
    """A numpy int64 or uint64 array on the card as int64 storage (the same bits)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64, copy=False)).cuda()


def _sim_jobs(draws, engine, backend):
    from repro_torch.sim.batch import BatchJob

    return [BatchJob.make(d["scenario"], d["params"], engine=engine, config=dict(array_backend=backend))
            for d in draws]


class _OpCalls:
    """Wraps an array-ops object's methods in place for one run: counts the
    calls that hand a kernel work (non-empty input), sums their host wall,
    and keeps each ``segment_scatter`` call's inputs when asked to."""

    NON_EMPTY = {
        "segment_scatter": lambda seg, lin, cnt, n_segs, row_size: len(seg) > 0 and n_segs > 0,
        "scatter_add_u64": lambda dense, lin, cnt: len(lin) > 0,
        "running_sum": lambda values: np.asarray(values).size > 0,
        "sorted_membership": lambda values, table: False,  # torch.searchsorted, no kernel of ours
    }

    def __init__(self, ops, keep_inputs: bool = False):
        self.ops, self.keep_inputs = ops, keep_inputs
        self.calls = {n: 0 for n in self.NON_EMPTY}
        self.kernel_calls = {n: 0 for n in self.NON_EMPTY}
        self.wall_s = {n: 0.0 for n in self.NON_EMPTY}
        self.landings = []  # (seg, lin, cnt, n_segs, row_size, table) of each segment_scatter call

    def __enter__(self):
        for name, non_empty in self.NON_EMPTY.items():
            method = getattr(self.ops, name)

            def counted(*args, _name=name, _method=method, _non_empty=non_empty):
                t0 = time.perf_counter()
                out = _method(*args)
                self.wall_s[_name] += time.perf_counter() - t0
                self.calls[_name] += 1
                self.kernel_calls[_name] += int(_non_empty(*args))
                if _name == "segment_scatter" and self.keep_inputs:
                    self.landings.append((*args, out))
                return out

            setattr(self.ops, name, counted)
        return self

    def __exit__(self, *exc):
        for name in self.NON_EMPTY:
            delattr(self.ops, name)  # the class's method shows through again


def phase_segment_kernel(smi: str):
    """The segment kernel, its accumulate entry and the fold kernel against
    their plain versions on the card, bit for bit, on test shapes and on the
    real landing inputs of the sweep, captured from the port's NumpyOps;
    then the segment kernel timed at the 64- and 2-draw landing shapes."""
    from repro_torch.core.array_ops import get_backend
    from repro_torch.kernels import segment_scatter as ss
    from repro_torch.kernels.ref import running_sum_ref, scatter_add_ref, segment_scatter_ref
    from repro_torch.sim.batch import BatchRunner
    from repro_torch.sim.scenarios import divergent_draws

    # the real landings: the sweeps on the NumPy reference, their scatter inputs kept
    sweeps = {}
    for k in (SIM_DRAWS, SIM_SMALL_DRAWS):
        jobs = _sim_jobs(divergent_draws(k, seed=SIM_SEED), "event", "numpy")
        with _OpCalls(get_backend("numpy"), keep_inputs=True) as rec:
            t0 = time.perf_counter()
            result = BatchRunner(jobs, backend="batched").run()
            wall = time.perf_counter() - t0
        check(result.failures() == [] and rec.landings, f"numpy sweep at {k} draws: {result.failures()[:3]}")
        sweeps[k] = {"result": result, "wall_s": wall, "landings": rec.landings}

    rng = np.random.default_rng(0)
    cases = []  # (label, seg, lin, cnt uint64, n_segs, row_size, numpy's table or None)
    for n, n_segs, row_size in SEG_SHAPES:
        r = np.random.default_rng(n_segs * row_size)
        cases.append((f"E{n}_({n_segs},{row_size})", r.integers(0, n_segs + 2, n), r.integers(0, row_size, n),
                      r.integers(1, 50, n).astype(np.uint64), n_segs, row_size, None))
    cases.append(("all_overflow", np.full(64, 9), np.zeros(64, np.int64), np.ones(64, np.uint64), 4, 16, None))
    cases.append(("empty", np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.uint64), 3, 5, None))
    big = np.where(rng.random(5000) < 0.5, np.uint64((1 << 64) - 1000), np.uint64((1 << 63) - 10))
    cases.append(("wraps_2^64", rng.integers(0, 5, 5000), rng.integers(0, 6, 5000), big, 4, 6, None))
    for k, sw in sweeps.items():
        for i, (seg, lin, cnt, n_segs, row_size, table) in enumerate(sw["landings"]):
            cases.append((f"sweep{k}_call{i}", seg, lin, cnt, n_segs, row_size, table))

    rows, max_err = [], 0
    for label, seg, lin, cnt, n_segs, row_size, np_table in cases:
        args = (_u64_on_card(seg), _u64_on_card(lin), _u64_on_card(cnt), n_segs, row_size)
        got, bad = ss.segment_scatter(*args)
        want, want_bad = segment_scatter_ref(*args)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        equal = bool(torch.equal(got, want)) and bad.item() == want_bad.item() == 0
        if np_table is not None:
            equal = equal and np.array_equal(got.cpu().numpy().view(np.uint64), np_table)
        max_err = max(max_err, err)
        rows.append({"case": label, "events": len(seg), "table": [n_segs, row_size], "equal": equal,
                     "nonzero_cells": int(torch.count_nonzero(want))})
        check(equal, f"segment kernel differs from segment_scatter_ref (and NumPy) on {label}")

    # the accumulate entry into a caller's buffer, and the fold kernel
    lin = rng.integers(0, 100_000, 400_000)
    cnt = np.where(rng.random(400_000) < 0.5, np.uint64((1 << 64) - 3), rng.integers(1, 9, 400_000).astype(np.uint64))
    base = _u64_on_card(rng.integers(0, 1 << 62, 100_000))
    dense, want = base.clone(), base.clone()
    bad = ss.scatter_add(dense, _u64_on_card(lin), _u64_on_card(cnt))
    scatter_add_ref(want, _u64_on_card(lin), _u64_on_card(cnt))
    check(torch.equal(dense, want) and bad.item() == 0, "accumulate entry differs from scatter_add_ref")
    fold = []
    for shape in ((7367,), (300, 9), (64, 3), (1,)):
        vals = rng.uniform(-1.0, 1.0, size=shape) * (10.0 ** rng.integers(-8, 8, size=shape))
        ints = rng.integers(-(1 << 62), 1 << 62, size=shape)
        for a in (vals, ints):
            got = ss.running_sum(torch.from_numpy(a).cuda())
            equal = torch.equal(got, running_sum_ref(torch.from_numpy(a).cuda()))
            equal = equal and np.array_equal(got.cpu().numpy(), np.add.accumulate(a, axis=0))
            fold.append({"shape": list(shape), "dtype": str(a.dtype), "equal": bool(equal)})
            check(equal, f"fold kernel differs from running_sum_ref / np.add.accumulate at {shape} {a.dtype}")

    # timing at the landing shapes of the 64- and 2-draw sweeps (their largest call: the cumulative table)
    peak_flops, peak_bw, peak_src = peaks(smi)
    torch_ops, numpy_ops = get_backend("torch"), get_backend("numpy")
    timings = {}
    for k, sw in sweeps.items():
        seg, lin, cnt, n_segs, row_size, np_table = max(sw["landings"], key=lambda c: len(c[0]))
        seg_d, lin_d, cnt_d = _u64_on_card(seg), _u64_on_card(lin), _u64_on_card(cnt)
        keep = seg < n_segs
        flat_d, kept_d = _u64_on_card(seg[keep] * row_size + lin[keep]), _u64_on_card(cnt[keep])
        size = n_segs * row_size

        def library():
            return torch.zeros(size, dtype=torch.int64, device="cuda").index_add_(0, flat_d, kept_d)

        check(np.array_equal(library().cpu().numpy().view(np.uint64), np_table.reshape(-1)),
              f"index_add_ does not compute the landing at {k} draws")
        ms = time_interleaved({
            "kernel": lambda: ss.segment_scatter(seg_d, lin_d, cnt_d, n_segs, row_size),
            "plain": lambda: segment_scatter_ref(seg_d, lin_d, cnt_d, n_segs, row_size),
            "library": library,
        }, eager=("plain",))
        host = {"torch": [], "numpy": []}
        for _ in range(HOST_ROUNDS):
            for name, o in (("torch", torch_ops), ("numpy", numpy_ops)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = o.segment_scatter(seg, lin, cnt, n_segs, row_size)
                host[name].append((time.perf_counter() - t0) * 1e3)
                check(np.array_equal(out, np_table), f"{name} op differs from numpy's landing at {k} draws")
        nbytes = 24 * len(seg) + 8 * size
        t_bytes = nbytes / peak_bw * 1e3
        flat = seg[keep] * row_size + lin[keep]
        per_cell = np.bincount(np.unique(flat, return_inverse=True)[1])
        timings[f"draws{k}"] = {
            "events": len(seg), "n_segs": n_segs, "row_size": row_size, "table_bytes": 8 * size,
            "touched_cells": int(per_cell.size), "busiest_cell_events": int(per_cell.max()),
            "share_of_unit_counts": float((cnt == 1).mean()),
            "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"],
            "library_ms": ms["library"]["median"], "bound_ms": t_bytes, "bound_by": "bytes", "bytes": nbytes,
            "op_wall_ms_with_copies": statistics.median(host["torch"]),
            "numpy_op_wall_ms_host": statistics.median(host["numpy"]),
            "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()},
            "host_readings_ms": host,
        }
        del seg_d, lin_d, cnt_d, flat_d, kept_d
    emit({"phase": "segment_kernel", "name": "segment_scatter", "cases": rows, "max_abs_err": max_err,
          "accumulate_entry_equal": True, "fold": fold, "tolerance": "exact equality (uint64 mod 2^64)",
          "peaks": {"hbm_bytes_s": peak_bw, "source": peak_src},
          "bound": "(24 bytes per event + 8 per table cell, the zero fill included) / HBM rate",
          "timing": timings,
          "timing_note": f"median of {ROUNDS} readings of {LAUNCHES} calls each between CUDA events; kernel "
                         "and index_add_ (zero fill + one index_add_ of the kept events' precomputed flat "
                         "index) replayed from a CUDA graph, the plain version (its boolean mask syncs) run "
                         "eagerly; inputs warm in L2; op walls are host-clock medians of "
                         f"{HOST_ROUNDS} calls of TorchOps / NumpyOps.segment_scatter, numpy in and out",
          "numpy_sweep_wall_s": {str(k): sw["wall_s"] for k, sw in sweeps.items()}})
    ss.segment_scatter.launches = ss.scatter_add.launches = ss.running_sum.launches = 0
    return max_err, timings, sweeps[SIM_DRAWS]


def phase_sim_sweep(numpy_sweep):
    """The simulator's batched divergent sweep over the full registry on the
    card, against the same jobs on NumPy; launches of each kernel equal the
    calls that handed it work.  Then the landing traced once for the device's
    busy time, and the compiled engine, whose running sums fold on the card."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.array_ops import get_backend
    from repro_torch.kernels import segment_scatter as ss
    import repro_torch.sim.batched as batched
    from repro_torch.sim.batch import BatchRunner
    from repro_torch.sim.compiled import TRACE_CACHE
    from repro_torch.sim.scenarios import divergent_draws, list_scenarios

    draws = divergent_draws(SIM_DRAWS, seed=SIM_SEED)
    ops = get_backend("torch")
    check(ops.device.type == "cuda", "array_backend='torch' must run on the card")
    land = batched._land
    timed = {}

    def timed_land(sims, o):
        t0 = time.perf_counter()
        land(sims, o)
        torch.cuda.synchronize()
        timed["land_s"] = time.perf_counter() - t0

    def traced_land(sims, o):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            land(sims, o)
            torch.cuda.synchronize()
            timed["traced_land_s"] = time.perf_counter() - t0
        timed["prof"] = prof

    def kernel_launches():
        return {"segment_scatter": ss.segment_scatter.launches, "scatter_add_u64": ss.scatter_add.launches,
                "running_sum": ss.running_sum.launches}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    jobs = _sim_jobs(draws, "event", "torch")
    batched._land = timed_land
    try:
        with _OpCalls(ops) as rec:
            ss.segment_scatter.launches = ss.scatter_add.launches = ss.running_sum.launches = 0
            t0 = time.perf_counter()
            result = BatchRunner(jobs, backend="batched").run()
            wall = time.perf_counter() - t0
            launches = kernel_launches()
    finally:
        batched._land = land
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(jobs) == SIM_DRAWS * len(list_scenarios()), f"{len(jobs)} jobs")
    check(result.failures() == [], f"failed jobs on the card: {result.failures()[:3]}")
    check(result.oracle_failures() == [], f"oracle failures: {result.oracle_failures()[:3]}")
    check(result.signature() == numpy_sweep["result"].signature(), "sweep on the card differs from NumPy's")
    want = {n: rec.kernel_calls[n] for n in ("segment_scatter", "scatter_add_u64", "running_sum")}
    check(launches == want, f"launches {launches} != calls that handed a kernel work {want}")
    check(launches["segment_scatter"] >= 1 and launches["scatter_add_u64"] >= 1, f"kernels not launched: {launches}")
    events = sum(len(c[0]) for c in numpy_sweep["landings"])

    # one more run of the same sweep, its landing traced (its launches are not counted above)
    batched._land = traced_land
    try:
        traced = BatchRunner(_sim_jobs(draws, "event", "torch"), backend="batched").run()
    finally:
        batched._land = land
    check(traced.failures() == [], "failed jobs in the traced sweep")
    prof = timed.pop("prof")
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = {}
    for e in dev:
        kind = "memcpy" if "Memcpy" in e.name else "memset" if "Memset" in e.name else e.name[:60]
        busy_us[kind] = busy_us.get(kind, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(busy_us.values()) / 1e3
    idle = {"device_busy_ms": busy_ms, "device_events": len(dev),
            "busy_ms_by_kind": {k: v / 1e3 for k, v in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]},
            "landing_wall_ms": timed["land_s"] * 1e3, "traced_landing_wall_ms": timed["traced_land_s"] * 1e3,
            "idle_share_of_landing": max(0.0, 1.0 - busy_ms / (timed["land_s"] * 1e3)) if dev else "not measured",
            "idle_share_of_sweep": max(0.0, 1.0 - busy_ms / (wall * 1e3)) if dev else "not measured"}

    # the compiled engine: its trace workloads fold bandwidth pointers through running_sum
    cdraws = divergent_draws(SIM_COMPILED_DRAWS, seed=SIM_SEED)
    compiled = {}
    for backend in ("torch", "numpy"):
        TRACE_CACHE.clear()  # both runs compile every shape
        with _OpCalls(ops) as crec:
            ss.segment_scatter.launches = ss.scatter_add.launches = ss.running_sum.launches = 0
            compiled[backend] = BatchRunner(_sim_jobs(cdraws, "compiled", backend), backend="batched").run()
            claunches = kernel_launches()
        if backend == "torch":
            ccalls = {n: crec.kernel_calls[n] for n in ("segment_scatter", "scatter_add_u64", "running_sum")}
            c_launches = claunches
    check(compiled["torch"].failures() == [] and compiled["torch"].oracle_failures() == [],
          "compiled-engine sweep on the card failed")
    check(compiled["torch"].signature() == compiled["numpy"].signature(), "compiled sweep: card differs from NumPy")
    check(c_launches == ccalls and c_launches["running_sum"] >= 1, f"compiled: launches {c_launches}, calls {ccalls}")

    emit({"phase": "sim_sweep", "draws": SIM_DRAWS, "seed": SIM_SEED, "jobs": len(jobs), "engine": "event",
          "array_backend": "torch", "scenarios": len(list_scenarios()), "signature_equal_numpy": True,
          "failed_jobs": 0, "oracle_failures": 0, "landing_events": events,
          "launches": launches, "calls": rec.calls, "op_wall_ms": {n: v * 1e3 for n, v in rec.wall_s.items()},
          "sweep_wall_s": wall, "numpy_sweep_wall_s": numpy_sweep["wall_s"],
          "landing_wall_s": timed["land_s"], "simulate_wall_s": wall - timed["land_s"],
          "max_memory_allocated_gb": peak_gb, "device_idle": idle,
          "compiled": {"draws": SIM_COMPILED_DRAWS, "jobs": len(cdraws), "signature_equal_numpy": True,
                       "launches": c_launches, "calls": ccalls}})
    ss.segment_scatter.launches = ss.scatter_add.launches = ss.running_sum.launches = 0
    return launches["segment_scatter"]


def main() -> int:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_scatter as ss
    from repro_torch.kernels import ssd_scan as sk

    smi = phase_device()
    phase_build()
    bf16_err, timings = phase_kernel(smi)
    phase_parity()
    launches, op_err = phase_full_width()
    ssd_err, ssd_timings = phase_ssd_kernel(smi)
    phase_ssm_parity()
    model, ssd_launches, probe = phase_train_full_width()
    phase_decode_full_width(model)
    ssd_op_err = phase_ssd_op(model, probe)
    del model, probe
    seg_err, seg_timings, numpy_sweep = phase_segment_kernel(smi)
    seg_launches = phase_sim_sweep(numpy_sweep)
    t = timings[512]
    st = ssd_timings["B4_S256"]
    gt = seg_timings[f"draws{SIM_DRAWS}"]
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": fa.SOURCE, "replaces": fa.REPLACES,
        "launches": launches, "max_abs_err": max(bf16_err, op_err),
        "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": "B=1 S=512 Hq=Hkv=32 D=128 bf16 causal",
    }, {
        "name": "ssd_scan", "route": "cuda", "source": sk.SOURCE, "replaces": sk.REPLACES,
        "launches": ssd_launches, "max_abs_err": max(ssd_err, ssd_op_err),
        "ms": st["kernel_ms"], "kernel_ms": st["kernel_ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"], "library_ms": None,
        "shape": "B=4 S=256 H=24 P=64 N=128 G=1 bf16 (the training microbatch)",
    }, {
        "name": "segment_scatter", "route": "cuda", "source": ss.SOURCE, "replaces": ss.REPLACES,
        "launches": seg_launches, "max_abs_err": seg_err,
        "ms": gt["kernel_ms"], "kernel_ms": gt["kernel_ms"], "plain_ms": gt["plain_ms"],
        "bound_ms": gt["bound_ms"], "bound_by": gt["bound_by"], "library_ms": gt["library_ms"],
        "shape": f"E={gt['events']} events into a ({gt['n_segs']}, {gt['row_size']}) uint64 table "
                 f"(the {SIM_DRAWS}-draw sweep's landing)",
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
