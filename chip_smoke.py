#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources, holds each against
its plain PyTorch version on the card and times both, serves a seeded
trace with the deepseek-7b smoke config on the card and on the CPU and
compares them, then serves deepseek-7b at full width (30 layers, d_model
4096, bf16, random weights from a seed) through the continuous-batching
engine and checks the per-stream lanes and that every prefill went through
the flash-attention kernel.  Each phase prints one JSON line; the last line
is ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line; without a GPU it fails at once.  The compiler's full
report is written beside the built libraries, ``build/repro_torch/build.log``.
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


def time_interleaved(fns, warmup: int = 3):
    """Device ms per call of each function in ``fns`` (name → callable).

    Each function's ``LAUNCHES`` back-to-back calls are captured once into
    a CUDA graph; a reading is one replay between a pair of CUDA events,
    divided by ``LAUNCHES``, so it holds device time without the host's
    per-call cost (an SDPA call costs the host about as long as the card).
    Each round takes one reading of every function in turn; returns per
    name the median, min and max of ``ROUNDS`` readings."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as graph capture wants
        for fn in fns.values():
            for _ in range(warmup):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = {}
    for name, fn in fns.items():
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(LAUNCHES):
                fn()
    torch.cuda.synchronize()
    readings = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, graph in graphs.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
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


def main() -> int:
    from repro_torch.kernels import flash_attention as fa

    smi = phase_device()
    phase_build()
    bf16_err, timings = phase_kernel(smi)
    phase_parity()
    launches, op_err = phase_full_width()
    t = timings[512]
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": fa.SOURCE, "replaces": fa.REPLACES,
        "launches": launches, "max_abs_err": max(bf16_err, op_err),
        "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": "B=1 S=512 Hq=Hkv=32 D=128 bf16 causal",
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
