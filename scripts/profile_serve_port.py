#!/usr/bin/env python3
"""Where the port's serving time goes on the GPU: device busy share and top kernels.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/profile_serve_port.py

It builds deepseek-7b at full width (bf16, random weights from seed 0),
fills the engine's 4 slots with 256-token prompts, then traces one
256-token prefill and 5 decode steps (4 live requests) with
``torch.profiler``.  For each window it prints one JSON line: host wall
time, the summed duration of the CUDA kernels it ran (the device's busy
time; one stream, so kernels do not overlap), the number of kernel
launches, the kernels that took the most device time and the flash-attention
kernels' share.  The same work
is also timed without the profiler, and the idle share is taken against
that wall time: the profiler's own host cost is not device idle.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def kernel_summary(prof, traced_s: float, wall_s: float, n: int):
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_busy_ms": "not measured (the profiler recorded no device activity)"}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flash_us = sum(us for name, us in by_name.items() if "flash_fwd" in name)
    return {
        "per": n,
        "traced_wall_ms": traced_s * 1e3 / n,
        "device_busy_ms": busy_us / 1e3 / n,
        "idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_s),
        "kernel_launches": len(kernels) / n,
        "top_kernels_ms": {name[:80]: us / 1e3 / n for name, us in top},
        "flash_attention_ms": flash_us / 1e3 / n,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serve_port: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.serve import Engine, Request, ServeConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = get_config("deepseek-7b")
    model = Transformer(cfg, device="cuda", seed=0)
    eng = Engine(model, ServeConfig(n_slots=4, max_len=1024, batch_buckets=(1, 2)))
    rng = np.random.default_rng(0)
    prompt = lambda: rng.integers(0, cfg.vocab_size, (256,)).astype(np.int32)  # noqa: E731
    for i in range(4):
        eng.submit(Request(prompt=prompt(), max_new_tokens=40, name=f"r{i}"))
    eng.step()  # admits all four
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()

    tokens = torch.as_tensor(prompt(), dtype=torch.long, device="cuda")[None]
    model.prefill(tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(tokens)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(json.dumps({"window": "prefill", "tokens": 256, "wall_ms_unprofiled": plain_wall * 1e3,
                      **kernel_summary(prof, wall, plain_wall, 1)}), flush=True)

    t0 = time.perf_counter()
    for _ in range(5):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(json.dumps({"window": "decode_step", "live_requests": len(eng._active()),
                      "wall_ms_unprofiled": plain_wall * 1e3 / 5, **kernel_summary(prof, wall, plain_wall, 5)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
