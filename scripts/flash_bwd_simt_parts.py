#!/usr/bin/env python3
"""Where the fp32 SIMT flash backward's time goes, part by part.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/flash_bwd_simt_parts.py

It compiles copies of ``csrc/flash_attention_bwd.cu`` with one part of each
tile's work taken out (the results are then wrong; only the time is read)
into ``build/repro_torch/parts/``, one ``nvcc`` each, all started together:

* ``base``: the kernel as it is;
* ``no_scores``: the score products (S and dP) replaced by zeros;
* ``no_accumulate``: the accumulator products (dV and dK, or dQ) left out;
* ``no_tile_loads``: the q or kv tiles that stream through the two stages
  not copied (the rows' lse and D_i still are).

Each is timed at ``chip_smoke.py``'s ``BWD_TIMED`` shape in fp32, causal: 10
calls between CUDA events, three rounds in turns, the median taken.  The
difference from ``base`` is what that part costs beyond what overlaps it.
One JSON line.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

ROUNDS, CALLS = 3, 10
#: part → (pattern of a source line, what replaces it); each must match
PARTS = {
    "no_scores": (r"^( *)scores<D>\(.*\);$", r"\1for (int i = 0; i < TI; ++i) for (int j = 0; j < TJ; ++j) sc[i][j] = 0.f;"),
    "no_accumulate": (r"^ *accumulate<D, .*\);$", ""),
    "no_tile_loads": (r"^ *stage<D>\((sQ|sdO|sK|sV) \+ s \* TILE,.*$", ""),
}


def variant(src: str, part: str) -> str:
    if part == "base":
        return src
    pattern, repl = PARTS[part]
    out, n = re.subn(pattern, repl, src, flags=re.M)
    if n == 0:
        raise SystemExit(f"flash_bwd_simt_parts: {part}: no line of the source matches {pattern!r}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_simt_parts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    out_dir = build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)

    def compile_part(part):
        cu, so = out_dir / f"{part}.cu", out_dir / f"{part}.so"
        cu.write_text(variant(src, part))
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"flash_bwd_simt_parts: {part} does not build:\n{r.stderr}")
        return part, ctypes.CDLL(str(so))

    parts = ["base", *PARTS]
    with ThreadPoolExecutor(len(parts)) as pool:
        libs = dict(pool.map(compile_part, parts))

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, D = chip_smoke.BWD_TIMED
    q, k, v, do = (chip_smoke.randn((B, S, H, D), torch.float32, 610 + j) for j in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    load = build.load
    readings = {part: [] for part in parts}
    try:
        for _ in range(ROUNDS):
            for part in parts:
                # the wrapper takes this part's library in place of the built one
                build.load = lambda name, lib=libs[part]: lib if name == "flash_attention_bwd" else load(name)
                fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(CALLS):
                    fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
                end.record()
                end.synchronize()
                readings[part].append(start.elapsed_time(end) / CALLS)
    finally:
        build.load = load
    ms = {part: statistics.median(r) for part, r in readings.items()}
    print(json.dumps({"shape": f"B={B} S={S} Hq=Hkv={H} D={D} float32 causal", "ms": ms,
                      "cost_ms": {part: ms["base"] - ms[part] for part in PARTS},
                      "readings_ms": readings, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
