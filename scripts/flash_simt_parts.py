#!/usr/bin/env python3
"""Where the fp32 SIMT flash kernels' time goes, part by part.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/flash_simt_parts.py            # the forward and the backward
    python3 scripts/flash_simt_parts.py --kernel fwd
    python3 scripts/flash_simt_parts.py --kernel fwd --shape 2,64,4,32 --against OLD/flash_attention.cu

For each kernel it compiles copies of its source with one part of each
tile's work taken out (the results are then wrong; only the time is read)
into ``build/repro_torch/parts/``, one ``nvcc`` each, all started together:

* ``base``: the kernel as it is;
* ``no_scores``: the score products (S, and dP in the backward) replaced by
  zeros;
* ``no_softmax`` (forward): the pass that forms P and the rows' rescale
  factors left out;
* ``no_accumulate``: the accumulator products (O += P V; dV and dK, or dQ)
  left out;
* ``no_tile_loads``: the tiles that stream through the two stages (K and V
  forward; q or kv tiles backward, the rows' lse and D_i still copied) not
  copied after the first;
* ``against`` (with ``--against FILE``): another version of the library's
  source with the same C entry, for example an earlier commit's, timed
  beside ``base`` in the same process.

The forward is timed at B=1 S=512 32 heads of 128 (``--shape B,S,H,D``
for another), the backward at
``chip_smoke.py``'s ``BWD_TIMED`` shape, both fp32 and causal: 10 calls
between CUDA events, three rounds in turns, the median taken.  The
difference from ``base`` is what that part costs beyond what overlaps it.
One JSON line a kernel.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
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
#: kernel → (its library, and per part the pattern of its source lines and what replaces them; each must match)
KERNELS = {
    "fwd": ("flash_attention", {
        "no_scores": (r"^( *)scores_part<D>\(.*\);$", r"\1for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;"),
        "no_softmax": (r"(?s)^    \{  // P = exp\(.*?^    \}\n", ""),
        "no_accumulate": (r"^ *accumulate<D, .*\);$", ""),
        "no_tile_loads": (r"^ *issue\(it \+ 1\);$", ""),
    }),
    "bwd": ("flash_attention_bwd", {
        "no_scores": (r"^( *)scores<D>\(.*\);$", r"\1for (int i = 0; i < TI; ++i) for (int j = 0; j < TJ; ++j) sc[i][j] = 0.f;"),
        "no_accumulate": (r"^ *accumulate<D, .*\);$", ""),
        "no_tile_loads": (r"^ *stage<D>\((sQ|sdO|sK|sV) \+ s \* TILE,.*$", ""),
    }),
}


def variant(src: str, parts, part: str) -> str:
    if part == "base":
        return src
    pattern, repl = parts[part]
    out, n = re.subn(pattern, repl, src, flags=re.M)
    if n == 0:
        raise SystemExit(f"flash_simt_parts: {part}: no line of the source matches {pattern!r}")
    return out


def time_parts(kernel: str, shape=(1, 512, 32, 128), against: Path | None = None) -> dict:
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    lib_name, parts = KERNELS[kernel]
    src = (build.CSRC / build.SOURCES[lib_name]).read_text()
    out_dir = build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)

    def compile_part(part):
        cu, so = out_dir / f"{kernel}_{part}.cu", out_dir / f"{kernel}_{part}.so"
        cu.write_text(against.read_text() if part == "against" else variant(src, parts, part))
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"flash_simt_parts: {kernel} {part} does not build:\n{r.stderr}")
        return part, ctypes.CDLL(str(so))

    names = ["base", *parts, *(["against"] if against else [])]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(pool.map(compile_part, names))

    if kernel == "fwd":
        B, S, H, D = shape
        q, k, v = (chip_smoke.randn((B, S, H, D), torch.float32, 600 + j) for j in range(3))
        call = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    else:
        B, S, H, D = chip_smoke.BWD_TIMED
        q, k, v, do = (chip_smoke.randn((B, S, H, D), torch.float32, 610 + j) for j in range(4))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        call = lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)  # noqa: E731
    load = build.load
    readings = {part: [] for part in names}
    try:
        for _ in range(ROUNDS):
            for part in names:
                # the wrapper takes this part's library in place of the built one
                build.load = lambda name, lib=libs[part]: lib if name == lib_name else load(name)
                call()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(CALLS):
                    call()
                end.record()
                end.synchronize()
                readings[part].append(start.elapsed_time(end) / CALLS)
    finally:
        build.load = load
    ms = {part: statistics.median(r) for part, r in readings.items()}
    return {"kernel": kernel, "shape": f"B={B} S={S} Hq=Hkv={H} D={D} float32 causal", "ms": ms,
            "cost_ms": {part: ms["base"] - ms[part] for part in parts},
            "readings_ms": readings, "device": torch.cuda.get_device_name(0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=[*KERNELS, "both"], default="both")
    ap.add_argument("--shape", default="1,512,32,128", help="the forward's B,S,H,D (fp32, causal)")
    ap.add_argument("--against", type=Path, help="another source of the kernel's library, timed as 'against'")
    args = ap.parse_args()
    shape = tuple(int(n) for n in args.shape.split(","))
    if args.against and args.kernel == "both":
        ap.error("--against names one kernel's source: give --kernel fwd or bwd")
    if not torch.cuda.is_available():
        print("flash_simt_parts: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for kernel in (KERNELS if args.kernel == "both" else [args.kernel]):
        print(json.dumps(time_parts(kernel, shape, args.against)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
