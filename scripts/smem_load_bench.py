#!/usr/bin/env python3
"""What one warp's 128-bit shared-memory load costs, by how its lanes' addresses repeat.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/smem_load_bench.py

The SIMT kernels (``csrc/flash_attention_bwd.cu``) are bound by shared-memory
reads, so which operand a warp reads as a broadcast decides their tiling.  This
builds a small CUDA program into ``build/repro_torch/smem_load_bench`` and runs
it: 132 blocks of 8 warps, one an SM, each lane loading a float4 from shared
memory (``ld.volatile.shared.v4.f32``, so no load is merged away) 32,768 times
at an address set by the pattern, between two ``clock64`` reads.  It prints one
JSON line: SM cycles per warp-wide load, per pattern.  Exits non-zero without
nvcc or a GPU.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: pattern → (float offset of a lane's float4 as a C expression of `lane`, what it is)
PATTERNS = {
    "distinct": ("lane * 4", "32 addresses, 8 in each quarter-warp"),
    "eight_same_in_every_quarter": ("(lane & 7) * 4", "8 addresses, the same 8 in every quarter-warp"),
    "four_same_in_every_quarter": ("(lane & 3) * 4", "4 addresses, the same 4 in every quarter-warp"),
    "four_a_quarter": ("((lane & 3) + 4 * (lane >> 3)) * 4", "16 addresses, 4 in each quarter-warp"),
    "two_same_in_every_quarter": ("(lane & 1) * 4", "2 addresses, the same 2 in every quarter-warp"),
    "two_a_quarter": ("((lane >> 3) + 4 * (lane & 1)) * 4", "8 addresses, 2 in each quarter-warp"),
    "one_a_quarter": ("(lane >> 3) * 4", "4 addresses, 1 in each quarter-warp"),
    "one": ("0", "1 address"),
}
ITERS, UNROLL, WARPS = 4096, 8, 8

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void bench(int pattern, long long* cycles, float* sink) {
  __shared__ __align__(16) float s[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) s[i] = i;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int off = 0;
  switch (pattern) {
%(cases)s
  }
  const unsigned addr = (unsigned)__cvta_generic_to_shared(s + off);
  float acc[%(unroll)d] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < %(iters)d; ++it) {
#pragma unroll
    for (int u = 0; u < %(unroll)d; ++u) {
      float x, y, z, w;
      asm volatile("ld.volatile.shared.v4.f32 {%%0,%%1,%%2,%%3}, [%%4];"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(w) : "r"(addr + u * 1024));
      (void)y, (void)z, (void)w;
      acc[u] += x;
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  float t = 0.f;
  for (int u = 0; u < %(unroll)d; ++u) t += acc[u];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
int main() {
  long long* cycles; float* sink;
  cudaMalloc(&cycles, 132 * sizeof(long long));
  cudaMalloc(&sink, 132 * %(threads)d * sizeof(float));
  for (int p = 0; p < %(n)d; ++p) {
    bench<<<132, %(threads)d>>>(p, cycles, sink);
    long long h[132];
    if (cudaMemcpy(h, cycles, sizeof(h), cudaMemcpyDeviceToHost) != cudaSuccess) return 1;
    long long sum = 0;
    for (int b = 0; b < 132; ++b) sum += h[b];
    printf("%%.4f\n", double(sum) / 132 / (%(warps)d.0 * %(iters)d * %(unroll)d));
  }
  return 0;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("smem_load_bench: no nvcc", file=sys.stderr)
        return 1
    out = ROOT / "build" / "repro_torch"
    out.mkdir(parents=True, exist_ok=True)
    cases = "\n".join(f"    case {i}: off = {expr}; break;" for i, (expr, _) in enumerate(PATTERNS.values()))
    src = out / "smem_load_bench.cu"
    src.write_text(SOURCE % dict(cases=cases, unroll=UNROLL, iters=ITERS, threads=32 * WARPS, warps=WARPS,
                                 n=len(PATTERNS)))
    exe = out / "smem_load_bench"
    subprocess.run([nvcc, "-O3", "-gencode=arch=compute_90a,code=sm_90a", "-diag-suppress=550", "-o", str(exe), str(src)],
                   check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    if run.returncode != 0:
        print(f"smem_load_bench: the benchmark failed (no GPU?)\n{run.stdout}{run.stderr}", file=sys.stderr)
        return 1
    cycles = [float(x) for x in run.stdout.split()]
    print(json.dumps({"sm_cycles_per_warp_load": dict(zip(PATTERNS, cycles)),
                      "patterns": {k: d for k, (_, d) in PATTERNS.items()},
                      "load": "ld.volatile.shared.v4.f32, 8 warps a block, one block an SM"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
