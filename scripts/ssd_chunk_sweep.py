#!/usr/bin/env python3
"""The bf16 SSD kernel's time at each chunk length it may take.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/ssd_chunk_sweep.py

The tensor-core SSD kernel passes its state between its kernels once per
chunk of 1 to 8 tiles of 64 rows, and ``ssd_scan.tiles_per_chunk`` picks
the chunk from the shape.  At ``chip_smoke.py``'s timed shapes (mamba2-130m's
SSD width, B=4 S=256 and B=1 S=4096; jamba's, head dim 128, B=1 at S=132 and
S=404; bf16, the same seeded inputs) this times the kernel with each chunk
length forced, interleaved in one process as ``chip_smoke.py`` times it
(CUDA-graph replay between CUDA events), and prints one JSON line per shape
with the median ms per chunk length and the one the wrapper picks.  Exits
non-zero without a GPU.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_chunk_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import ssd_scan as sk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    picks = sk.tiles_per_chunk
    shapes = [(B, S, *chip_smoke.SSD_WIDTH, 500 + S) for B, S in chip_smoke.SSD_TIMED]
    shapes += [(1, S, *chip_smoke.JAMBA_SSD_WIDTH, 700 + S) for S in chip_smoke.P128_TIMED]
    for B, S, H, P, N, G, seed in shapes:
        x, dt, A, Bm, Cm, D, _ = chip_smoke._ssd_inputs(B, S, H, P, N, G, torch.bfloat16, seed)

        def forced(q):
            def run():
                sk.tiles_per_chunk = lambda *_: q
                try:
                    return sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256)
                finally:
                    sk.tiles_per_chunk = picks
            return run

        n_tiles = -(-S // sk.TILE)
        qs = sorted({q for q in (1, 2, 3, 4, 6, 8) if q < n_tiles} | {min(n_tiles, sk.MAX_CHUNK_TILES)})
        ms = chip_smoke.time_interleaved({f"q{q}": forced(q) for q in qs})
        print(json.dumps({"B": B, "S": S, "H": H, "P": P, "N": N, "device": torch.cuda.get_device_name(0),
                          "picked": picks(B, H, S, sms, P),
                          "median_ms": {k: v["median"] for k, v in ms.items()},
                          "spread_ms": {k: [v["min"], v["max"]] for k, v in ms.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
