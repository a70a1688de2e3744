"""Multi-stream serving with per-request stat tracking, through the stable
``repro_torch.api`` facade (the PyTorch/CUDA port).

    PYTHONPATH=src python examples/torch_multistream_serve.py
    PYTHONPATH=src python examples/torch_multistream_serve.py --device cpu

Heterogeneous requests share a continuous-batching engine; each request is
a stream, and the engine reports per-stream prefill/decode latency, token
counts, and KV-cache bytes (a StatsFrame query) — then shows the
aggregate-only view the paper argues is insufficient.  The model runs on
the GPU (prefill through the flash kernel) unless ``--device cpu`` is
given.
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch.api import ServeConfig, ServeEngine, ServeRequest  # lazy model-backed names
from repro_torch.configs import get_smoke_config
from repro_torch.models import Transformer

PROFILES = [(8, 4), (8, 32), (16, 8), (24, 16), (8, 8), (16, 24), (8, 16), (12, 6)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=len(PROFILES),
                    help="how many of the request profiles to submit")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config("deepseek-7b")
    model = Transformer(cfg, device=args.device, seed=0)
    eng = ServeEngine(model, ServeConfig(n_slots=args.slots, max_len=args.max_len))

    rng = np.random.default_rng(0)
    reqs = []
    for i, (plen, gen) in enumerate(PROFILES[: args.requests]):
        r = ServeRequest(
            prompt=rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32),
            max_new_tokens=gen,
            name=f"req{i}",
            tenant="online" if i % 2 == 0 else "batch",
        )
        reqs.append(r)
        eng.submit(r)

    eng.run_until_idle()

    print("per-stream report (the paper's feature):")
    report = eng.per_stream_report()
    for r in reqs:
        s = report[r.stream_id]
        print(f"  {r.name:6s} stream={r.stream_id:2d} prompt={len(r.prompt):3d} "
              f"generated={len(r.generated):3d} prefill={r.prefill_s*1e3:8.1f}ms "
              f"decode={r.decode_s*1e3:8.1f}ms kv_bytes={int(s['kv_bytes']):8d}")

    # StatsFrame query over the engine's per-stream byte table vs the legacy
    # accessor path (per_stream_report → table.get): two independent read
    # paths over the same store must agree, per stream and in aggregate.
    frame = eng.frame.filter(access_type="KV_ACC_W")
    total = frame.sum()
    print(f"\naggregate-only view (what unmodified stat tracking reports): "
          f"kv_bytes={total} — per-request behaviour invisible")
    legacy_total = sum(int(v["kv_bytes"]) for v in report.values())
    print(f"invariant Σ per-stream (legacy accessors) == aggregate (frame): "
          f"{legacy_total == total}")

    # tenant is a first-class frame axis: KV demand and the SLO lanes
    # (TTFT/latency/tokens) roll up per tenant with one groupby.
    print("\nper-tenant rollup (frame.groupby('tenant')):")
    for tenant, sub in sorted(eng.frame.groupby("tenant").frames().items()):
        kv = sub.filter(access_type="KV_ACC_W").sum()
        toks = sub.filter(access_type="SLO", outcome="TOKENS_OUT").sum()
        print(f"  {tenant:6s} requests={len(sub.streams()):2d} "
              f"kv_bytes={int(kv):8d} tokens_out={int(toks):4d}")


if __name__ == "__main__":
    main()
