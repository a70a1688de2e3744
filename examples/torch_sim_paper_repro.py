"""Paper reproduction demo: the three Accel-Sim builds from one simulator,
driven through the stable ``repro_torch.api`` facade (the PyTorch/CUDA port).

    PYTHONPATH=src python examples/torch_sim_paper_repro.py
    PYTHONPATH=src python examples/torch_sim_paper_repro.py --device cpu

Runs the §5.1 four-stream l2_lat microbenchmark under
  (a) tip            — per-stream stats, concurrent streams,
  (b) clean          — baseline aggregation with its undercount bug,
  (c) tip_serialized — the paper's busy_streams.size()==0 patch,
prints the per-stream breakdowns (StatsFrame queries), kernel timelines, and
the validation comparisons from Figure 2.  The stat landings run through
the CUDA segment-scatter kernel (``array_backend="torch"``) unless
``--device cpu`` is given (``"torch:cpu"``, its plain version).
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch import simulate
from repro_torch.sim import l2_lat_expected_counts

OUTS = ("HIT", "MSHR_HIT", "MISS")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    config = {"array_backend": "torch" if args.device == "cuda" else f"torch:{args.device}"}

    n_streams, n_loads = 4, 256
    print(f"== l2_lat x {n_streams} streams, {n_loads} dependent loads each ==")
    print(f"closed-form expectation: {l2_lat_expected_counts(n_streams, n_loads)}\n")

    tip = simulate("l2_lat", config=config, n_streams=n_streams, n_loads=n_loads)
    ser = simulate("l2_lat", config=config, n_streams=n_streams, n_loads=n_loads, serialize=True)
    assert tip.check_oracle()["ok"] and ser.check_oracle()["ok"]

    print("-- tip (per-stream stats, concurrent) --")
    rows, cols, table = tip.frame.filter(access_type="GLOBAL_ACC_R").pivot(
        rows="stream", cols="outcome"
    )
    widths = [max(len(c), 8) for c in cols]
    print(f"  {'stream':10s} " + " ".join(f"{c:>{w}s}" for c, w in zip(cols, widths)))
    for name, row in zip(rows, table):
        print(f"  {str(name):10s} " + " ".join(f"{v:>{w}d}" for v, w in zip(row, widths)))
    print("\ntimeline (concurrent):")
    print(tip.timeline.ascii_timeline(64))

    print("\n-- clean (baseline build: one aggregate, same-cycle lost updates) --")
    clean = tip.frame.filter(view="clean", access_type="GLOBAL_ACC_R")
    clean_counts = {name: clean.filter(outcome=name).sum() for name in OUTS}
    for name, v in clean_counts.items():
        print(f"  clean[GLOBAL_ACC_R][{name}] = {v}")
    print(f"  lost updates: {tip.clean.lost_updates}")

    print("\n-- tip_serialized (busy_streams patch) --")
    ser_f = ser.frame.filter(access_type="GLOBAL_ACC_R")
    for name in OUTS:
        print(f"  serialized[GLOBAL_ACC_R][{name}] = {ser_f.filter(outcome=name).sum()}")
    print("timeline (serialized):")
    print(ser.timeline.ascii_timeline(64))

    print("\n== Figure-2 comparisons ==")
    tip_f = tip.frame.filter(access_type="GLOBAL_ACC_R")
    print(f"  clean == sum(tip) per cell: "
          f"{all(clean_counts[o] == tip_f.filter(outcome=o).sum() for o in OUTS)}")
    ser_hits = ser_f.filter(outcome="HIT").sum()
    tip_hits = tip_f.filter(outcome="HIT").sum()
    print(f"  serialized HITs ({ser_hits}) > concurrent HITs ({tip_hits}): "
          f"{ser_hits > tip_hits}")
    print(f"  concurrent makespan {tip.cycles} vs serialized {ser.cycles} cycles")


if __name__ == "__main__":
    main()
