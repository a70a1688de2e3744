"""Quickstart: train a small LM with per-stream stat tracking, through the
stable ``repro_torch.api`` facade (the PyTorch/CUDA port).

    PYTHONPATH=src python examples/torch_quickstart.py --steps 20
    PYTHONPATH=src python examples/torch_quickstart.py --steps 4 --device cpu

Runs a reduced deepseek-7b-family model on synthetic data with the train
and eval lanes tracked as separate streams (the paper's feature at the
framework layer), then prints the per-stream summary and a StatsFrame
query over the byte-attribution table.  It runs on the GPU unless
``--device cpu`` is given.
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.api import Trainer, TrainConfig  # model-backed names resolve lazily
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, make_train_iter


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    tcfg = TrainConfig(microbatches=2)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size)
    train_it = make_train_iter(dcfg)
    eval_it = make_train_iter(DataConfig(
        global_batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size, seed=99,
    ))

    trainer = Trainer(cfg, tcfg, train_it, eval_iter=eval_it, eval_every=5, device=args.device)
    model, opt = trainer.restore_or_init()
    model, opt, hist = trainer.run(model, opt, args.steps)

    print(f"\nloss: first={hist[0]['loss']:.3f} last={hist[-1]['loss']:.3f}")
    print("\nper-stream summary (train and eval lanes tracked separately):")
    trainer.stats.print_summary()

    # The same data as a StatsFrame query — per-lane HBM byte attribution.
    frame = trainer.frame()
    print("per-lane HBM bytes (StatsFrame query):")
    for lane in ("train", "eval"):
        per_lane = frame.filter(stream=lane, access_type="GLOBAL_ACC_R").sum()
        print(f"  {lane:5s} {per_lane:>16d}")
    train_it.close()
    eval_it.close()


if __name__ == "__main__":
    main()
