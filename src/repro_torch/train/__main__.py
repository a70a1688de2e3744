"""End-to-end run: train a ~100M-parameter LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.train --steps 300

The torch counterpart of ``examples/train_100m.py``, with its flags and
defaults: config → data pipeline (deterministic, restart-safe) → microbatch
train step → AdamW + cosine → async checkpoints → per-stream telemetry.
Resumable: re-running the same command continues from the last committed
checkpoint.  The model is mamba2-130m at its published shape (bf16 compute,
fp32 parameters), or the config ``--config`` names; ``--small`` takes its
smoke config.  An encoder-decoder config (whisper-medium) trains on
seeded stub frame embeddings, ``ENC_LEN`` a row, a VLM (paligemma-3b) on
its ``vision_tokens`` stub patch embeddings before each row's tokens.
It runs on the card unless ``--device cpu`` is given, where the full shape
computes in fp32 as the reference's CPU run does.
"""

from __future__ import annotations

import argparse
from dataclasses import replace

from ..ckpt import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import DataConfig, make_train_iter
from ..optim import AdamWConfig, ScheduleConfig
from .trainer import TrainConfig, Trainer

#: an encoder-decoder config's stub frame embeddings a row: whisper's 30 s of audio after its conv front end
ENC_LEN = 1500


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="artifacts/train_100m_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--small", action="store_true", help="reduced width for quick runs")
    ap.add_argument("--config", default="mamba2-130m", help="the model config to train")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.config) if args.small else get_config(args.config)
    if not args.small and args.device == "cpu":
        cfg = replace(cfg, compute_dtype="float32")  # CPU host run, as the reference's
    tcfg = TrainConfig(
        adamw=AdamWConfig(weight_decay=0.1, grad_clip=1.0),
        schedule=ScheduleConfig(peak_lr=6e-4, warmup_steps=20, decay_steps=args.steps),
        microbatches=2,
    )
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                      enc_len=ENC_LEN if cfg.encdec else 0, vision_tokens=cfg.vision_tokens)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    trainer = Trainer(cfg, tcfg, make_train_iter(dcfg), ckpt_manager=ckpt, ckpt_every=args.ckpt_every,
                      device=args.device)
    model, opt = trainer.restore_or_init()
    if trainer.step:
        print(f"resumed from checkpoint at step {trainer.step}")
        trainer.data_iter.close()
        trainer.data_iter = make_train_iter(dcfg, start_index=trainer.step)

    n_params = sum(p.numel() for p in model.parameters())
    print(f"training {cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch={args.batch}x{args.seq}, {args.steps} steps on {args.device}")

    remaining = max(0, args.steps - trainer.step)
    model, opt, hist = trainer.run(model, opt, remaining)
    ckpt.wait()

    if hist:
        k = max(1, len(hist) // 10)
        first = sum(h["loss"] for h in hist[:k]) / k
        last = sum(h["loss"] for h in hist[-k:]) / k
        print(f"\nloss: first-{k}-avg={first:.4f} → last-{k}-avg={last:.4f}")
    print("\nper-stream summary:")
    trainer.stats.print_summary()
    trainer.data_iter.close()


if __name__ == "__main__":
    main()
