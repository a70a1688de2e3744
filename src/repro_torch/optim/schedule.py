"""LR schedules (pure functions of the step index)."""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["ScheduleConfig", "learning_rate"]


@dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    kind: str = "cosine"  # cosine | linear | constant


def learning_rate(step, cfg: ScheduleConfig) -> float:
    """The reference's schedule (``optim/schedule.py:21``): linear warm-up to
    ``peak_lr``, then cosine or linear decay to ``min_lr_ratio · peak_lr`` at
    ``decay_steps``.  Computed in Python floats (the reference in fp32)."""
    s = float(step)
    warm = cfg.peak_lr * min(1.0, (s + 1.0) / max(cfg.warmup_steps, 1))
    if cfg.kind == "constant" or s < cfg.warmup_steps:
        return warm
    t = min(max((s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    if cfg.kind == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * t
    else:  # cosine
        decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * 0.5 * (1.0 + math.cos(math.pi * t))
    return cfg.peak_lr * decay
