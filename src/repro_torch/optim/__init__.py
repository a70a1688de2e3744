"""AdamW and the learning-rate schedule, as functions on tensors."""

from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm
from .schedule import ScheduleConfig, learning_rate

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "clip_by_global_norm",
    "ScheduleConfig",
    "learning_rate",
]
