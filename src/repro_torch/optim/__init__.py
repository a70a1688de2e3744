"""AdamW, the learning-rate schedule and int8 gradient compression, as functions on tensors."""

from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, global_norm
from .grad_compress import dequantize_int8, ef_compress, ef_state_init, quantize_int8, wire_bytes
from .schedule import ScheduleConfig, learning_rate

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "clip_by_global_norm",
    "ScheduleConfig",
    "learning_rate",
    "dequantize_int8",
    "ef_compress",
    "ef_state_init",
    "quantize_int8",
    "wire_bytes",
]
