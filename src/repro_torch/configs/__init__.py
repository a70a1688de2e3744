"""Architecture configs — the 10 assigned architectures (+ reduced smokes)."""

from .base import (
    ARCH_IDS,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    SHAPES,
    ShapeConfig,
    applicable_shapes,
    get_config,
    get_smoke_config,
    list_archs,
    torch_dtype,
)

__all__ = [
    "ARCH_IDS",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "SSMConfig",
    "SHAPES",
    "ShapeConfig",
    "applicable_shapes",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "torch_dtype",
]
