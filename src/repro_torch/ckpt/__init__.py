"""Async, atomic checkpoints of the port's parameter and optimizer trees."""

from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
