"""Deterministic, restart-safe data pipeline (a copy of the reference's
framework-free NumPy pipeline, so batch ``i`` is bit-identical)."""

from .pipeline import DataConfig, Prefetcher, SyntheticLM, TokenFileSource, make_train_iter

__all__ = ["DataConfig", "SyntheticLM", "TokenFileSource", "Prefetcher", "make_train_iter"]
