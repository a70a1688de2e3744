"""Serving: KV caches, continuous batching, per-stream/tenant request stats."""

from .cache_utils import cache_bytes, transplant
from .engine import Engine, Request, ServeConfig
from .loadgen import LoadReport, LoadSpec, TenantSpec, generate_load, replay_load, slo_report

__all__ = [
    "cache_bytes",
    "transplant",
    "Engine",
    "Request",
    "ServeConfig",
    "LoadReport",
    "LoadSpec",
    "TenantSpec",
    "generate_load",
    "replay_load",
    "slo_report",
]
