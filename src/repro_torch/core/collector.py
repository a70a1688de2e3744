"""Cross-host aggregation of per-stream stats (multi-pod posture).

On a real multi-pod deployment every host process owns a local
:class:`StatTable`; global reports need a merge that (a) preserves the stream
dimension — the whole point of the paper — and (b) does not force stream-id
collisions between tenants on different pods.

Stream ids are namespaced as ``global_id = host_id * STRIDE + local_id`` when
``namespace_streams=True`` (multi-tenant: each pod's streams are distinct),
or kept as-is when the same logical stream spans pods (data-parallel
replicas of one training stream).

The container is single-process; the gather path degrades to a local no-op
but is exercised by tests via explicit multi-table merges, and the interface
matches what a ``jax.distributed`` deployment would call on each host.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .stats import StatTable

__all__ = ["StatCollector", "namespace_stream", "split_namespaced"]

#: Max streams per host before ids would collide across hosts.
STREAM_NAMESPACE_STRIDE = 1 << 20


def namespace_stream(host_id: int, local_stream_id: int) -> int:
    if not (0 <= local_stream_id < STREAM_NAMESPACE_STRIDE):
        raise ValueError(f"local stream id {local_stream_id} out of range")
    return host_id * STREAM_NAMESPACE_STRIDE + local_stream_id


def split_namespaced(global_stream_id: int) -> tuple:
    return divmod(global_stream_id, STREAM_NAMESPACE_STRIDE)


class StatCollector:
    """Merges per-host :class:`StatTable` snapshots into a global view."""

    def __init__(self, host_id: int = 0, n_hosts: int = 1, namespace_streams: bool = False) -> None:
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.namespace_streams = namespace_streams

    # -- local → wire -----------------------------------------------------------
    def snapshot(self, table: StatTable) -> str:
        """Serialise the local table (optionally stream-namespaced) to JSON.

        Accepts a plain :class:`StatTable` or anything exposing
        ``as_stat_table()`` (e.g. :class:`repro.core.engine.StatsEngine`)."""
        if hasattr(table, "as_stat_table"):
            table = table.as_stat_table()
        if self.namespace_streams:
            remapped = StatTable(table._n_types, table._n_outcomes, table._n_fail, table.name)
            for store_name in ("_stats", "_stats_pw", "_fail_stats"):
                src = getattr(table, store_name)
                dst = getattr(remapped, store_name)
                for sid, m in src.items():
                    dst[namespace_stream(self.host_id, sid)] = m.copy()
            table = remapped
        return json.dumps(table.to_dict())

    # -- wire → global -----------------------------------------------------------
    @staticmethod
    def combine(snapshots: Sequence[str]) -> StatTable:
        """Merge JSON snapshots from every host into one global table."""
        if not snapshots:
            raise ValueError("no snapshots to combine")
        tables = [StatTable.from_dict(json.loads(s)) for s in snapshots]
        out = tables[0]
        for t in tables[1:]:
            out.merge(t)
        return out

    def all_gather_and_combine(self, table: StatTable) -> StatTable:
        """Single-process degenerate gather (multi-host would exchange the
        JSON snapshots over the control plane — e.g. jax.distributed KV store
        or the launcher's rendezvous — and call :meth:`combine`)."""
        return self.combine([self.snapshot(table)])
