"""Per-stream statistic tables — the paper's core contribution (§3.1).

Accel-Sim stores cache statistics as ``vector<vector<u64>>`` indexed by
``(access_type, access_outcome)`` and *aggregates across all concurrently
running streams*.  The paper re-keys those stores by stream::

    std::map<unsigned long long,                       // streamID
             std::vector<std::vector<unsigned long long>>> m_stats;

and threads a required ``streamID`` argument through every mutator and
accessor (``inc_stats``, ``inc_stats_pw``, ``inc_fail_stats``,
``operator()``, ``print_stats``).

This module is the JAX-framework translation of that change:

* :class:`StatTable`   — the per-stream ("tip") table.  One dense
  ``(n_access_types, n_outcomes)`` uint64 matrix *per stream*, created lazily
  on first increment, exactly like ``std::map::operator[]``.
* :class:`CleanStatTable` — the *baseline* Accel-Sim behaviour, including its
  same-cycle undercounting bug (§5.2): when two streams increment the same
  ``(type, outcome)`` cell in the same cycle, the clean codebase counts it
  once.  The paper validates against this baseline, so we implement it too.
* per-window (``_pw``) and failure tables mirror ``m_stats_pw`` /
  ``m_fail_stats``.

On TPU the access types/outcomes describe the HBM→VMEM software-managed
hierarchy rather than a hardware L1/L2 (see docs/DESIGN.md §2), but the
classification structure is byte-for-byte the paper's.

For the hot path, :class:`repro.core.engine.StatsEngine` provides vectorized
batch ingestion over these same tables (see docs/DESIGN.md §4); the classes
here remain the reference semantics it is validated against.
"""

from __future__ import annotations

import enum
import sys
from dataclasses import dataclass, field
from typing import IO, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

__all__ = [
    "AccessType",
    "AccessOutcome",
    "FailOutcome",
    "StatTable",
    "CleanStatTable",
    "DEFAULT_STREAM",
    "format_breakdown",
]

#: CUDA's default stream is 0; we keep the same convention.
DEFAULT_STREAM: int = 0


class AccessType(enum.IntEnum):
    """Memory-system access types (Accel-Sim's ``mem_access_type`` analog).

    GPU original                 →  TPU meaning here
    ----------------------------------------------------------------
    GLOBAL_ACC_R / GLOBAL_ACC_W  →  generic HBM read / write
    CONST_ACC_R (params)         →  parameter read (weights)
    TEXTURE/other specialised    →  KV-cache read / write (serving)
    (no GPU analog)              →  ICI send / receive (collectives)
    L1_WRBK_ACC                  →  VMEM spill writeback
    """

    GLOBAL_ACC_R = 0
    GLOBAL_ACC_W = 1
    PARAM_ACC_R = 2
    KV_ACC_R = 3
    KV_ACC_W = 4
    ICI_SND = 5
    ICI_RCV = 6
    VMEM_WRBK = 7
    #: stream-buffer prefetch traffic (one event per prefetched line),
    #: attributed to the stream whose demand miss triggered the prefetch —
    #: this row is *traffic*, not demand, so demand-side views exclude it
    PREFETCH = 8
    #: fault-injection bookkeeping (``FaultPlan``, see docs/DESIGN.md §5.11):
    #: every injected fault and recovery action lands on this row, in one of
    #: the fault outcome columns below — like PREFETCH, this row is not
    #: demand traffic and demand-side views exclude it
    FAULT = 9
    #: serve-layer SLO observability (docs/DESIGN.md §5.12): per-request
    #: latency/throughput quantities recorded once per request lifecycle
    #: event on the request's stream (``TTFT_US`` at prefill completion,
    #: ``LATENCY_US`` + ``TOKENS_OUT`` at retirement).  Counts on this row
    #: are microseconds/tokens, not accesses — like PREFETCH and FAULT it is
    #: excluded from every demand-side view
    SLO = 10
    #: inter-chip link traversal in a multi-device topology (docs/DESIGN.md
    #: §5.14): one event per link hop of a routed ICI transfer, attributed to
    #: the sending stream.  The demand transfer itself is the ICI_SND row;
    #: this row is per-hop *link traffic* — like PREFETCH, FAULT and SLO it
    #: is excluded from every demand-side view
    ICI_HOP = 11

    @classmethod
    def count(cls) -> int:
        return len(cls)


class AccessOutcome(enum.IntEnum):
    """Access outcomes (Accel-Sim's ``cache_request_status`` analog).

    HIT           — line resident in VMEM (reuse window)
    HIT_RESERVED  — merged onto an in-flight HBM fetch; printed as MSHR_HIT,
                    matching the paper's figures
    MISS          — HBM fetch issued
    RESERVATION_FAILURE — VMEM capacity / MSHR-table full; access must retry
    SECTOR_MISS   — partial-line fetch (kept for table parity; the TPU model
                    fetches whole 512B lines so this stays 0 unless a
                    workload issues sub-line accesses)

    Miss-path mechanism outcomes (``SimConfig.miss_mechanism``, see
    docs/DESIGN.md §5.10) — each counts an access the main array missed but
    a mechanism structure satisfied, so a demand access lands in exactly one
    of {HIT, HIT_RESERVED, MISS, VICTIM_HIT, MISS_CACHE_HIT, PREFETCH_HIT}
    per successful issue (RESERVATION_FAILURE retries):

    VICTIM_HIT      — found in the victim cache (recently evicted line)
    MISS_CACHE_HIT  — found in the miss cache (recently missed line)
    PREFETCH_HIT    — matched the head of a stream buffer (prefetched line)

    Fault-attribution outcomes (``repro.core.faults.FaultPlan``, see
    docs/DESIGN.md §5.11) — recorded on the :data:`AccessType.FAULT` row,
    one event per fault/recovery action, attributed to the faulted stream.
    The conservation oracle relies on each injected fault resolving in
    exactly one of these lanes:

    KERNEL_ABORT    — a kernel was killed mid-run (its remaining work
                      discarded; the kernel still retires and is timed)
    RETRY           — one retry attempt (a shed request re-enqueued after
                      backoff; a pool job re-executed after a worker fault)
    TIMEOUT_EXPIRED — a deadline/timeout fired (serve request past its
                      deadline; pool job past its per-job timeout)
    SHED            — load shed: admission-overflow eviction or client
                      cancellation (serve), or a pool job dropped after its
                      retry budget
    RECOVERED       — a faulted entity completed anyway (slowdown window
                      ended / stall burst drained / abort armed after the
                      kernel already finished; retried request or pool job
                      that ultimately succeeded)

    Serve-layer SLO outcomes (recorded on the :data:`AccessType.SLO` row by
    :class:`repro.serve.engine.Engine`, see docs/DESIGN.md §5.12) — counts
    are quantities, not accesses, so per-tenant SLO rollups are plain
    :class:`~repro.core.query.StatsFrame` queries:

    TTFT_US         — time-to-first-token in microseconds, recorded once
                      when a request's prefill completes (its first token)
    LATENCY_US      — request latency in microseconds (submit → terminal
                      disposition), recorded once at retirement for every
                      terminal status
    TOKENS_OUT      — generated tokens, recorded once at retirement for
                      successfully completed (``status == "done"``) requests
                      only, so per-tenant goodput is this column's sum
    """

    HIT = 0
    HIT_RESERVED = 1  # printed as MSHR_HIT
    MISS = 2
    RESERVATION_FAILURE = 3
    SECTOR_MISS = 4
    VICTIM_HIT = 5
    MISS_CACHE_HIT = 6
    PREFETCH_HIT = 7
    KERNEL_ABORT = 8
    RETRY = 9
    TIMEOUT_EXPIRED = 10
    SHED = 11
    RECOVERED = 12
    TTFT_US = 13
    LATENCY_US = 14
    TOKENS_OUT = 15

    @classmethod
    def count(cls) -> int:
        return len(cls)


#: Display names matching the paper's figure labels.
_OUTCOME_NAMES = {
    AccessOutcome.HIT: "HIT",
    AccessOutcome.HIT_RESERVED: "MSHR_HIT",
    AccessOutcome.MISS: "MISS",
    AccessOutcome.RESERVATION_FAILURE: "RESERVATION_FAIL",
    AccessOutcome.SECTOR_MISS: "SECTOR_MISS",
    AccessOutcome.VICTIM_HIT: "VICTIM_HIT",
    AccessOutcome.MISS_CACHE_HIT: "MISS_CACHE_HIT",
    AccessOutcome.PREFETCH_HIT: "PREFETCH_HIT",
    AccessOutcome.KERNEL_ABORT: "KERNEL_ABORT",
    AccessOutcome.RETRY: "RETRY",
    AccessOutcome.TIMEOUT_EXPIRED: "TIMEOUT_EXPIRED",
    AccessOutcome.SHED: "SHED",
    AccessOutcome.RECOVERED: "RECOVERED",
    AccessOutcome.TTFT_US: "TTFT_US",
    AccessOutcome.LATENCY_US: "LATENCY_US",
    AccessOutcome.TOKENS_OUT: "TOKENS_OUT",
}


class FailOutcome(enum.IntEnum):
    """Reservation-failure reasons (``cache_reservation_fail_reason`` analog)."""

    LINE_ALLOC_FAIL = 0
    MSHR_ENTRY_FAIL = 1
    MSHR_MERGE_FAIL = 2
    BANDWIDTH_FAIL = 3

    @classmethod
    def count(cls) -> int:
        return len(cls)


def _new_matrix(n_rows: int, n_cols: int) -> np.ndarray:
    return np.zeros((n_rows, n_cols), dtype=np.uint64)


def _type_name(t: int) -> str:
    return AccessType(t).name if t < AccessType.count() else f"TYPE_{t}"


def _outcome_name(o: int, *, fail: bool = False) -> str:
    if fail:
        return FailOutcome(o).name if o < FailOutcome.count() else f"FAIL_{o}"
    if o < AccessOutcome.count():
        return _OUTCOME_NAMES.get(AccessOutcome(o), f"OUT_{o}")
    return f"OUT_{o}"


# Name lookups are on the kernel-exit report path (once per cell); memoize.
_TYPE_NAME_CACHE: Dict[int, str] = {}
_OUTCOME_NAME_CACHE: Dict[Tuple[int, bool], str] = {}


def _type_name_cached(t: int) -> str:
    s = _TYPE_NAME_CACHE.get(t)
    if s is None:
        s = _TYPE_NAME_CACHE[t] = _type_name(t)
    return s


def _outcome_name_cached(o: int, fail: bool) -> str:
    s = _OUTCOME_NAME_CACHE.get((o, fail))
    if s is None:
        s = _OUTCOME_NAME_CACHE[(o, fail)] = _outcome_name(o, fail=fail)
    return s


def format_breakdown(name: str, stream_id: int, matrix: np.ndarray, *, fail: bool = False) -> str:
    """Render one stream's ``(T, O)`` count matrix in the canonical per-kernel
    exit format (the paper's ``print_stats`` output).

    This is the single source of truth for that format: both the legacy
    :meth:`StatTable.print_stats` path and the sink subsystem's text sink
    (:class:`repro.core.sinks.TextSink`) call it, so their output is
    byte-identical by construction.
    """
    lines = [f"{name}_breakdown (stream {stream_id}):"]
    rows = matrix.tolist()  # one bulk conversion beats per-cell item() calls
    for t, row in enumerate(rows):
        tname = _type_name_cached(t)
        for o, v in enumerate(row):
            if v:
                lines.append(f"\t{name}[{tname}][{_outcome_name_cached(o, fail)}] = {v}")
    return "\n".join(lines) + "\n"


class StatTable:
    """Per-stream stat store — the paper's modified ``cache_stats``.

    The three stores mirror the paper's ``m_stats`` (cumulative),
    ``m_stats_pw`` (per-window, cleared at window boundaries) and
    ``m_fail_stats``.  Each is ``dict[streamID] -> (T, O) uint64``.
    """

    def __init__(
        self,
        n_types: int = AccessType.count(),
        n_outcomes: int = AccessOutcome.count(),
        n_fail: int = FailOutcome.count(),
        name: str = "Cache_stats",
    ) -> None:
        self.name = name
        self._n_types = int(n_types)
        self._n_outcomes = int(n_outcomes)
        self._n_fail = int(n_fail)
        self._stats: Dict[int, np.ndarray] = {}
        self._stats_pw: Dict[int, np.ndarray] = {}
        self._fail_stats: Dict[int, np.ndarray] = {}

    # -- lazy per-stream allocation (std::map::operator[] semantics) --------
    def _row(self, store: Dict[int, np.ndarray], stream_id: int, n_cols: int) -> np.ndarray:
        m = store.get(stream_id)
        if m is None:
            m = _new_matrix(self._n_types, n_cols)
            store[stream_id] = m
        return m

    # -- mutators (paper §3.1 "After" signatures) ----------------------------
    def inc_stats(self, access_type: int, access_outcome: int, stream_id: int, n: int = 1) -> None:
        self._row(self._stats, stream_id, self._n_outcomes)[access_type, access_outcome] += np.uint64(n)

    def inc_stats_pw(self, access_type: int, access_outcome: int, stream_id: int, n: int = 1) -> None:
        self._row(self._stats_pw, stream_id, self._n_outcomes)[access_type, access_outcome] += np.uint64(n)

    def inc_fail_stats(self, access_type: int, fail_outcome: int, stream_id: int, n: int = 1) -> None:
        self._row(self._fail_stats, stream_id, self._n_fail)[access_type, fail_outcome] += np.uint64(n)

    # -- accessors -----------------------------------------------------------
    def __call__(self, access_type: int, outcome: int, fail_outcome: bool, stream_id: int) -> int:
        """``operator()(type, outcome, fail_outcome, streamID)`` analog."""
        store = self._fail_stats if fail_outcome else self._stats
        m = store.get(stream_id)
        return 0 if m is None else int(m[access_type, outcome])

    def get(self, access_type: int, outcome: int, stream_id: int) -> int:
        return self(access_type, outcome, False, stream_id)

    def stream_matrix(self, stream_id: int, *, pw: bool = False, fail: bool = False) -> np.ndarray:
        store = self._fail_stats if fail else (self._stats_pw if pw else self._stats)
        m = store.get(stream_id)
        n_cols = self._n_fail if fail else self._n_outcomes
        return m.copy() if m is not None else _new_matrix(self._n_types, n_cols)

    def streams(self) -> Tuple[int, ...]:
        ids = set(self._stats) | set(self._stats_pw) | set(self._fail_stats)
        return tuple(sorted(ids))

    # -- aggregation (what the *clean* output reports, minus its bug) --------
    def aggregate(self, *, pw: bool = False, fail: bool = False) -> np.ndarray:
        """Sum over streams — the paper's validation invariant is
        ``clean == aggregate(tip)`` when no same-cycle collisions occur."""
        store = self._fail_stats if fail else (self._stats_pw if pw else self._stats)
        n_cols = self._n_fail if fail else self._n_outcomes
        out = _new_matrix(self._n_types, n_cols)
        for m in store.values():
            out += m
        return out

    def total_accesses(self, stream_id: Optional[int] = None) -> int:
        if stream_id is None:
            return int(self.aggregate().sum())
        return int(self.stream_matrix(stream_id).sum())

    # -- windows --------------------------------------------------------------
    def clear_pw(self) -> None:
        """End-of-window clear (Accel-Sim clears ``m_stats_pw`` each window)."""
        for m in self._stats_pw.values():
            m[...] = 0

    def clear(self) -> None:
        self._stats.clear()
        self._stats_pw.clear()
        self._fail_stats.clear()

    # -- distributed merge (multi-pod aggregation; see core/collector.py) -----
    def merge(self, other: "StatTable") -> None:
        if (other._n_types, other._n_outcomes, other._n_fail) != (
            self._n_types,
            self._n_outcomes,
            self._n_fail,
        ):
            raise ValueError("StatTable shape mismatch in merge")
        for src, dst in (
            (other._stats, self._stats),
            (other._stats_pw, self._stats_pw),
            (other._fail_stats, self._fail_stats),
        ):
            for sid, m in src.items():
                cur = dst.get(sid)
                if cur is None:
                    dst[sid] = m.copy()
                else:
                    cur += m

    # -- (de)serialisation (telemetry checkpoints) -----------------------------
    def to_dict(self) -> dict:
        def enc(store: Dict[int, np.ndarray]) -> dict:
            return {str(sid): m.tolist() for sid, m in store.items()}

        return {
            "name": self.name,
            "n_types": self._n_types,
            "n_outcomes": self._n_outcomes,
            "n_fail": self._n_fail,
            "stats": enc(self._stats),
            "stats_pw": enc(self._stats_pw),
            "fail_stats": enc(self._fail_stats),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StatTable":
        t = cls(d["n_types"], d["n_outcomes"], d["n_fail"], d.get("name", "Cache_stats"))

        def dec(store: Dict[int, np.ndarray], src: Mapping[str, list]) -> None:
            for sid, rows in src.items():
                store[int(sid)] = np.asarray(rows, dtype=np.uint64)

        dec(t._stats, d["stats"])
        dec(t._stats_pw, d["stats_pw"])
        dec(t._fail_stats, d["fail_stats"])
        return t

    # -- printing (paper §3.1: print only the exiting kernel's stream) --------
    def print_stats(
        self,
        fout: IO[str] = sys.stdout,
        stream_id: int = DEFAULT_STREAM,
        cache_name: Optional[str] = None,
    ) -> None:
        """``print_stats(FILE*, streamID, name)`` analog — prints only the
        given stream's breakdown (the paper's fix for the redundant
        all-stream dump on every kernel exit)."""
        name = cache_name or self.name
        fout.write(format_breakdown(name, stream_id, self.stream_matrix(stream_id)))

    def print_fail_stats(
        self,
        fout: IO[str] = sys.stdout,
        stream_id: int = DEFAULT_STREAM,
        cache_name: Optional[str] = None,
    ) -> None:
        name = cache_name or f"{self.name}_fail"
        fout.write(format_breakdown(name, stream_id, self.stream_matrix(stream_id, fail=True), fail=True))


class CleanStatTable:
    """The *unpatched* Accel-Sim behaviour (the paper's ``clean`` build).

    Two deliberate properties, both needed to reproduce the paper's figures:

    1. **No stream dimension** — one ``(T, O)`` matrix for everything.
    2. **Same-cycle undercount (§5.2)** — when two streams hit the same
       ``(type, outcome)`` cell in the same cycle, only one increment lands.
       The paper observed ``Σ tip ≥ clean`` because of exactly this.

    The executor drives a :class:`StatTable` ("tip") and a
    :class:`CleanStatTable` ("clean") side by side from the same access
    stream, so every benchmark can compare the two builds in one run.
    """

    def __init__(
        self,
        n_types: int = AccessType.count(),
        n_outcomes: int = AccessOutcome.count(),
        name: str = "Cache_stats",
    ) -> None:
        self.name = name
        self._n_types = int(n_types)
        self._n_outcomes = int(n_outcomes)
        self._m = _new_matrix(self._n_types, self._n_outcomes)
        #: (type, outcome) -> (cycle, stream) of the last landed increment.
        self._last_touch: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.lost_updates: int = 0

    def inc_stats(
        self,
        access_type: int,
        access_outcome: int,
        cycle: Optional[int] = None,
        stream_id: int = 0,
        n: int = 1,
    ) -> None:
        """Increment, emulating the lost-update race when ``cycle`` is given.

        The loss is *cross-stream only*: a single stream incrementing the
        same cell repeatedly in one cycle keeps all its counts (a
        single-threaded simulator cannot race with itself), but when a
        *different* stream touched the cell in the same cycle the update is
        lost — the paper's §5.2 undercount.  ``cycle=None`` means
        "no concurrency model" — always lands.
        """
        if cycle is not None:
            key = (access_type, access_outcome)
            last = self._last_touch.get(key)
            if last is not None and last[0] == cycle and last[1] != stream_id:
                self.lost_updates += int(n)
                return  # lost update
            self._last_touch[key] = (cycle, stream_id)
        self._m[access_type, access_outcome] += np.uint64(n)

    def matrix(self) -> np.ndarray:
        return self._m.copy()

    def get(self, access_type: int, outcome: int) -> int:
        return int(self._m[access_type, outcome])

    def clear(self) -> None:
        self._m[...] = 0
        self._last_touch.clear()
        self.lost_updates = 0
