"""Vectorized per-stream stat engine — batch ingestion for the hot path.

The reference tables in :mod:`repro.core.stats` mutate one cell per Python
call (``dict`` lookup + NumPy scalar ``+=``), which caps simulator and
serving throughput.  :class:`StatsEngine` keeps the exact
:class:`~repro.core.stats.StatTable` / :class:`~repro.core.stats.CleanStatTable`
semantics — including the baseline's §5.2 same-cycle undercount — but ingests
events through preallocated columnar buffers::

    (stream_id, access_type, outcome, count, cycle, lane)

and lands them with a single ``np.add.at`` scatter per store per flush.
Reads (``aggregate``, ``stream_matrix``, ``print_stats``, …) auto-flush, so
callers never observe buffered state.

Storage layout
--------------
Per-stream matrices live in dense ``(S, T, O)`` uint64 blocks (cumulative,
per-window, failure), where ``S`` grows by doubling as new stream ids appear.
Stream ids map to block slots via a sorted-array ``searchsorted`` lookup so
the flush path stays fully vectorized.

Clean-build emulation
---------------------
The baseline's lost-update race (§5.2) is sequential in nature — an
increment is dropped iff the *last landed* increment of the same
``(type, outcome)`` cell happened in the same cycle on a different stream.
Within one cell and one run of equal cycles, the landed stream is fixed by
the first event of the run (or by carried state when a flush split a cycle),
so the whole decision vectorizes: group events by (cell, cycle-run), pick
the run's landed stream, mask, scatter.  ``tests/test_stats_engine.py``
checks equivalence against the reference scalar implementation on
randomized event streams with randomized flush boundaries.

See docs/DESIGN.md §4 for the full lifecycle.
"""

from __future__ import annotations

import sys
from typing import IO, Dict, Optional, Sequence, Tuple

import numpy as np

from .array_ops import get_backend
from .stats import (
    DEFAULT_STREAM,
    AccessOutcome,
    AccessType,
    FailOutcome,
    StatTable,
    format_breakdown,
)

__all__ = ["StatsEngine", "CleanView"]

# Lane bits: which stores a buffered event lands in.
_LANE_CUM = 1  # cumulative per-stream store (m_stats)
_LANE_PW = 2  # per-window store (m_stats_pw)
_LANE_FAIL = 4  # reservation-failure store (m_fail_stats)
_LANE_CLEAN = 8  # baseline clean build (aggregate + §5.2 undercount)
_LANE_CLEAN_FAIL = 16  # baseline clean build, failure table

#: Sentinel cycle for "no concurrency model" (CleanStatTable's cycle=None).
_NO_CYCLE = -1


class _CleanState:
    """Dense clean-build matrix + per-cell last-landed carry state."""

    __slots__ = ("matrix", "last_cycle", "last_stream", "valid", "lost")

    def __init__(self, n_types: int, n_cols: int) -> None:
        self.matrix = np.zeros((n_types, n_cols), dtype=np.uint64)
        n_cells = n_types * n_cols
        self.last_cycle = np.zeros(n_cells, dtype=np.int64)
        self.last_stream = np.zeros(n_cells, dtype=np.int64)
        self.valid = np.zeros(n_cells, dtype=bool)
        self.lost = 0

    def clear(self) -> None:
        self.matrix[...] = 0
        self.valid[...] = False
        self.lost = 0


class CleanView:
    """Read view over a clean lane, API-compatible with
    :class:`~repro.core.stats.CleanStatTable` accessors."""

    def __init__(self, engine: "StatsEngine", state: _CleanState, name: str) -> None:
        self._engine = engine
        self._state = state
        self.name = name

    def matrix(self) -> np.ndarray:
        self._engine.flush()
        return self._state.matrix.copy()

    def get(self, access_type: int, outcome: int) -> int:
        self._engine.flush()
        return int(self._state.matrix[access_type, outcome])

    @property
    def lost_updates(self) -> int:
        self._engine.flush()
        return self._state.lost

    def clear(self) -> None:
        self._engine.flush()
        self._state.clear()


class StatsEngine:
    """Batched, array-backed per-stream stat store.

    Drop-in for the read/mutate API of :class:`~repro.core.stats.StatTable`
    (``inc_stats``/``inc_stats_pw``/``inc_fail_stats``, ``__call__``, ``get``,
    ``stream_matrix``, ``streams``, ``aggregate``, ``print_stats``, …) plus
    the combined hot-path mutators :meth:`record` / :meth:`record_fail` /
    :meth:`record_batch` that feed the tip, per-window and clean views from
    one event.
    """

    def __init__(
        self,
        n_types: int = AccessType.count(),
        n_outcomes: int = AccessOutcome.count(),
        n_fail: int = FailOutcome.count(),
        name: str = "Cache_stats",
        *,
        capacity: int = 1 << 16,
        clean_fail_cols: Optional[int] = None,
    ) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self._n_types = int(n_types)
        self._n_outcomes = int(n_outcomes)
        self._n_fail = int(n_fail)
        self._capacity = int(capacity)
        # Array-ops backend for the landing scatters; the simulator rebinds
        # this to the configured backend (SimConfig.array_backend).
        self.ops = get_backend("numpy")

        # Columnar staging.  Scalar mutators append to plain Python lists
        # (one per column — list.append is several times cheaper than a NumPy
        # scalar setitem, which boxes every value); ``record_batch`` seals the
        # scalar run and stages its arrays as one chunk.  ``flush`` stitches
        # the chunks back together in arrival order, so interleaved scalar and
        # batch ingestion lands exactly as if every event had been appended
        # one by one (the §5.2 clean emulation is order-sensitive).
        self._sl_stream: list = []
        self._sl_type: list = []
        self._sl_col: list = []
        self._sl_n: list = []
        self._sl_cycle: list = []
        self._sl_lane: list = []
        self._chunks: list = []  # sealed (sid, at, col, cnt, cyc, lane) arrays
        self._pos = 0  # staged event count (scalar lists + sealed chunks)

        # Dense per-stream blocks, grown by doubling along the stream axis.
        self._s_cap = 0
        self._cum = np.zeros((0, self._n_types, self._n_outcomes), dtype=np.uint64)
        self._pw = np.zeros((0, self._n_types, self._n_outcomes), dtype=np.uint64)
        self._fail = np.zeros((0, self._n_types, self._n_fail), dtype=np.uint64)
        self._slots: Dict[int, int] = {}
        self._sorted_ids = np.zeros(0, dtype=np.int64)
        self._sorted_slots = np.zeros(0, dtype=np.int64)

        # Clean-build lanes (main + failure table).
        cf_cols = clean_fail_cols if clean_fail_cols is not None else max(self._n_outcomes, self._n_fail)
        self._clean = _CleanState(self._n_types, self._n_outcomes)
        self._clean_fail = _CleanState(self._n_types, int(cf_cols))
        self.clean = CleanView(self, self._clean, name)
        self.clean_fail = CleanView(self, self._clean_fail, f"{name}_fail")

    # -- mutators: buffered appends ------------------------------------------------
    def _append(self, lane: int, atype: int, col: int, stream_id: int, n: int, cycle: int) -> None:
        self._sl_stream.append(stream_id)
        self._sl_type.append(atype)
        self._sl_col.append(col)
        self._sl_n.append(n)
        self._sl_cycle.append(cycle)
        self._sl_lane.append(lane)
        self._pos += 1
        if self._pos >= self._capacity:
            self.flush()

    def _seal_scalars(self) -> None:
        """Convert the pending scalar run into one staged array chunk."""
        if not self._sl_stream:
            return
        self._chunks.append((
            np.array(self._sl_stream, dtype=np.int64),
            np.array(self._sl_type, dtype=np.int64),
            np.array(self._sl_col, dtype=np.int64),
            np.array(self._sl_n, dtype=np.uint64),
            np.array(self._sl_cycle, dtype=np.int64),
            np.array(self._sl_lane, dtype=np.uint8),
        ))
        self._sl_stream = []
        self._sl_type = []
        self._sl_col = []
        self._sl_n = []
        self._sl_cycle = []
        self._sl_lane = []

    @staticmethod
    def _encode_cycle(cycle: Optional[int]) -> int:
        # Negative cycles would collide with the internal no-cycle sentinel
        # and silently skip the §5.2 emulation — reject them up front.
        if cycle is None:
            return _NO_CYCLE
        if cycle < 0:
            raise ValueError(f"cycle must be >= 0 or None, got {cycle}")
        return cycle

    def record(
        self,
        access_type: int,
        access_outcome: int,
        stream_id: int,
        n: int = 1,
        cycle: Optional[int] = None,
    ) -> None:
        """One simulator access event → tip cumulative + per-window + clean.

        Equivalent to the seed's ``inc_stats`` + ``inc_stats_pw`` +
        ``CleanStatTable.inc_stats(cycle=...)`` triple."""
        self._append(
            _LANE_CUM | _LANE_PW | _LANE_CLEAN,
            access_type,
            access_outcome,
            stream_id,
            n,
            self._encode_cycle(cycle),
        )

    def record_fail(
        self,
        access_type: int,
        fail_outcome: int,
        stream_id: int,
        n: int = 1,
        cycle: Optional[int] = None,
    ) -> None:
        """One reservation-failure event → tip failure + clean failure table."""
        self._append(
            _LANE_FAIL | _LANE_CLEAN_FAIL,
            access_type,
            fail_outcome,
            stream_id,
            n,
            self._encode_cycle(cycle),
        )

    # StatTable-compatible single-store mutators (no clean participation,
    # exactly like mutating a bare StatTable).
    def inc_stats(self, access_type: int, access_outcome: int, stream_id: int, n: int = 1) -> None:
        self._append(_LANE_CUM, access_type, access_outcome, stream_id, n, _NO_CYCLE)

    def inc_stats_pw(self, access_type: int, access_outcome: int, stream_id: int, n: int = 1) -> None:
        self._append(_LANE_PW, access_type, access_outcome, stream_id, n, _NO_CYCLE)

    def inc_fail_stats(self, access_type: int, fail_outcome: int, stream_id: int, n: int = 1) -> None:
        self._append(_LANE_FAIL, access_type, fail_outcome, stream_id, n, _NO_CYCLE)

    def record_batch(
        self,
        access_types: np.ndarray,
        access_outcomes: np.ndarray,
        stream_ids: np.ndarray,
        counts: Optional[np.ndarray] = None,
        cycles: Optional[np.ndarray] = None,
        *,
        fail: bool = False,
        pw: bool = True,
        clean: bool = True,
    ) -> None:
        """Bulk ingestion: column arrays of events in arrival order.

        This is the fast path — events are block-copied into the buffers and
        land via the same vectorized flush as scalar appends.  ``cycles`` may
        be omitted (no concurrency model) or contain ``-1`` per event for the
        same meaning; other negative cycles are rejected.  ``fail=True``
        routes to the failure stores.  ``pw=False`` / ``clean=False`` drop
        the per-window / clean lanes, making the batch equivalent to a loop
        of bare ``inc_stats`` calls (seed ``StatTable`` semantics) instead of
        the combined :meth:`record` triple.
        """
        at = np.asarray(access_types, dtype=np.int64).ravel()
        oc = np.asarray(access_outcomes, dtype=np.int64).ravel()
        sid = np.asarray(stream_ids, dtype=np.int64).ravel()
        m = at.shape[0]
        if oc.shape[0] != m or sid.shape[0] != m:
            raise ValueError("record_batch: column length mismatch")
        cnt = (
            np.ones(m, dtype=np.uint64)
            if counts is None
            else np.asarray(counts, dtype=np.uint64).ravel()
        )
        cyc = (
            np.full(m, _NO_CYCLE, dtype=np.int64)
            if cycles is None
            else np.asarray(cycles, dtype=np.int64).ravel()
        )
        if cnt.shape[0] != m or cyc.shape[0] != m:
            raise ValueError("record_batch: column length mismatch")
        if cycles is not None and bool((cyc < _NO_CYCLE).any()):
            raise ValueError("record_batch: cycles must be >= 0 (or -1 for no cycle)")
        if fail:
            lane = _LANE_FAIL | (_LANE_CLEAN_FAIL if clean else 0)
        else:
            lane = _LANE_CUM | (_LANE_PW if pw else 0) | (_LANE_CLEAN if clean else 0)
        if m == 0:
            return

        self._seal_scalars()
        # Own copies: the caller may reuse its arrays after this returns.
        self._chunks.append((
            sid.copy(), at.copy(), oc.copy(), cnt.copy(), cyc.copy(),
            np.full(m, lane, dtype=np.uint8),
        ))
        self._pos += m
        if self._pos >= self._capacity:
            self.flush()

    # -- flush: the single-scatter landing ------------------------------------------
    def _ensure_slots(self, stream_ids: np.ndarray) -> None:
        new = stream_ids[~self.ops.sorted_membership(stream_ids, self._sorted_ids)]
        if new.size == 0:
            return
        for sid in new.tolist():
            self._slots[sid] = len(self._slots)
        needed = len(self._slots)
        if needed > self._s_cap:
            new_cap = max(needed, 4, 2 * self._s_cap)
            for attr in ("_cum", "_pw", "_fail"):
                old = getattr(self, attr)
                grown = np.zeros((new_cap,) + old.shape[1:], dtype=np.uint64)
                grown[: old.shape[0]] = old
                setattr(self, attr, grown)
            self._s_cap = new_cap
        ids = np.fromiter(self._slots.keys(), dtype=np.int64, count=len(self._slots))
        slots = np.fromiter(self._slots.values(), dtype=np.int64, count=len(self._slots))
        order = np.argsort(ids)
        self._sorted_ids = ids[order]
        self._sorted_slots = slots[order]

    def _on_flush(
        self,
        sid: np.ndarray,
        at: np.ndarray,
        col: np.ndarray,
        cnt: np.ndarray,
        cyc: np.ndarray,
        lane: np.ndarray,
    ) -> None:
        """Hook: observe every flushed event column, in landing order.

        The base engine does nothing; the compiled-trace recorder
        (:class:`repro.sim.compiled.RecordingStatsEngine`) overrides this to
        journal the exact event stream the simulation produced."""

    def flush(self) -> None:
        """Land every buffered event.  One backend scatter per dense store."""
        if self._pos == 0:
            return
        self._seal_scalars()
        chunks = self._chunks
        if len(chunks) == 1:
            sid, at, col, cnt, cyc, lane = chunks[0]
        else:
            sid = np.concatenate([c[0] for c in chunks])
            at = np.concatenate([c[1] for c in chunks])
            col = np.concatenate([c[2] for c in chunks])
            cnt = np.concatenate([c[3] for c in chunks])
            cyc = np.concatenate([c[4] for c in chunks])
            lane = np.concatenate([c[5] for c in chunks])
        self._pos = 0
        self._chunks = []
        self._on_flush(sid, at, col, cnt, cyc, lane)

        self._ensure_slots(np.unique(sid))
        slot = self._sorted_slots[np.searchsorted(self._sorted_ids, sid)]

        n_t = self._n_types
        for bit, dense, n_cols in (
            (_LANE_CUM, self._cum, self._n_outcomes),
            (_LANE_PW, self._pw, self._n_outcomes),
            (_LANE_FAIL, self._fail, self._n_fail),
        ):
            sel = (lane & bit) != 0
            if sel.any():
                lin = slot[sel] * (n_t * n_cols) + at[sel] * n_cols + col[sel]
                self.ops.scatter_add_u64(dense.reshape(-1), lin, cnt[sel])

        for bit, state in ((_LANE_CLEAN, self._clean), (_LANE_CLEAN_FAIL, self._clean_fail)):
            sel = (lane & bit) != 0
            if sel.any():
                n_cols = state.matrix.shape[1]
                self._clean_apply(state, at[sel] * n_cols + col[sel], cyc[sel], sid[sel], cnt[sel])

    @staticmethod
    def _clean_apply(
        state: _CleanState,
        cell: np.ndarray,
        cyc: np.ndarray,
        strm: np.ndarray,
        cnt: np.ndarray,
    ) -> None:
        """Vectorized §5.2 lost-update emulation over one flush's events.

        Sequential rule (per cell): an increment lands unless the last
        *landed* increment of that cell had the same cycle and a different
        stream; landing updates the cell's (cycle, stream) state.  Grouped by
        runs of equal (cell, cycle) — with per-cell arrival order preserved
        by a stable sort — each run's landed stream is fixed by its first
        event (or by carried state when the run continues a cycle split
        across flushes), so the mask is computable without a scan.
        """
        flat = state.matrix.reshape(-1)

        # cycle=None events bypass the concurrency model: always land,
        # never read or write the last-touch state.
        nocyc = cyc == _NO_CYCLE
        if nocyc.any():
            np.add.at(flat, cell[nocyc], cnt[nocyc])
            if nocyc.all():
                return
            keep = ~nocyc
            cell, cyc, strm, cnt = cell[keep], cyc[keep], strm[keep], cnt[keep]

        order = np.argsort(cell, kind="stable")
        c, y, s, n = cell[order], cyc[order], strm[order], cnt[order]

        new_cell = np.ones(c.shape[0], dtype=bool)
        new_cell[1:] = c[1:] != c[:-1]
        new_grp = new_cell.copy()
        new_grp[1:] |= y[1:] != y[:-1]
        first = np.flatnonzero(new_grp)  # event index of each group start
        gid = np.cumsum(new_grp) - 1  # per-event group id

        # Landed stream per group: the first event's stream, unless the group
        # opens a cell whose carried state is in the same cycle (a cycle
        # split across two flushes) — then the carried stream stays landed.
        s0 = s[first].copy()
        cell_first = new_cell[first]  # group also starts a new cell run?
        fc = first[cell_first]
        cells_fc = c[fc]
        carry_hit = state.valid[cells_fc] & (state.last_cycle[cells_fc] == y[fc])
        s0[cell_first] = np.where(carry_hit, state.last_stream[cells_fc], s[fc])

        landed = s == s0[gid]
        np.add.at(flat, c[landed], n[landed])
        state.lost += int(n[~landed].sum())

        # Carry update: after a group, the cell's state is (cycle, s0)
        # whether or not anything landed (no-landing groups only occur when
        # the carry already equals (cycle, s0)).  The last group of each cell
        # run wins; a later run of the same cell within this flush overwrites.
        cpg = c[first]  # cell per group
        last = np.ones(first.shape[0], dtype=bool)
        last[:-1] = cpg[1:] != cpg[:-1]
        state.last_cycle[cpg[last]] = y[first][last]
        state.last_stream[cpg[last]] = s0[last]
        state.valid[cpg[last]] = True

    # -- accessors (StatTable API; all auto-flush) ----------------------------------
    def _store(self, *, pw: bool = False, fail: bool = False) -> Tuple[np.ndarray, int]:
        dense = self._fail if fail else (self._pw if pw else self._cum)
        return dense, (self._n_fail if fail else self._n_outcomes)

    def __call__(self, access_type: int, outcome: int, fail_outcome: bool, stream_id: int) -> int:
        self.flush()
        slot = self._slots.get(stream_id)
        if slot is None:
            return 0
        dense, _ = self._store(fail=fail_outcome)
        return int(dense[slot, access_type, outcome])

    def get(self, access_type: int, outcome: int, stream_id: int) -> int:
        return self(access_type, outcome, False, stream_id)

    def stream_matrix(self, stream_id: int, *, pw: bool = False, fail: bool = False) -> np.ndarray:
        self.flush()
        dense, n_cols = self._store(pw=pw, fail=fail)
        slot = self._slots.get(stream_id)
        if slot is None:
            return np.zeros((self._n_types, n_cols), dtype=np.uint64)
        return dense[slot].copy()

    def streams(self) -> Tuple[int, ...]:
        self.flush()
        return tuple(sorted(self._slots))

    def aggregate(self, *, pw: bool = False, fail: bool = False) -> np.ndarray:
        self.flush()
        dense, _ = self._store(pw=pw, fail=fail)
        return dense[: len(self._slots)].sum(axis=0, dtype=np.uint64)

    def total_accesses(self, stream_id: Optional[int] = None) -> int:
        if stream_id is None:
            return int(self.aggregate().sum())
        return int(self.stream_matrix(stream_id).sum())

    def aggregate_by(
        self,
        groups: Dict[int, int],
        *,
        pw: bool = False,
        fail: bool = False,
    ) -> Dict[int, np.ndarray]:
        """Per-group ``(T, O)`` rollups of the present streams: each stream's
        block sums into ``groups[sid]`` (unmapped streams into group ``0`` —
        the device-axis convention, docs/DESIGN.md §5.14).  One vectorized
        sum per group over the dense store; group keys come out sorted."""
        self.flush()
        dense, _ = self._store(pw=pw, fail=fail)
        members: Dict[int, list] = {}
        for sid, slot in self._slots.items():
            members.setdefault(int(groups.get(sid, 0)), []).append(slot)
        return {
            g: dense[slots].sum(axis=0, dtype=np.uint64)
            for g, slots in sorted(members.items())
        }

    # -- windows ----------------------------------------------------------------------
    def clear_pw(self) -> None:
        self.flush()
        self._pw[...] = 0

    def clear(self) -> None:
        self._pos = 0
        self._chunks = []
        self._sl_stream, self._sl_type, self._sl_col = [], [], []
        self._sl_n, self._sl_cycle, self._sl_lane = [], [], []
        self._cum[...] = 0
        self._pw[...] = 0
        self._fail[...] = 0
        self._slots.clear()
        self._sorted_ids = np.zeros(0, dtype=np.int64)
        self._sorted_slots = np.zeros(0, dtype=np.int64)
        self._clean.clear()
        self._clean_fail.clear()

    def signature(self) -> dict:
        """Full comparable snapshot of every stat view (tip cumulative,
        per-window, failure — all per stream — plus both clean lanes and
        their lost-update counters), as plain Python structures.  Two engines
        fed the same event sequence must produce equal signatures; the
        cross-engine identity suite and ``benchmarks/sim_speed.py`` assert
        this between the cycle-stepped and event-driven simulator loops."""
        self.flush()
        return {
            "streams": {
                sid: {
                    "cum": self.stream_matrix(sid).tolist(),
                    "pw": self.stream_matrix(sid, pw=True).tolist(),
                    "fail": self.stream_matrix(sid, fail=True).tolist(),
                }
                for sid in self.streams()
            },
            "clean": self._clean.matrix.tolist(),
            "clean_lost": self._clean.lost,
            "clean_fail": self._clean_fail.matrix.tolist(),
            "clean_fail_lost": self._clean_fail.lost,
        }

    # -- state snapshot / restore (compiled-trace replay path) ------------------------
    def state_snapshot(self) -> dict:
        """Full landed state as one picklable dict: constructor geometry,
        stream-slot mapping, the dense tip stores (trimmed to live slots),
        and both clean lanes including their §5.2 carry arrays.  Restoring a
        snapshot (:meth:`from_snapshot`) is bit-equivalent to replaying the
        exact event stream that produced it — proven against the journal
        replay in ``tests/test_sim_compiled.py``."""
        self.flush()
        n = len(self._slots)
        return {
            "name": self.name,
            "n_types": self._n_types,
            "n_outcomes": self._n_outcomes,
            "n_fail": self._n_fail,
            "clean_fail_cols": self._clean_fail.matrix.shape[1],
            "slots": dict(self._slots),
            "cum": self._cum[:n].copy(),
            "pw": self._pw[:n].copy(),
            "fail": self._fail[:n].copy(),
            "clean": self._clean_state_snapshot(self._clean),
            "clean_fail": self._clean_state_snapshot(self._clean_fail),
        }

    @staticmethod
    def _clean_state_snapshot(state: _CleanState) -> dict:
        return {
            "matrix": state.matrix.copy(),
            "last_cycle": state.last_cycle.copy(),
            "last_stream": state.last_stream.copy(),
            "valid": state.valid.copy(),
            "lost": state.lost,
        }

    def state_restore(self, snap: dict) -> None:
        """Load a :meth:`state_snapshot` — a vectorized block copy, replacing
        whatever this engine held.  Geometry (type/outcome/fail axes) must
        match the snapshot's."""
        if (snap["n_types"], snap["n_outcomes"], snap["n_fail"]) != (
            self._n_types, self._n_outcomes, self._n_fail,
        ) or snap["clean_fail_cols"] != self._clean_fail.matrix.shape[1]:
            raise ValueError("state_restore: snapshot geometry mismatch")
        self.clear()
        slots = snap["slots"]
        n = len(slots)
        if n:
            # Snapshot slots are dense 0..n-1 in arrival order — adopt the
            # dense blocks and the mapping wholesale (no re-slotting).
            self._slots = dict(slots)
            self._cum = snap["cum"].copy()
            self._pw = snap["pw"].copy()
            self._fail = snap["fail"].copy()
            self._s_cap = n
            ids = np.fromiter(slots.keys(), dtype=np.int64, count=n)
            sl = np.fromiter(slots.values(), dtype=np.int64, count=n)
            order = np.argsort(ids)
            self._sorted_ids = ids[order]
            self._sorted_slots = sl[order]
        for state, key in ((self._clean, "clean"), (self._clean_fail, "clean_fail")):
            s = snap[key]
            state.matrix[...] = s["matrix"]
            state.last_cycle[...] = s["last_cycle"]
            state.last_stream[...] = s["last_stream"]
            state.valid[...] = s["valid"]
            state.lost = s["lost"]

    @classmethod
    def from_snapshot(cls, snap: dict) -> "StatsEngine":
        """Fresh engine materialized from a :meth:`state_snapshot`."""
        eng = cls(
            n_types=snap["n_types"],
            n_outcomes=snap["n_outcomes"],
            n_fail=snap["n_fail"],
            name=snap["name"],
            clean_fail_cols=snap["clean_fail_cols"],
        )
        eng.state_restore(snap)
        return eng

    # -- interop ---------------------------------------------------------------------
    def as_stat_table(self) -> StatTable:
        """Materialize the tip stores as a plain :class:`StatTable` (for
        merge/serde interop, e.g. :class:`repro.core.collector.StatCollector`)."""
        self.flush()
        t = StatTable(self._n_types, self._n_outcomes, self._n_fail, self.name)
        for sid, slot in self._slots.items():
            t._stats[sid] = self._cum[slot].copy()
            t._stats_pw[sid] = self._pw[slot].copy()
            t._fail_stats[sid] = self._fail[slot].copy()
        return t

    def to_dict(self) -> dict:
        return self.as_stat_table().to_dict()

    # -- printing (same format as StatTable.print_stats) -------------------------------
    def print_stats(
        self,
        fout: IO[str] = sys.stdout,
        stream_id: int = DEFAULT_STREAM,
        cache_name: Optional[str] = None,
    ) -> None:
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
