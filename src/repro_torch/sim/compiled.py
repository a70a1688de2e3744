"""Trace-compiled lockstep engine: compile a scenario shape once, replay many.

Sweep throughput — not single-run latency — is what bounds how many scenarios
the conformance/batch pipeline can cover (the paper validates per-stream
tracking by sweeping multi-stream microbenchmarks).  The event engine already
skips uninteresting cycles, but every run of a sweep still re-executes the
full interpreter loop even when the *shape* of the simulation is one it has
executed before.  This module removes that: ``SimConfig.engine="compiled"``
is a two-phase trace-compile/replay backend.

**Phase 1 — compile.**  The first run of a scenario shape executes the
existing event loop once with a :class:`RecordingStatsEngine` injected in
place of the executor's :class:`~repro.core.engine.StatsEngine`.  The
recorder hooks the columnar flush path and journals the *exact* event stream
the simulation lands — flat NumPy columns ``(lane, type, col, stream, n,
cycle)`` — segmented at every ``clear_pw`` call (kernel exit: the one
executor-visible segment boundary, where per-window stats reset, the exit
report renders, and bandwidth pointers are snapshotted).  A recording sink
captures the emitted kernel-exit reports; the timeline, log text, final
engine state, and final resource counters are snapshotted after the run.
Everything lands in a :class:`CompiledTrace`, cached in the process-global
:data:`TRACE_CACHE` under the run's **shape key**.

**Shape key.**  ``("cc-trace-v1", SimConfig.structural_key(),
StreamManager.structure(payload_key=KernelDesc.structural_key))`` — i.e. the
config fields that can alter behaviour plus the full launch graph (stream
ids/priorities, FIFO order, event wiring, per-kernel structural content).
Two simulators with equal shape keys provably perform the same simulation:
the executor is deterministic (no RNG, no wall-clock), and every input it
reads is in the key.  Excluded are the :data:`~repro.sim.executor
.VALUE_ONLY_CONFIG` fields (``max_cycles`` — re-guarded at replay — and
``verbose``) and run-varying identifiers (kernel uids, stream display
names), which ``SimResult.signature()`` already normalizes.

**Phase 2 — replay.**  Every further run of the same shape skips simulation
entirely: the engine state restores from the snapshot (a vectorized block
copy proven bit-equivalent to re-landing the journal segment-by-segment
through ``record_batch`` — see :func:`replay_journal` and
``tests/test_sim_compiled.py``), the timeline/log/reports re-materialize
from the trace, and ``max_cycles`` is re-checked so a draw too small to have
completed raises exactly like the event loop.  :func:`replay_batch` replays
one trace for **many runs in lockstep**: runs are the trailing axis, and
per-segment resource columns accumulate over a ``(segments, runs)`` matrix
with one ``np.add.accumulate`` instead of per-run pointer arithmetic.

``sim/batch.py``'s ``backend="vector"`` builds on this: same-shape job
groups compile once and replay per job in-process, while the process pool
keeps handling cross-shape groups (shape-grouped sharding).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.engine import StatsEngine
from ..core.query import EventJournal
from ..core.stats import AccessOutcome
from ..core.timeline import KernelTimeline

from .executor import SimConfig, SimResult, TPUSimulator

__all__ = [
    "CompiledTrace",
    "RecordingStatsEngine",
    "TraceCache",
    "TRACE_CACHE",
    "shape_key",
    "get_or_compile",
    "run_compiled",
    "replay_batch",
    "replay_journal",
]

#: bump when the CompiledTrace layout or key contents change
#: (v3: SimConfig.fault_plan joined structural_key — fault-injected runs
#: compile their own traces and fault-off keys changed shape;
#: v4: multi-chip topology — SimConfig.topology_shape/topology_wrap/
#: link_bytes_per_cycle and KernelDesc.device/ici_route joined the
#: structural keys, seg_resources grew topology columns past the base 9,
#: and traces carry the stream → device binding)
_KEY_VERSION = "cc-trace-v4"


def _engine_ctor_kwargs() -> dict:
    """The executor's StatsEngine construction, replicated for replays."""
    return dict(
        name="Total_core_cache_stats",
        clean_fail_cols=max(AccessOutcome.count(), 8),
    )


class RecordingStatsEngine(EventJournal):
    """The compiler's journal: an :class:`~repro.core.query.EventJournal`
    (which owns the flushed-column retention via the shared ``_on_flush``
    hook) that additionally marks a segment boundary — plus a resource
    snapshot, via ``segment_hook`` — at each ``clear_pw``, the executor's
    kernel-exit boundary.  The journal is the compiled trace's ground
    truth: landing it again segment-by-segment reproduces this engine's
    state bit-for-bit."""

    def __init__(self) -> None:
        super().__init__(**_engine_ctor_kwargs())
        self._j_len = 0
        self.seg_bounds: List[int] = []  # journal length at each clear_pw
        self.seg_snaps: List[Tuple[float, ...]] = []  # segment_hook() values
        self.segment_hook = None  # set by the compiler: () -> tuple

    def _on_flush(self, sid, at, col, cnt, cyc, lane) -> None:
        super()._on_flush(sid, at, col, cnt, cyc, lane)
        self._j_len += len(sid)

    def clear_pw(self) -> None:
        super().clear_pw()  # flushes first → journal is current
        self.seg_bounds.append(self._j_len)
        if self.segment_hook is not None:
            self.seg_snaps.append(self.segment_hook())

    def journal_columns(self) -> Dict[str, np.ndarray]:
        return self.columns()


class _RecordingSink:
    """ReportSink that captures emitted reports for replay re-emission."""

    def __init__(self) -> None:
        self.reports: List[object] = []

    def emit(self, report) -> None:
        self.reports.append(report)


@dataclass
class CompiledTrace:
    """One scenario shape's recorded structural trace (phase-1 output)."""

    key: Tuple
    cycles: int
    #: exact landed event stream: sid/at/col/cnt/cyc/lane flat columns
    journal: Dict[str, np.ndarray]
    #: journal index at each segment boundary (one per kernel exit)
    seg_bounds: np.ndarray
    #: cumulative resource counters at each boundary, one row per segment:
    #: (hbm next_free, hbm bytes, hbm rd, hbm wr, ici next_free, ici bytes,
    #:  ici rd, ici wr, writebacks) — the 9 base columns — plus, on topology
    #: runs, the extra per-device / per-link columns appended by
    #: ``TPUSimulator._resource_snapshot``
    seg_resources: np.ndarray
    engine_snapshot: dict
    timeline_state: Tuple
    log: Tuple[str, ...]
    reports: Tuple[object, ...]
    #: final StreamManager bookkeeping: per-stream (launched, done) flag rows
    #: in queue order, fired event ids
    stream_flags: Tuple
    fired_events: Tuple[int, ...]
    #: final VMEMCache state — (lines [(tag, dirty, last_use) in LRU order],
    #: mshr [(tag, ready, streams)], heap entries, next mshr seq, miss-path
    #: mechanism snapshot or None).  Restored lazily, and only when a
    #: replayed simulator is *resumed* with new work (replay itself never
    #: pays for it).
    cache_state: Tuple = ((), (), (), 0, None)
    #: stream id → device id binding recorded at compile time (sorted item
    #: pairs); replays re-attach it so per-device StatsFrame queries work on
    #: replayed results exactly as on simulated ones
    stream_devices: Tuple[Tuple[int, int], ...] = ()
    compile_seconds: float = 0.0

    @property
    def n_events(self) -> int:
        return int(self.journal["sid"].shape[0])

    @property
    def n_segments(self) -> int:
        return int(self.seg_bounds.shape[0])


class TraceCache:
    """Process-global LRU shape-key → :class:`CompiledTrace` store."""

    def __init__(self, max_entries: int = 64) -> None:
        self.max_entries = int(max_entries)
        self._store: "OrderedDict[Tuple, CompiledTrace]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.compiles = 0

    def get(self, key: Tuple) -> Optional[CompiledTrace]:
        trace = self._store.get(key)
        if trace is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return trace

    def put(self, key: Tuple, trace: CompiledTrace) -> None:
        self._store[key] = trace
        self._store.move_to_end(key)
        self.compiles += 1
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    def clear(self) -> None:
        self._store.clear()
        self.hits = self.misses = self.compiles = 0

    def __len__(self) -> int:
        return len(self._store)


#: the process-global trace cache ``SimConfig.engine="compiled"`` replays from
TRACE_CACHE = TraceCache()


def shape_key(sim: TPUSimulator) -> Tuple:
    """The simulator's shape-defining structure (see module docstring)."""
    return (
        _KEY_VERSION,
        sim.cfg.structural_key(),
        sim.streams.structure(payload_key=lambda d: d.structural_key()),
    )


# --------------------------------------------------------------------------- phase 1
def _compile(sim: TPUSimulator) -> Tuple[CompiledTrace, SimResult]:
    """Run ``sim`` once under the event loop with recording hooks attached;
    return the trace plus the run's own result (already bit-exact — the
    recorder *is* a StatsEngine)."""
    if sim._cycle != 0 or sim.log or sim.engine.streams():
        raise RuntimeError("compile requires a fresh simulator (nothing run yet)")
    t0 = time.perf_counter()
    rec = RecordingStatsEngine()
    cache = sim.cache
    # Base 9 columns plus the topology extras when one is attached — the
    # executor owns the column layout (TPUSimulator._resource_snapshot /
    # _restore_resources are exact inverses).
    rec.segment_hook = sim._resource_snapshot
    # Swap the stat engine (and its views) before the first event lands.
    sim.engine = rec
    sim.stats = rec
    sim.clean = rec.clean
    sim.clean_fail = rec.clean_fail
    rsink = _RecordingSink()
    sim.sinks.append(rsink)
    try:
        sim._run_event()
    finally:
        sim.sinks.remove(rsink)

    journal = rec.journal_columns()
    flags = tuple(
        tuple((w.launched, w.done) for w in sim.streams._queues[sid])
        for sid in sorted(sim.streams._queues)
    )
    fired = tuple(sorted(e for e, ev in sim.streams._events.items() if ev.fired))
    cache_state = (
        tuple((ln.tag, ln.dirty, ln.last_use) for ln in cache._lines.values()),
        tuple((tag, rc, tuple(streams)) for tag, (rc, streams) in cache._mshr.items()),
        tuple(cache._mshr_heap),
        next(cache._mshr_seq),  # consuming one keeps future seqs larger
        cache.mech_state(),  # miss-path mechanism structures (None for "none")
    )
    trace = CompiledTrace(
        key=(),  # filled by get_or_compile (the key was computed pre-run)
        cycles=sim._cycle,
        journal=journal,
        seg_bounds=np.asarray(rec.seg_bounds, dtype=np.int64),
        seg_resources=np.asarray(rec.seg_snaps, dtype=np.float64).reshape(
            len(rec.seg_snaps), len(rec.seg_snaps[0]) if rec.seg_snaps else 9
        ),
        engine_snapshot=rec.state_snapshot(),
        timeline_state=sim.timeline.state(),
        log=tuple(sim.log),
        reports=tuple(rsink.reports),
        stream_flags=flags,
        fired_events=fired,
        cache_state=cache_state,
        stream_devices=tuple(sorted(sim.stream_devices.items())),
        compile_seconds=time.perf_counter() - t0,
    )
    result = SimResult(
        cycles=sim._cycle,
        stats=rec,
        clean=rec.clean,
        clean_fail=rec.clean_fail,
        timeline=sim.timeline,
        log=sim.log,
        devices=dict(sim.stream_devices),
    )
    return trace, result


def get_or_compile(sim: TPUSimulator) -> Tuple[CompiledTrace, Optional[SimResult]]:
    """Cache lookup by :func:`shape_key`; on a miss, compile on ``sim`` (the
    returned :class:`SimResult` is then the compile run's own — ``None`` on a
    hit, where ``sim`` has not executed anything)."""
    key = shape_key(sim)
    trace = TRACE_CACHE.get(key)
    if trace is not None:
        return trace, None
    trace, result = _compile(sim)
    trace.key = key
    TRACE_CACHE.put(key, trace)
    return trace, result


# --------------------------------------------------------------------------- phase 2
def _guard_max_cycles(trace: CompiledTrace, cfg: SimConfig) -> None:
    # The event loop raises upon *visiting* max_cycles; a completed run's
    # final cycle count C visited cycles <= C-1, so C > max_cycles means the
    # replayed draw could never have finished.  Same exception, same text.
    if trace.cycles > cfg.max_cycles:
        raise RuntimeError(f"simulation exceeded max_cycles={cfg.max_cycles}")


def _materialize(trace: CompiledTrace, cfg: SimConfig,
                 sinks: Sequence = ()) -> SimResult:
    """One replayed :class:`SimResult`: engine restored from the snapshot,
    timeline/log rebuilt, recorded kernel-exit reports re-emitted."""
    engine = StatsEngine.from_snapshot(trace.engine_snapshot)
    timeline = KernelTimeline.from_state(trace.timeline_state)
    log = list(trace.log)
    if cfg.verbose:
        for line in log:
            print(line)
    for sink in sinks:
        for report in trace.reports:
            sink.emit(report)
    return SimResult(
        cycles=trace.cycles,
        stats=engine,
        clean=engine.clean,
        clean_fail=engine.clean_fail,
        timeline=timeline,
        log=log,
        devices=dict(trace.stream_devices),
    )


def replay_batch(trace: CompiledTrace, configs: Sequence[SimConfig],
                 sinks: Sequence = ()) -> List[SimResult]:
    """Lockstep replay of one trace for many runs (phase 2, runs-as-axis).

    Runs form the trailing axis of a ``(9, runs)`` resource matrix: the
    per-segment byte/pointer deltas accumulate down the segment axis with
    one ``np.add.accumulate`` — the columnar analog of every run advancing
    its own bandwidth pointer per segment — and the final row broadcasts
    across the runs axis.  Value-only draws cannot change resource counters,
    so every run's column is identical by construction (the broadcast is a
    view, not ``runs`` copies); per-run state that *can* differ (the stat
    engine, guards) is materialized per run.  Stats land as one snapshot
    restore per run (proven equal to per-segment ``record_batch`` landing —
    see :func:`replay_journal`); ``max_cycles`` is guarded per run."""
    for cfg in configs:
        _guard_max_cycles(trace, cfg)
    n = len(configs)
    R = trace.seg_resources.shape[1] if trace.n_segments else 9
    if trace.n_segments and n:
        from ..core.array_ops import get_backend

        ops = get_backend(configs[0].array_backend)
        deltas = np.diff(trace.seg_resources, axis=0, prepend=0.0)
        # (segments, R) replay; the backend running sum is a strict left
        # fold, element-identical to np.add.accumulate
        lockstep = np.asarray(ops.running_sum(deltas))
        finals = np.broadcast_to(lockstep[-1][:, None], (R, n))
    else:
        finals = np.zeros((R, n))
    out = []
    for i, cfg in enumerate(configs):
        res = _materialize(trace, cfg, sinks=sinks)
        res.resources = {  # type: ignore[attr-defined]
            "hbm": tuple(finals[0:4, i]),
            "ici": tuple(finals[4:8, i]),
            "writebacks": int(finals[8, i]),
        }
        if R > 9:
            # topology runs: the per-device / per-link columns appended by
            # TPUSimulator._resource_snapshot, in its deterministic order
            res.resources["topology"] = tuple(finals[9:, i])
        out.append(res)
    return out


def run_compiled(sim: TPUSimulator) -> SimResult:
    """Executor dispatch target for ``SimConfig.engine="compiled"``.

    Miss → compile on this simulator (one event-loop run) and return its own
    result.  Hit → replay: restore the recorded end state onto the simulator
    (stat engine, timeline, log, stream bookkeeping, resource counters) so
    the post-run object is observably equivalent to one that simulated."""
    if sim._cycle or sim.log or sim.engine.streams():
        # Not a fresh simulator: a finished run being re-wrapped, or new work
        # launched after a previous run() (the incremental pattern the cycle
        # and event loops support).  Traces only describe whole fresh runs,
        # so continue under the event loop — bit-identical, just uncached.
        # A *replayed* simulator first restores its recorded VMEM cache
        # state (deferred from replay, where nothing reads it) so residency,
        # LRU order and in-flight MSHR fetches match a really-simulated sim.
        pending = getattr(sim, "_deferred_cache_state", None)
        if pending is not None:
            _restore_cache(sim.cache, pending)
            sim._deferred_cache_state = None
        sim._run_event()
        return SimResult(
            cycles=sim._cycle,
            stats=sim.engine,
            clean=sim.engine.clean,
            clean_fail=sim.engine.clean_fail,
            timeline=sim.timeline,
            log=sim.log,
            devices=dict(sim.stream_devices),
        )
    trace, compiled_result = get_or_compile(sim)
    if compiled_result is not None:
        return compiled_result
    _guard_max_cycles(trace, sim.cfg)
    result = _materialize(trace, sim.cfg, sinks=sim.sinks)
    # Mirror the replayed end state onto the simulator object.
    sim.engine = result.stats
    sim.stats = result.stats
    sim.clean = result.clean
    sim.clean_fail = result.clean_fail
    sim.timeline = result.timeline
    sim.log = result.log
    sim._cycle = result.cycles
    streams = sim.streams
    for flags, sid in zip(trace.stream_flags, sorted(streams._queues)):
        for (launched, done), w in zip(flags, streams._queues[sid]):
            w.launched, w.done = launched, done
    streams._busy_streams.clear()
    for eid in trace.fired_events:
        ev = streams._events.get(eid)
        if ev is not None:
            ev.fired = True
    if trace.n_segments:
        sim._restore_resources(trace.seg_resources[-1])
    sim.stream_devices = dict(trace.stream_devices)
    sim._deferred_cache_state = trace.cache_state  # restored only on resume
    # The replayed snapshot already contains every recorded fault event
    # (including end-of-run RECOVERED sweeps); disarm this simulator's own
    # fault state so a resume after replay cannot inject them twice.
    sim._faults = None
    return result


def _restore_cache(cache, state: Tuple) -> None:
    """Rebuild a VMEMCache's end-of-run state from a trace's record."""
    import itertools

    from .resources import _Line

    lines, mshr, heap, seq_next = state[:4]
    cache._lines.clear()
    for tag, dirty, last_use in lines:
        cache._lines[tag] = _Line(tag, dirty, last_use)
    cache._tag_snapshot = None  # membership rebuilt wholesale
    cache._mshr = {tag: (rc, list(streams)) for tag, rc, streams in mshr}
    cache._mshr_heap = [tuple(e) for e in heap]  # already heap-ordered
    cache._mshr_seq = itertools.count(seq_next)
    cache.mech_restore(state[4] if len(state) > 4 else None)


# --------------------------------------------------------------------------- identity
def replay_journal(trace: CompiledTrace) -> StatsEngine:
    """Land the recorded journal segment-by-segment through ``record_batch``
    — the *semantic definition* of what a replayed stat engine contains.

    Per segment, events split by lane pattern (normal vs failure — the two
    the executor produces) and land as one batch each, then ``clear_pw``
    fires at the boundary exactly as the kernel-exit path does.  Cross-lane
    reordering inside a segment is sound: the tip stores are commutative
    sums, and the two §5.2 clean lanes keep disjoint carry state, each
    seeing its own events in recorded order.  ``state_snapshot`` restores
    must equal this engine bit-for-bit (asserted in the test suite); the
    fast path is a block copy of precisely this landing."""
    from ..core.engine import _LANE_CLEAN, _LANE_CLEAN_FAIL, _LANE_FAIL, _LANE_PW

    eng = StatsEngine(**_engine_ctor_kwargs())
    j = trace.journal

    def land(lo: int, hi: int) -> None:
        lanes = j["lane"][lo:hi]
        for lane_val in np.unique(lanes).tolist():
            m = lanes == lane_val
            fail = bool(lane_val & _LANE_FAIL)
            clean = bool(lane_val & (_LANE_CLEAN_FAIL if fail else _LANE_CLEAN))
            eng.record_batch(
                j["at"][lo:hi][m], j["col"][lo:hi][m], j["sid"][lo:hi][m],
                counts=j["cnt"][lo:hi][m], cycles=j["cyc"][lo:hi][m],
                fail=fail, pw=bool(lane_val & _LANE_PW), clean=clean,
            )

    lo = 0
    for hi in trace.seg_bounds.tolist():
        land(lo, hi)
        eng.clear_pw()
        lo = hi
    if lo < trace.n_events:
        land(lo, trace.n_events)  # events after the final boundary: no clear
    eng.flush()
    return eng
