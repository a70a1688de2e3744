"""Batched divergent simulation — ``BatchRunner(backend="batched")``.

The vector backend amortizes *identical shapes*: one compile, N replays.
Divergent draws — different stream counts, trace lengths, launch staggers,
fault arm points — share nothing it can reuse, so a divergent registry sweep
degrades to one full Python simulation per job.  This module restructures
that sweep the way "Parallelizing a modern GPU simulator" (PAPERS.md,
arxiv 2502.14691) restructures a GPU simulator: engine state for N runs is
laid out as structure-of-arrays with a leading runs axis, and the expensive
phases advance all N runs together, masking out runs whose control flow has
diverged instead of forking back into per-run loops.

What actually dominates a divergent sweep is not the event loops (the event
engine already skips dead cycles) but the *landing* work each run performs
at every kernel exit: flush the staged stat journal, scatter it into the
dense per-stream stores, materialize two report matrices, render text.
Serial simulation pays that per kernel per run.  Here each run's
:class:`_BatchedSim` defers all of it — kernel exits only record a journal
*boundary* (plus a log placeholder) — and one landing pass then processes
every run's whole journal through the array-ops backend:

* **SoA journal tensors.**  Each run's staged columnar journal (stream, type,
  column, count, cycle, lane — already arrays) joins a runs-axis batch; a
  single ``searchsorted`` per run converts event positions to report-segment
  indices.
* **One segment-scatter landing kernel.**  All runs' report increments land
  into one padded ``(runs, segments, slot*type*outcome)`` uint64 tensor via
  :meth:`ArrayOps.segment_scatter` (numpy reference or the CUDA
  segment-scatter kernel), and a cumulative sum down the segment axis yields every report's
  cumulative matrix — the columnar analog of "each retire prints the
  cumulative table so far".
* **Masked lockstep stepping.**  Report step ``s`` processes every run that
  still has an ``s``-th kernel exit (runs that finished earlier are masked
  out), slicing its matrices from the landed tensor and splicing the exit
  report into the run's log at the position reserved during simulation.
* **Bit-identity.**  The landed engines, logs, timelines and cycle counts
  are proven equal to serial ``backend="pool"`` over the full registry under
  divergent hypothesis draws (``tests/test_batched.py``): the §5.2 clean
  emulation is flush-boundary-invariant by construction (the carry design in
  ``StatsEngine._clean_apply``), per-window stats are reproduced by stripping
  the PW lane from pre-boundary events before the single flush (the deferred
  analog of ``clear_pw`` at each exit), and report text is reconstructed from
  the same formatter over the same matrices.

Armed fault plans and sweep journals still require ``backend="pool"``
(worker retry/recovery is pool machinery); an *empty* plan is accepted —
it is bit-identical to no plan.  ``engine="compiled"`` jobs fall back to
the serial worker body per job (the compiled replay path has its own
landing discipline).
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.engine import _LANE_CUM, _LANE_FAIL, _LANE_PW
from ..core.sinks import Report, StatBlock
from ..core.stats import format_breakdown

from .executor import TPUSimulator

__all__ = ["run_batched_jobs"]

#: lane-byte mask clearing the per-window bit — the deferred ``clear_pw``
_PW_STRIP = np.uint8(~_LANE_PW & 0xFF)


@dataclass
class _DeferredReport:
    """One kernel-exit report, recorded at retire time and rendered at
    landing (everything the serial ``_retire`` needs except the matrices)."""

    sid: int
    uid: int
    name: str
    cycle: int
    boundary: int  # journal position at the report (events before it count)
    log_idx: int  # reserved slot in sim.log for the rendered text


class _BatchedSim(TPUSimulator):
    """A TPUSimulator whose kernel-exit landing is deferred.

    The engine loops are untouched — both the cycle and event loop call the
    overridden :meth:`_retire`, which performs every state transition the
    serial retire performs (fault resolution, stream/timeline bookkeeping)
    but records a journal boundary instead of flushing, rendering and
    clearing the per-window stats.  The staged journal therefore survives
    the whole run (capacity is effectively unbounded) and ``_boundaries[i]``
    is the absolute journal position of the ``i``-th report.
    """

    def __init__(self, config=None, sinks=None) -> None:
        super().__init__(config, sinks=sinks)
        # No mid-run auto-flush: with _retire's flush deferred too, a staged
        # event's list position IS its absolute journal position, which is
        # what makes the boundary bookkeeping exact.
        self.engine._capacity = 1 << 62
        self._boundaries: List[int] = []
        self._reports: List[_DeferredReport] = []

    def _retire(self, run, cycle: int) -> None:
        if self._faults is not None:
            # Same order as the serial retire: pending fault specs resolve
            # (and record their RECOVERED events) before the report boundary.
            self._faults.on_retire(self, run, cycle)
        self._active.remove(run)
        if run.trace is None:
            self._n_synth -= 1
        self.streams.mark_done(run.work)
        self.timeline.on_done(run.work.stream_id, run.desc.uid, cycle)
        sid = run.work.stream_id
        pos = self.engine._pos
        self._boundaries.append(pos)
        self._reports.append(_DeferredReport(
            sid=sid,
            uid=run.desc.uid,
            name=run.desc.name,
            cycle=cycle,
            boundary=pos,
            log_idx=len(self.log),
        ))
        self.log.append("")  # spliced with the rendered report at landing


def _journal_columns(sim: _BatchedSim):
    """Seal and merge one run's staged journal into six flat arrays; the
    merged (mutable) columns replace the staged chunks so the eventual
    ``flush`` lands exactly these arrays."""
    eng = sim.engine
    eng._seal_scalars()
    chunks = eng._chunks
    if not chunks:
        cols = (
            np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
            np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64),
            np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint8),
        )
    elif len(chunks) == 1:
        cols = chunks[0]
    else:
        cols = tuple(np.concatenate([c[k] for c in chunks]) for k in range(6))
    if cols[0].size:
        eng._chunks = [cols]
    return cols


def _land(sims: Sequence[_BatchedSim], ops) -> None:
    """The SoA landing pass: flush every run's journal, materialize every
    deferred report from one segment-scatter tensor, splice the logs."""
    if not sims:
        return
    eng0 = sims[0].engine
    n_t, n_out, n_fail = eng0._n_types, eng0._n_outcomes, eng0._n_fail

    # -- per-run journal gather + deferred clear_pw ----------------------------
    runs = []
    s_max = 0
    max_slots = 0
    for sim in sims:
        sid, at, col, cnt, cyc, lane = _journal_columns(sim)
        bounds = np.asarray(sim._boundaries, dtype=np.int64)
        if bounds.size:
            # Deferred clear_pw: the serial path zeroes the per-window store
            # at every exit, so only events after the *last* boundary may
            # land on the PW lane.
            lane[: bounds[-1]] &= _PW_STRIP
        uniq = np.unique(sid)
        runs.append((sim, sid, at, col, cnt, lane, bounds, uniq))
        if bounds.size > s_max:
            s_max = int(bounds.size)
        if uniq.size > max_slots:
            max_slots = int(uniq.size)

    # -- land the engines (one flush per run; clean lanes are
    #    flush-boundary-invariant, so this equals the serial incremental
    #    flushes bit for bit) -------------------------------------------------
    for sim in sims:
        sim.engine.flush()

    if s_max == 0:
        return  # no run produced a report (e.g. max_cycles exhausted)

    # -- one scatter for every report increment --------------------------------
    # Row layout: run-major, then report segment.  seg_rows = s_max + 1 gives
    # each run a private overflow row for post-final-boundary events, so no
    # per-event masking is needed here (events can never reach another run's
    # rows); the segment_scatter op's own >= n_segs drop path is covered by
    # the unit tests.
    seg_rows = s_max + 1
    n_rows = len(runs) * seg_rows
    row_cum = max(1, max_slots * n_t * n_out)
    row_fail = max(1, max_slots * n_t * n_fail)
    seg_c: List[np.ndarray] = []
    lin_c: List[np.ndarray] = []
    cnt_c: List[np.ndarray] = []
    seg_f: List[np.ndarray] = []
    lin_f: List[np.ndarray] = []
    cnt_f: List[np.ndarray] = []
    for r, (sim, sid, at, col, cnt, lane, bounds, uniq) in enumerate(runs):
        if not sid.size:
            continue
        slot = np.searchsorted(uniq, sid)
        pos = np.arange(sid.size, dtype=np.int64)
        # side="right": an event recorded *at* position B_i lands after the
        # i-th report, exactly like the serial flush-then-record ordering
        seg = np.searchsorted(bounds, pos, side="right") + r * seg_rows
        m = (lane & _LANE_CUM) != 0
        if m.any():
            seg_c.append(seg[m])
            lin_c.append(slot[m] * (n_t * n_out) + at[m] * n_out + col[m])
            cnt_c.append(cnt[m])
        m = (lane & _LANE_FAIL) != 0
        if m.any():
            seg_f.append(seg[m])
            lin_f.append(slot[m] * (n_t * n_fail) + at[m] * n_fail + col[m])
            cnt_f.append(cnt[m])

    def _table(segs, lins, cnts, row_size):
        if segs:
            tab = ops.segment_scatter(
                np.concatenate(segs), np.concatenate(lins),
                np.concatenate(cnts), n_rows, row_size,
            )
        else:
            tab = np.zeros((n_rows, row_size), dtype=np.uint64)
        tab = tab.reshape(len(runs), seg_rows, row_size)
        # cumulative down the segment axis: report s shows everything the
        # stream recorded before boundary s — uint64, exact mod 2**64
        return np.cumsum(tab, axis=1)

    cum_tab = _table(seg_c, lin_c, cnt_c, row_cum)
    fail_tab = _table(seg_f, lin_f, cnt_f, row_fail)

    # -- masked lockstep report stepping ---------------------------------------
    # Step s renders the s-th kernel exit of every run still live at that
    # step; runs with fewer reports are masked out.  Within a step, matrices
    # are O(1) slices of the landed tensor.
    zero_cum = np.zeros((n_t, n_out), dtype=np.uint64)
    zero_fail = np.zeros((n_t, n_fail), dtype=np.uint64)
    for s in range(s_max):
        for r, (sim, sid, at, col, cnt, lane, bounds, uniq) in enumerate(runs):
            if s >= len(sim._reports):
                continue  # run finished earlier — masked out of this step
            rep = sim._reports[s]
            i = int(np.searchsorted(uniq, rep.sid))
            if i < uniq.size and uniq[i] == rep.sid:
                base = i * n_t * n_out
                mat = cum_tab[r, s, base: base + n_t * n_out].reshape(n_t, n_out)
                base = i * n_t * n_fail
                fmat = fail_tab[r, s, base: base + n_t * n_fail].reshape(n_t, n_fail)
            else:
                mat, fmat = zero_cum, zero_fail  # stream recorded nothing yet
            buf = io.StringIO()
            buf.write(
                f"kernel '{rep.name}' uid {rep.uid} finished on stream "
                f"{rep.sid} @ cycle {rep.cycle}\n"
            )
            sim.timeline.print_kernel(buf, rep.sid, rep.uid)
            header = buf.getvalue()
            buf.write(format_breakdown("Total_core_cache_stats", rep.sid, mat))
            buf.write(format_breakdown(
                "Total_core_cache_fail_stats", rep.sid, fmat, fail=True))
            sim.log[rep.log_idx] = buf.getvalue().rstrip("\n")
            if sim.sinks:
                report = Report(
                    source="sim",
                    event="kernel_exit",
                    stream_id=rep.sid,
                    header=header,
                    fields={"kernel": rep.name, "uid": rep.uid, "cycle": rep.cycle},
                    blocks=[
                        StatBlock("Total_core_cache_stats", mat.copy()),
                        StatBlock("Total_core_cache_fail_stats", fmat.copy(),
                                  fail=True),
                    ],
                )
                for sink in sim.sinks:
                    sink.emit(report)

    for sim in sims:
        if sim.cfg.verbose:
            # the serial path printed each report as it happened; deferred
            # landing prints them per run, after the run's launch lines
            for rep in sim._reports:
                print(sim.log[rep.log_idx])


def run_batched_jobs(jobs: Sequence) -> List[Dict[str, object]]:
    """Worker body for ``BatchRunner(backend="batched")``: simulate every
    job in-process with deferred landing, land all runs at once, and return
    payloads in job order — the same payload shape (including failure
    payloads on exceptions) as the serial pool worker, so
    ``BatchResult.signature()`` compares bit-identical."""
    from .batch import _failure_payload, _payload, run_job
    from .scenarios import build

    payloads: List[Optional[Dict[str, object]]] = [None] * len(jobs)
    live = []  # (idx, job, inst, sim, res)
    ops = None
    for idx, job in enumerate(jobs):
        if job.engine == "compiled":
            # The compiled engine has its own landing discipline
            # (trace-compile/replay); run it through the serial worker body.
            try:
                payloads[idx] = run_job(job)
            except Exception as err:
                payloads[idx] = _failure_payload(job, err, 1)
            continue
        try:
            inst = build(job.scenario, **job.kwargs())
            sim = inst.make_sim(
                engine=job.engine, config=job.sim_config(), sim_cls=_BatchedSim)
            if ops is None:
                ops = sim._ops
            # All-synthetic workloads never read the bandwidth next-free
            # pointers (synth issue ignores occupy returns, and nothing in
            # SimResult.signature() observes them) — skip the occupy calls.
            # Any explicit trace re-enables them: trace accesses read
            # occupy returns and HBM saturation for their miss decisions.
            sim._occupy_bw = any(l.desc.trace is not None for l in inst.launches)
            res = sim.run()
        except Exception as err:
            payloads[idx] = _failure_payload(job, err, 1)
            continue
        live.append((idx, job, inst, sim, res))

    if live:
        if ops is None:  # pragma: no cover - live implies ops was set
            from ..core.array_ops import get_backend

            ops = get_backend()
        _land([entry[3] for entry in live], ops)
        for idx, job, inst, sim, res in live:
            try:
                payloads[idx] = _payload(job, inst, res)
            except Exception as err:
                payloads[idx] = _failure_payload(job, err, 1)
    return payloads  # type: ignore[return-value]
