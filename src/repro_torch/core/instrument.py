"""Runtime-side per-stream telemetry for *real* JAX training/serving loops.

The simulator (``repro.sim``) tracks cycle-level stats; this module is the
same idea applied to the live runtime: every jitted step executed by the
framework is attributed to a :class:`~repro.core.stream.Stream`, and the
quantities we *can* measure on a real host are recorded per stream:

* wall-clock start/end of each step  (``gpu_kernel_time`` analog, §3.2),
* tokens / samples processed,
* HLO FLOPs and HBM bytes of the compiled step (``compiled.cost_analysis()``),
* collective bytes of the compiled step (parsed from the lowered HLO),
* loss / custom scalar metrics.

The per-(type,outcome) *cache* matrix is a simulator-only concept — real TPUs
do not expose per-stream cache counters (that is precisely why the paper
instruments a simulator) — but byte/FLOP attribution per stream is real and
is what production observability needs.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, IO, Iterable, Iterator, List, Optional, Tuple

import sys

from .query import StatsFrame
from .sinks import Report, ReportSink, TextSink, stream_report
from .stats import DEFAULT_STREAM, StatTable, AccessType, AccessOutcome
from .timeline import KernelTimeline

__all__ = ["StepRecord", "StepCost", "StreamStats", "current_stream", "stream_scope"]


_tls = threading.local()


def current_stream() -> int:
    """The stream id active in this thread (default stream if none set)."""
    return getattr(_tls, "stream_id", DEFAULT_STREAM)


@contextlib.contextmanager
def stream_scope(stream_id: int) -> Iterator[int]:
    """Attribute all instrumented work in this scope to ``stream_id``."""
    prev = getattr(_tls, "stream_id", DEFAULT_STREAM)
    _tls.stream_id = stream_id
    try:
        yield stream_id
    finally:
        _tls.stream_id = prev


@dataclass(frozen=True)
class StepCost:
    """Static per-execution costs of a compiled step function."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0

    @classmethod
    def from_compiled(cls, compiled, collective_bytes: float = 0.0) -> "StepCost":
        ca = {}
        try:
            ca = compiled.cost_analysis() or {}
        except Exception:  # backends may not implement cost analysis
            ca = {}
        return cls(
            flops=float(ca.get("flops", 0.0)),
            hbm_bytes=float(ca.get("bytes accessed", 0.0)),
            collective_bytes=float(collective_bytes),
        )


@dataclass
class StepRecord:
    uid: int
    stream_id: int
    name: str
    t_start_ns: int
    t_end_ns: int = -1
    tokens: int = 0
    samples: int = 0
    metrics: Dict[str, float] = field(default_factory=dict)
    cost: StepCost = field(default_factory=StepCost)

    @property
    def seconds(self) -> float:
        if self.t_end_ns < 0:
            raise ValueError("step not finished")
        return (self.t_end_ns - self.t_start_ns) * 1e-9


class StreamStats:
    """Per-stream aggregation of live step records.

    Also maintains a :class:`StatTable` in *byte units* (GLOBAL/ICI rows) so
    live telemetry and simulator output share one report format, and a
    :class:`KernelTimeline` in nanoseconds so the paper's §3.2 per-kernel
    launch/exit tracking exists on the real runtime too.

    **Bounded memory** (docs/DESIGN.md §5.12): a long-running engine calls
    :meth:`retire_stream` when a stream's work is finished, which folds that
    stream's :class:`StepRecord` list into a small per-stream aggregate (and
    drops its timeline intervals).  :meth:`summary` / :meth:`streams` /
    :meth:`reports` answer identically before and after the fold — proven
    by an equality test — so the live state is O(live streams' records)
    plus one constant-size aggregate per retired stream, instead of one
    record per step per request forever.
    """

    def __init__(self) -> None:
        self.table = StatTable(name="Runtime_stats")
        self.timeline = KernelTimeline()
        self.records: List[StepRecord] = []
        #: stream id → folded sums of its retired records (see retire_stream)
        self._agg: Dict[int, Dict[str, float]] = {}
        self._uid = 0
        self._open: Dict[int, StepRecord] = {}
        self._lock = threading.Lock()

    # -- step lifecycle ---------------------------------------------------------
    def step_begin(self, name: str, stream_id: Optional[int] = None) -> int:
        sid = current_stream() if stream_id is None else stream_id
        with self._lock:
            self._uid += 1
            uid = self._uid
        rec = StepRecord(uid=uid, stream_id=sid, name=name, t_start_ns=time.perf_counter_ns())
        with self._lock:
            self._open[uid] = rec
        self.timeline.on_launch(sid, uid, rec.t_start_ns, name)
        return uid

    def step_end(
        self,
        uid: int,
        *,
        tokens: int = 0,
        samples: int = 0,
        cost: Optional[StepCost] = None,
        **metrics: float,
    ) -> StepRecord:
        with self._lock:
            rec = self._open.pop(uid)
        rec.t_end_ns = time.perf_counter_ns()
        rec.tokens = tokens
        rec.samples = samples
        rec.metrics.update(metrics)
        if cost is not None:
            rec.cost = cost
            # Mirror into the shared stat-table format (byte-granularity rows).
            self.table.inc_stats(AccessType.GLOBAL_ACC_R, AccessOutcome.MISS, rec.stream_id, int(cost.hbm_bytes))
            if cost.collective_bytes:
                self.table.inc_stats(AccessType.ICI_SND, AccessOutcome.MISS, rec.stream_id, int(cost.collective_bytes))
        self.timeline.on_done(rec.stream_id, uid, rec.t_end_ns)
        with self._lock:
            self.records.append(rec)
        return rec

    @contextlib.contextmanager
    def step(self, name: str, stream_id: Optional[int] = None, **end_kwargs):
        uid = self.step_begin(name, stream_id)
        try:
            yield uid
        finally:
            self.step_end(uid, **end_kwargs)

    # -- retirement (bounded memory) ----------------------------------------------
    def retire_stream(self, stream_id: int, *, drop_timeline: bool = True) -> int:
        """Fold every record of one finished stream into its per-stream
        aggregate and forget the records (plus, by default, the stream's
        timeline intervals).  Returns the number of records folded.

        Summaries are unchanged by construction: the fold computes exactly
        the sums :meth:`summary` would have computed over the same records
        in the same order, so ``summary(sid)`` before and after the fold is
        equal, float-for-float.  Call this once a stream can receive no more
        steps — e.g. the serving engine calls it when a request retires —
        and a million-request run holds one record per *live* step plus one
        small dict per retired stream, instead of every step ever."""
        with self._lock:
            mine = [r for r in self.records if r.stream_id == stream_id]
            if mine:
                self.records = [r for r in self.records if r.stream_id != stream_id]
            agg = self._agg.get(stream_id)
            if agg is None:
                agg = self._agg[stream_id] = {
                    "steps": 0, "seconds": 0.0, "tokens": 0, "flops": 0.0,
                    "hbm_bytes": 0.0, "collective_bytes": 0.0,
                }
            if mine:
                agg["steps"] += len(mine)
                agg["seconds"] += sum(r.seconds for r in mine)
                agg["tokens"] += sum(r.tokens for r in mine)
                agg["flops"] += sum(r.cost.flops for r in mine)
                agg["hbm_bytes"] += sum(r.cost.hbm_bytes for r in mine)
                agg["collective_bytes"] += sum(r.cost.collective_bytes for r in mine)
        if drop_timeline:
            self.timeline.drop_stream(stream_id)
        return len(mine)

    # -- per-stream summaries -----------------------------------------------------
    def streams(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self._agg) | {r.stream_id for r in self.records}))

    def summary(self, stream_id: int) -> Dict[str, float]:
        rs = [r for r in self.records if r.stream_id == stream_id]
        agg = self._agg.get(stream_id)
        if not rs and agg is None:
            return {"steps": 0}
        steps = (agg["steps"] if agg else 0) + len(rs)
        if steps == 0:
            return {"steps": 0}
        secs = agg["seconds"] if agg else 0.0
        toks = agg["tokens"] if agg else 0
        flops = agg["flops"] if agg else 0.0
        hbm = agg["hbm_bytes"] if agg else 0.0
        coll = agg["collective_bytes"] if agg else 0.0
        if rs:
            secs += sum(r.seconds for r in rs)
            toks += sum(r.tokens for r in rs)
            flops += sum(r.cost.flops for r in rs)
            hbm += sum(r.cost.hbm_bytes for r in rs)
            coll += sum(r.cost.collective_bytes for r in rs)
        return {
            "steps": steps,
            "seconds": secs,
            "tokens": toks,
            "tokens_per_s": toks / secs if secs > 0 else 0.0,
            "flops": flops,
            "flops_per_s": flops / secs if secs > 0 else 0.0,
            "hbm_bytes": hbm,
            "collective_bytes": coll,
        }

    def frame(self) -> StatsFrame:
        """The byte-attribution table + wall-clock timeline as a query frame
        (``stats.frame().filter(stream=train_stream, access_type="ICI_SND")
        .sum()`` — live-runtime collective bytes per stream)."""
        return StatsFrame(self.table, timeline=self.timeline)

    # -- reporting (sink subsystem; see repro.core.sinks) -------------------------
    def reports(self, source: str = "runtime") -> "list[Report]":
        """One :class:`Report` per stream — the summary line plus the
        byte-attribution block (a StatsFrame selection), consumable by any
        sink."""
        frame = self.frame()
        out = []
        for sid in self.streams():
            s = self.summary(sid)
            header = (
                f"stream {sid}: steps={s['steps']} tokens={s.get('tokens', 0)} "
                f"time={s.get('seconds', 0.0):.3f}s "
                f"tok/s={s.get('tokens_per_s', 0.0):.1f} "
                f"TFLOP/s={s.get('flops_per_s', 0.0) / 1e12:.3f}\n"
            )
            out.append(
                stream_report(
                    frame,
                    sid,
                    source=source,
                    event="stream_summary",
                    cache_name="Runtime_bytes",
                    header=header,
                    fields={k: v for k, v in s.items()},
                )
            )
        return out

    def emit(self, sinks: "Iterable[ReportSink]", source: str = "runtime") -> int:
        """Push every stream's summary report through the given sinks."""
        reports = self.reports(source)
        for sink in sinks:
            for rep in reports:
                sink.emit(rep)
        return len(reports)

    def print_summary(self, fout: IO[str] = sys.stdout) -> None:
        sink = TextSink(fout)
        for rep in self.reports():
            sink.emit(rep)
