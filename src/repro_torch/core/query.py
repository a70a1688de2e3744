"""StatsFrame — the typed, lazy per-stream query layer (public API centerpiece).

The paper's complaint is that aggregated stats "prevented users from properly
identifying the behavior of specific kernels and streams"; after re-keying
every store by stream, the remaining usability gap is *addressability*:
answering "L2 misses for stream 2 during kernel K" should be one expression,
not hand-built ``stream_matrix()`` index math.  :class:`StatsFrame` closes
that gap::

    f = StatsFrame(result.stats, timeline=result.timeline, names=ids)
    f.filter(stream="stream_2", outcome="MISS").sum()
    f.filter(view="fail").matrix()
    f.groupby("stream").sum()
    f.pivot(rows="stream", cols="outcome")
    f.during("produce_1").filter(outcome="MISS").sum()   # timeline join

Design rules
------------

* **Lazy** — a frame is a tiny immutable selector (source + view + axis
  filters + optional cycle window).  ``filter``/``during``/``between_kernels``
  return new frames without touching the data; nothing is read until a
  terminal op (``sum``/``matrix``/``to_dict``/…) runs.
* **Zero-copy** — frames never duplicate the engine's dense per-stream
  blocks.  :attr:`values` exposes the selected block as a read-only NumPy
  *view* when the source is a :class:`~repro.core.engine.StatsEngine`;
  terminal ops read through it.  (``matrix()`` returns a fresh array, like
  the legacy ``stream_matrix()`` — the *selection* is what stays free.)
* **Views** — ``view="tip"`` (cumulative per-stream), ``"pw"`` (per-window),
  ``"fail"`` (reservation-failure table), ``"clean"`` / ``"clean_fail"``
  (the baseline's aggregated lanes; no stream axis).
* **Names** — streams resolve by id *or* name (``names`` maps name → id,
  the :attr:`repro.sim.scenarios.ScenarioInstance.stream_ids` convention);
  access types and outcomes resolve by enum, int, or display name
  (``"MSHR_HIT"``, ``"RESERVATION_FAIL"`` — the paper's figure labels).
* **Timeline join** — with a :class:`~repro.core.timeline.KernelTimeline`
  attached, per-kernel cycle windows come from ``kernel_window()``; with an
  :class:`EventJournal` attached (``repro.api.simulate(keep_events=True)``),
  ``during()`` / ``between_kernels()`` / ``groupby("kernel")`` restrict the
  frame to those windows at event granularity.

``docs/API.md`` is the cookbook (the paper's §5 questions as worked
queries); ``benchmarks/query_overhead.py`` gates the report path built on
frames at ≤ 5% overhead vs the legacy ``format_breakdown`` path.
"""

from __future__ import annotations

import io
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .engine import StatsEngine, _LANE_CUM, _LANE_FAIL, _LANE_PW, _NO_CYCLE
from .stats import (
    AccessOutcome,
    AccessType,
    FailOutcome,
    StatTable,
    _outcome_name,
    _type_name,
)
from .timeline import KernelTime, KernelTimeline

__all__ = ["StatsFrame", "FrameGroupBy", "EventJournal", "QueryError"]

#: view name -> (uses the stream axis, event-journal lane bit or None)
_VIEWS: Dict[str, Tuple[bool, Optional[int]]] = {
    "tip": (True, _LANE_CUM),
    "pw": (True, _LANE_PW),
    "fail": (True, _LANE_FAIL),
    "clean": (False, None),
    "clean_fail": (False, None),
}

#: groupby/pivot axis names
_AXES = ("stream", "access_type", "outcome", "kernel", "tenant", "device")


class QueryError(ValueError):
    """A StatsFrame query needs something the frame was not built with
    (events for window queries, a timeline for kernel lookups, a stream axis
    for clean views) or names an unknown stream/type/outcome/kernel."""


class EventJournal(StatsEngine):
    """A :class:`StatsEngine` that additionally retains every landed event
    column (stream, type, column, count, cycle, lane) in landing order, so a
    :class:`StatsFrame` can answer cycle-window queries (``during`` /
    ``between_kernels`` / ``groupby("kernel")``) after the run.

    Opt-in by construction — ``repro.api.simulate(..., keep_events=True)``
    swaps one into the simulator before the first event lands (the same
    injection point the compiled-trace recorder uses).  Counts are identical
    to a plain engine's by construction: the journal only *observes* the
    flush, it never changes what lands.
    """

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self._ev_chunks: List[Tuple[np.ndarray, ...]] = []

    def _on_flush(self, sid, at, col, cnt, cyc, lane) -> None:
        self._ev_chunks.append((sid, at, col, cnt, cyc, lane))

    def clear(self) -> None:
        super().clear()
        self._ev_chunks = []

    def columns(self) -> Dict[str, np.ndarray]:
        """The full event journal as flat columns, in landing order."""
        self.flush()
        names = ("sid", "at", "col", "cnt", "cyc", "lane")
        if not self._ev_chunks:
            dt = dict(sid=np.int64, at=np.int64, col=np.int64, cnt=np.uint64,
                      cyc=np.int64, lane=np.uint8)
            return {c: np.zeros(0, dtype=dt[c]) for c in names}
        if len(self._ev_chunks) > 1:  # keep columns() cheap when called repeatedly
            self._ev_chunks = [tuple(
                np.concatenate([ch[i] for ch in self._ev_chunks]) for i in range(6)
            )]
        chunk = self._ev_chunks[0]
        return dict(zip(("sid", "at", "col", "cnt", "cyc", "lane"), chunk))


def _as_tuple(spec) -> tuple:
    if isinstance(spec, (str, int, np.integer)) or not isinstance(spec, Iterable):
        return (spec,)
    return tuple(spec)


class StatsFrame:
    """Lazy, zero-copy per-stream query frame (see module docstring).

    ``source`` is a :class:`~repro.core.engine.StatsEngine` (zero-copy dense
    path) or anything with the :class:`~repro.core.stats.StatTable` read API
    (``streams()`` / ``stream_matrix()`` — read per stream, no dense block).
    """

    __slots__ = ("_src", "_timeline", "_names", "_ids", "_tenants", "_devices",
                 "_events", "_view", "_streams", "_types", "_outcomes", "_window")

    def __init__(
        self,
        source,
        *,
        timeline: Optional[KernelTimeline] = None,
        names: Optional[Mapping[str, int]] = None,
        tenants: Optional[Mapping[int, str]] = None,
        devices: Optional[Mapping[int, int]] = None,
        events: Optional[EventJournal] = None,
        view: str = "tip",
    ) -> None:
        if view not in _VIEWS:
            raise QueryError(f"unknown view {view!r}; expected one of {sorted(_VIEWS)}")
        self._src = source
        self._timeline = timeline
        self._names: Dict[str, int] = dict(names or {})
        self._ids: Dict[int, str] = {sid: n for n, sid in self._names.items()}
        #: stream id → tenant label (the serving engine's per-tenant
        #: attribution; see docs/DESIGN.md §5.12)
        self._tenants: Dict[int, str] = dict(tenants or {})
        #: stream id → device id (the topology layer's per-device
        #: attribution; unattributed streams belong to device 0 — see
        #: docs/DESIGN.md §5.14)
        self._devices: Dict[int, int] = dict(devices or {})
        self._events = events if events is not None else (
            source if isinstance(source, EventJournal) else None
        )
        self._view = view
        self._streams: Optional[Tuple[int, ...]] = None  # None = all
        self._types: Optional[Tuple[int, ...]] = None
        self._outcomes: Optional[Tuple[int, ...]] = None
        self._window: Optional[Tuple[int, int]] = None  # inclusive cycle range

    # -- internal constructors ------------------------------------------------------
    _UNSET = object()

    def _derive(self, view=_UNSET, streams=_UNSET, types=_UNSET, outcomes=_UNSET,
                window=_UNSET) -> "StatsFrame":
        """A sibling frame with some selectors replaced (report hot path —
        keep allocation-only, no loops)."""
        new = StatsFrame.__new__(StatsFrame)
        unset = StatsFrame._UNSET
        new._src = self._src
        new._timeline = self._timeline
        new._names = self._names
        new._ids = self._ids
        new._tenants = self._tenants
        new._devices = self._devices
        new._events = self._events
        new._view = self._view if view is unset else view
        new._streams = self._streams if streams is unset else streams
        new._types = self._types if types is unset else types
        new._outcomes = self._outcomes if outcomes is unset else outcomes
        new._window = self._window if window is unset else window
        return new

    # -- axis resolution -------------------------------------------------------------
    def stream_id(self, stream: Union[int, str]) -> int:
        """Resolve a stream name (or pass through an id)."""
        if type(stream) is int:
            return stream
        if isinstance(stream, str):
            try:
                return self._names[stream]
            except KeyError:
                raise QueryError(
                    f"unknown stream name {stream!r}; known: {sorted(self._names)}"
                ) from None
        return int(stream)

    def stream_label(self, sid: int) -> Union[int, str]:
        """The stream's name when one is known, else its id."""
        return self._ids.get(sid, sid)

    def tenant_label(self, sid: int) -> str:
        """The tenant owning a stream (``""`` when unattributed)."""
        return self._tenants.get(sid, "")

    def _tenant_streams(self, tenant: str) -> Tuple[int, ...]:
        ids = tuple(sid for sid, t in self._tenants.items() if t == tenant)
        if not ids:
            raise QueryError(
                f"unknown tenant {tenant!r}; known: {sorted(set(self._tenants.values()))}"
            )
        return ids

    def device_label(self, sid: int) -> int:
        """The device owning a stream (``0`` when unattributed — single-chip
        runs keep every stream on device 0)."""
        return self._devices.get(sid, 0)

    def _device_streams(self, device: int) -> Tuple[int, ...]:
        """Present streams owned by ``device``.  Unmapped streams belong to
        device 0; a device id outside the map (and not 0) is an error."""
        d = int(device)
        known = {0} | set(self._devices.values())
        if d not in known:
            raise QueryError(f"unknown device {device!r}; known: {sorted(known)}")
        return tuple(
            sid for sid in self._src.streams() if self._devices.get(sid, 0) == d
        )

    def _resolve_type(self, t) -> int:
        if isinstance(t, str):
            try:
                return int(AccessType[t])
            except KeyError:
                raise QueryError(
                    f"unknown access type {t!r}; known: {[m.name for m in AccessType]}"
                ) from None
        return int(t)

    def _resolve_outcome(self, o) -> int:
        fail = self._view in ("fail", "clean_fail")
        if isinstance(o, str):
            if fail:
                try:
                    return int(FailOutcome[o])
                except KeyError:
                    raise QueryError(
                        f"unknown fail outcome {o!r}; known: {[m.name for m in FailOutcome]}"
                    ) from None
            for member in AccessOutcome:
                if o in (member.name, _outcome_name(int(member))):
                    return int(member)
            raise QueryError(
                f"unknown outcome {o!r}; known: "
                f"{sorted({m.name for m in AccessOutcome} | {_outcome_name(int(m)) for m in AccessOutcome})}"
            )
        return int(o)

    @staticmethod
    def _intersect(cur: Optional[tuple], new: tuple) -> tuple:
        if cur is None:
            return new
        keep = set(new)
        return tuple(v for v in cur if v in keep)

    # -- the lazy builders ------------------------------------------------------------
    def filter(
        self,
        *,
        stream=None,
        tenant=None,
        device=None,
        access_type=None,
        outcome=None,
        view: Optional[str] = None,
    ) -> "StatsFrame":
        """A narrowed frame.  Each axis accepts a single value or a sequence;
        successive filters intersect.  ``tenant`` selects every stream the
        frame's tenant map attributes to that tenant (serving engines build
        their frames with the map; see :attr:`repro.serve.engine.Engine.frame`).
        ``device`` selects every present stream the frame's device map places
        on that device (unmapped streams live on device 0; topology runs
        build their frames with the map — docs/DESIGN.md §5.14).  ``view``
        switches the stat store — switching to/from a fail view drops the
        outcome filter (the outcome axes are different enums)."""
        f = self
        if view is not None:
            if view not in _VIEWS:
                raise QueryError(f"unknown view {view!r}; expected one of {sorted(_VIEWS)}")
            if not _VIEWS[view][0] and f._streams is not None:
                raise QueryError(
                    f"cannot switch a stream-filtered frame to view {view!r} — the "
                    "clean lanes have no stream axis (drop the stream filter first)"
                )
            was_fail = f._view in ("fail", "clean_fail")
            is_fail = view in ("fail", "clean_fail")
            outcomes = None if was_fail != is_fail else f._outcomes
            f = f._derive(view=view, outcomes=outcomes)
        if tenant is not None:
            if not _VIEWS[f._view][0]:
                raise QueryError(f"view {f._view!r} has no stream axis")
            ids: Tuple[int, ...] = ()
            for t in _as_tuple(tenant):
                ids += f._tenant_streams(t)
            if f._streams is not None:
                ids = self._intersect(f._streams, ids)
            f = f._derive(streams=ids)
        if device is not None:
            if not _VIEWS[f._view][0]:
                raise QueryError(f"view {f._view!r} has no stream axis")
            ids = ()
            for d in _as_tuple(device):
                ids += f._device_streams(d)
            if f._streams is not None:
                ids = self._intersect(f._streams, ids)
            f = f._derive(streams=ids)
        if stream is not None:
            if not _VIEWS[f._view][0]:
                raise QueryError(f"view {f._view!r} has no stream axis")
            if type(stream) is int:  # report hot path: one plain stream id
                ids = (stream,)
            else:
                ids = tuple(f.stream_id(s) for s in _as_tuple(stream))
            if f._streams is not None:
                ids = self._intersect(f._streams, ids)
            f = f._derive(streams=ids)
        if access_type is not None:
            ts = tuple(f._resolve_type(t) for t in _as_tuple(access_type))
            f = f._derive(types=self._intersect(f._types, ts))
        if outcome is not None:
            os_ = tuple(f._resolve_outcome(o) for o in _as_tuple(outcome))
            f = f._derive(outcomes=self._intersect(f._outcomes, os_))
        return f

    # -- timeline join -----------------------------------------------------------------
    def _require_timeline(self) -> KernelTimeline:
        if self._timeline is None:
            raise QueryError("this frame was built without a timeline")
        return self._timeline

    def kernels(self, stream=None) -> List[Tuple[int, int, str, int, int]]:
        """Finished kernels as ``(stream_id, uid, name, start, end)`` rows,
        sorted by (start, stream, uid)."""
        tl = self._require_timeline()
        sel = None if stream is None else {self.stream_id(s) for s in _as_tuple(stream)}
        rows = [
            (sid, uid, name, start, end)
            for sid, uid, start, end, name in tl.intervals()
            if sel is None or sid in sel
        ]
        rows.sort(key=lambda r: (r[3], r[0], r[1]))
        return rows

    def _find_kernel(self, kernel, stream=None) -> Tuple[int, int, KernelTime]:
        """Resolve a kernel spec — name, uid, or (stream_id, uid) — to
        ``(stream_id, uid, KernelTime)``."""
        tl = self._require_timeline()
        if isinstance(kernel, tuple) and len(kernel) == 2:
            sid, uid = int(kernel[0]), int(kernel[1])
            try:
                return sid, uid, tl.get(sid, uid)
            except KeyError:
                raise QueryError(f"no kernel uid {uid} on stream {sid}") from None
        matches = []
        for sid, per in tl.gpu_kernel_time.items():
            if stream is not None and sid != self.stream_id(stream):
                continue
            for uid, kt in per.items():
                if (isinstance(kernel, str) and kt.name == kernel) or (
                    not isinstance(kernel, str) and uid == int(kernel)
                ):
                    matches.append((sid, uid, kt))
        if not matches:
            raise QueryError(f"no kernel matching {kernel!r} in the timeline")
        if len(matches) > 1:
            raise QueryError(
                f"kernel {kernel!r} is ambiguous ({len(matches)} matches); "
                "pass (stream_id, uid) or a stream= hint"
            )
        return matches[0]

    def kernel_window(self, kernel, stream=None) -> Tuple[int, int]:
        """The ``(start_cycle, end_cycle)`` window of one kernel."""
        _, _, kt = self._find_kernel(kernel, stream)
        if not kt.done:
            raise QueryError(f"kernel {kernel!r} never finished")
        return kt.start_cycle, kt.end_cycle

    def _windowed(self, lo: int, hi: int) -> "StatsFrame":
        if self._events is None:
            raise QueryError(
                "cycle-window queries need an event journal — build the run "
                "with repro.api.simulate(..., keep_events=True)"
            )
        if self._window is not None:
            lo, hi = max(lo, self._window[0]), min(hi, self._window[1])
        return self._derive(window=(lo, hi))

    def during(self, kernel, stream=None) -> "StatsFrame":
        """The frame restricted to one kernel's ``[start, end]`` cycles.

        Combined with a stream filter this is the paper's per-kernel
        question in one expression::

            f.during("gemm_0").filter(stream="req_1", outcome="MISS").sum()
        """
        lo, hi = self.kernel_window(kernel, stream)
        return self._windowed(lo, hi)

    def between_kernels(self, first, second, stream=None) -> "StatsFrame":
        """The frame restricted to the gap after ``first`` ends and before
        ``second`` starts (both exclusive — neither kernel's own events)."""
        _, _, ka = self._find_kernel(first, stream)
        _, _, kb = self._find_kernel(second, stream)
        if not ka.done:
            raise QueryError(f"kernel {first!r} never finished")
        return self._windowed(ka.end_cycle + 1, kb.start_cycle - 1)

    def between_cycles(self, start: int, end: int) -> "StatsFrame":
        """The frame restricted to the inclusive cycle range [start, end]."""
        return self._windowed(int(start), int(end))

    # -- source access ------------------------------------------------------------------
    def _geometry(self) -> Tuple[int, int]:
        """(n_types, n_cols) of the active view."""
        src = self._src
        fail = self._view in ("fail", "clean_fail")
        if self._view == "clean":
            m = src._clean.matrix if isinstance(src, StatsEngine) else src.matrix()
            return m.shape
        if self._view == "clean_fail":
            if not isinstance(src, StatsEngine):
                raise QueryError("clean_fail view needs a StatsEngine source")
            return src._clean_fail.matrix.shape
        return src._n_types, (src._n_fail if fail else src._n_outcomes)

    def streams(self) -> Tuple[int, ...]:
        """Selected stream ids actually present in the source (sorted)."""
        if not _VIEWS[self._view][0]:
            return ()
        present = self._src.streams()
        if self._streams is None:
            return tuple(present)
        keep = set(self._streams)
        return tuple(s for s in present if s in keep)

    def _raw_stream(self, sid: int, view: Optional[str] = None) -> Optional[np.ndarray]:
        """One stream's (T, O) block for the given (default: active) view —
        a *view* (no copy) whenever the source allows it, None when the
        stream is unknown."""
        v = self._view if view is None else view
        src = self._src
        if isinstance(src, StatsEngine):
            src.flush()
            slot = src._slots.get(sid)
            if slot is None:
                return None
            dense = src._fail if v == "fail" else (src._pw if v == "pw" else src._cum)
            return dense[slot]
        store = (
            src._fail_stats if v == "fail"
            else (src._stats_pw if v == "pw" else src._stats)
        )
        return store.get(sid)

    def stream_matrix(self, stream, *, view: Optional[str] = None) -> np.ndarray:
        """One stream's ``(T, n_cols)`` count matrix — the frame-native
        analog of the legacy ``stream_matrix`` accessor, honoring this
        frame's stream/axis filters (``view`` overrides the store for this
        read only; the report path grabs a stream's tip and fail matrices
        off one frame this way without deriving sub-frames)."""
        v = self._view if view is None else view
        info = _VIEWS.get(v)
        if info is None:
            raise QueryError(f"unknown view {v!r}; expected one of {sorted(_VIEWS)}")
        if not info[0]:
            raise QueryError(f"view {v!r} has no stream axis")
        sid = stream if type(stream) is int else self.stream_id(stream)
        src = self._src
        if self._window is not None or self._types is not None or self._outcomes is not None:
            # filtered/windowed reads go through a derived frame so the axis
            # masks apply with the right semantics — in particular a view
            # override crossing the tip/fail boundary drops the outcome
            # filter (different enum axis), exactly like filter(view=...)
            if self._streams is not None and sid not in self._streams:
                n_cols = src._n_fail if v == "fail" else src._n_outcomes
                return np.zeros((src._n_types, n_cols), dtype=np.uint64)
            cross = (self._view in ("fail", "clean_fail")) != (v in ("fail", "clean_fail"))
            return self._derive(
                view=v, streams=(sid,),
                outcomes=None if cross else self._outcomes,
            ).matrix()
        # hot path (report rendering): no filters, no window
        if self._streams is not None and sid not in self._streams:
            raw = None
        elif isinstance(src, StatsEngine):  # inlined _raw_stream
            src.flush()
            slot = src._slots.get(sid)
            if slot is None:
                raw = None
            else:
                dense = src._fail if v == "fail" else (src._pw if v == "pw" else src._cum)
                raw = dense[slot]
        else:
            raw = self._raw_stream(sid, v)
        if raw is None:
            n_cols = src._n_fail if v == "fail" else src._n_outcomes
            return np.zeros((src._n_types, n_cols), dtype=np.uint64)
        return raw.copy()

    @property
    def values(self) -> np.ndarray:
        """The selected per-stream block, stream-major — **read-only and
        zero-copy** (a view of the engine's dense store) when the source is
        a :class:`StatsEngine` and no stream filter / cycle window applies;
        a single-stream filter stays a zero-copy ``(1, T, O)`` view.  Other
        stream selections materialize a copy.  Axis filters and cycle
        windows cannot be represented as a raw store view, so frames
        carrying them refuse (use :meth:`matrix` / :meth:`sum`)."""
        if self._window is not None:
            raise QueryError("values is the raw store view; windowed frames read events")
        if self._types is not None or self._outcomes is not None:
            raise QueryError(
                "values is the raw store view and cannot honor access_type/outcome "
                "filters — use matrix() or sum() for filtered reads"
            )
        src = self._src
        if not _VIEWS[self._view][0]:
            if isinstance(src, StatsEngine):
                src.flush()
                m = src._clean.matrix if self._view == "clean" else src._clean_fail.matrix
            else:
                m = src._m  # CleanStatTable
            out = m.reshape((1,) + m.shape)
        elif isinstance(src, StatsEngine):
            src.flush()
            dense = src._fail if self._view == "fail" else (
                src._pw if self._view == "pw" else src._cum
            )
            if self._streams is None:
                out = dense[: len(src._slots)]
            elif len(self._streams) == 1:
                slot = src._slots.get(self._streams[0])
                out = (
                    dense[slot: slot + 1]
                    if slot is not None
                    else np.zeros((0,) + dense.shape[1:], dtype=np.uint64)
                )
            else:
                rows = [src._slots[s] for s in self._streams if s in src._slots]
                out = dense[rows] if rows else np.zeros((0,) + dense.shape[1:], dtype=np.uint64)
        else:
            blocks = [self._raw_stream(sid) for sid in self.streams()]
            blocks = [b for b in blocks if b is not None]
            t, o = self._geometry()
            out = np.stack(blocks) if blocks else np.zeros((0, t, o), dtype=np.uint64)
        view = out.view()
        view.flags.writeable = False
        return view

    # -- terminal ops -------------------------------------------------------------------
    def _axis_mask(self, m: np.ndarray) -> np.ndarray:
        """Zero the rows/cols outside the type/outcome filters (in place on
        the caller-owned matrix)."""
        if self._types is not None:
            keep = np.zeros(m.shape[0], dtype=bool)
            for t in self._types:
                if 0 <= t < m.shape[0]:
                    keep[t] = True
            m[~keep] = 0
        if self._outcomes is not None:
            keep = np.zeros(m.shape[1], dtype=bool)
            for o in self._outcomes:
                if 0 <= o < m.shape[1]:
                    keep[o] = True
            m[:, ~keep] = 0
        return m

    def _window_matrix(self) -> np.ndarray:
        lane_bit = _VIEWS[self._view][1]
        if lane_bit is None:
            raise QueryError(
                f"view {self._view!r} does not support cycle windows (the clean "
                "lanes drop events to emulate the §5.2 race; window sums would lie)"
            )
        cols = self._events.columns()
        lo, hi = self._window
        # _NO_CYCLE (< 0) events carry no cycle and never match a window.
        mask = ((cols["lane"] & lane_bit) != 0) & (cols["cyc"] >= max(lo, 0)) & (cols["cyc"] <= hi)
        if self._streams is not None:
            mask &= np.isin(cols["sid"], np.asarray(self._streams, dtype=np.int64))
        t, o = self._geometry()
        out = np.zeros((t, o), dtype=np.uint64)
        if mask.any():
            np.add.at(out, (cols["at"][mask], cols["col"][mask]), cols["cnt"][mask])
        return self._axis_mask(out)

    def matrix(self) -> np.ndarray:
        """The selected counts as a fresh ``(n_types, n_cols)`` uint64 matrix
        (summed over the selected streams; filtered-out cells are zero).
        For a single-stream tip frame this equals the legacy
        ``stream_matrix(sid)`` exactly — the report sinks rely on that."""
        if self._window is not None:
            return self._window_matrix()
        if (
            _VIEWS[self._view][0]  # streamless views never take the stream path
            and self._streams is not None
            and len(self._streams) == 1
        ):
            # report hot path: one stream, usually unfiltered axes
            raw = self._raw_stream(self._streams[0])
            if raw is None:
                t, o = self._geometry()
                m = np.zeros((t, o), dtype=np.uint64)
            else:
                m = raw.copy()
            if self._types is None and self._outcomes is None:
                return m
            return self._axis_mask(m)
        t, o = self._geometry()
        if not _VIEWS[self._view][0]:
            src = self._src
            if self._view == "clean":
                m = src.clean.matrix() if isinstance(src, StatsEngine) else src.matrix()
            else:
                m = src.clean_fail.matrix()
            return self._axis_mask(m)
        if self._streams is None and isinstance(self._src, StatsEngine):
            return self._axis_mask(self._src.aggregate(
                pw=self._view == "pw", fail=self._view == "fail"
            ))
        m = np.zeros((t, o), dtype=np.uint64)
        for sid in self.streams():
            raw = self._raw_stream(sid)
            if raw is not None:
                m += raw
        return self._axis_mask(m)

    def sum(self) -> int:
        """Total count over every selected cell."""
        return int(self.matrix().sum())

    def outcome_counts(self) -> Dict[str, int]:
        """The scenario-oracle key convention in one call:
        ``{"HIT", "MSHR_HIT", "MISS", "RES_FAIL", "VICTIM_HIT",
        "MISS_CACHE_HIT", "PREFETCH_HIT", "PREFETCH_ISSUED", "ICI_HOPS",
        "KERNEL_ABORT", "RETRY", "TIMEOUT_EXPIRED", "SHED", "RECOVERED",
        "TOTAL"}`` summed over the selected streams/types.  ``TOTAL`` counts
        each successful demand access once — HIT + MSHR_HIT + MISS plus the
        three miss-path mechanism hit lanes — so it is mechanism-invariant;
        failures retry, so they are excluded (see ``repro.sim.scenarios``).
        ``PREFETCH_ISSUED`` sums the :data:`AccessType.PREFETCH` traffic
        row and ``ICI_HOPS`` the :data:`AccessType.ICI_HOP` per-link traffic
        row (docs/DESIGN.md §5.14), both excluded from every demand key; the
        fault-injection bookkeeping row (:data:`AccessType.FAULT`,
        docs/DESIGN.md §5.11) and the serve-layer SLO row
        (:data:`AccessType.SLO`, §5.12) are likewise excluded — fault lanes
        surface under their own keys and never perturb ``TOTAL``.  Only
        meaningful on an access-outcome axis: fail views (whose columns are
        ``FailOutcome`` reasons) are rejected."""
        if self._view in ("fail", "clean_fail"):
            raise QueryError(
                f"outcome_counts() reads AccessOutcome columns; view {self._view!r} "
                "has a FailOutcome axis (RES_FAIL already comes from the tip view's "
                "RESERVATION_FAILURE column)"
            )
        m = self.matrix()

        def col(out):
            # zero column for tables predating an outcome's introduction
            if int(out) >= m.shape[1]:
                return np.zeros(m.shape[0], dtype=m.dtype)
            return m[:, int(out)]

        pf_row = int(AccessType.PREFETCH)
        demand = np.ones(m.shape[0], dtype=bool)
        if pf_row < m.shape[0]:
            pf_issued = int(m[pf_row].sum())
            demand[pf_row] = False
        else:
            pf_issued = 0
        fault_row = int(AccessType.FAULT)
        if fault_row < m.shape[0]:
            demand[fault_row] = False
        # the serve-layer SLO row counts microseconds/tokens, never accesses
        slo_row = int(AccessType.SLO)
        if slo_row < m.shape[0]:
            demand[slo_row] = False
        # per-link hop traffic (topology runs): traffic, not demand
        hop_row = int(AccessType.ICI_HOP)
        if hop_row < m.shape[0]:
            ici_hops = int(m[hop_row].sum())
            demand[hop_row] = False
        else:
            ici_hops = 0
        got = {
            "HIT": int(col(AccessOutcome.HIT)[demand].sum()),
            "MSHR_HIT": int(col(AccessOutcome.HIT_RESERVED)[demand].sum()),
            "MISS": int(col(AccessOutcome.MISS)[demand].sum()),
            "RES_FAIL": int(col(AccessOutcome.RESERVATION_FAILURE)[demand].sum()),
            "VICTIM_HIT": int(col(AccessOutcome.VICTIM_HIT)[demand].sum()),
            "MISS_CACHE_HIT": int(col(AccessOutcome.MISS_CACHE_HIT)[demand].sum()),
            "PREFETCH_HIT": int(col(AccessOutcome.PREFETCH_HIT)[demand].sum()),
            "PREFETCH_ISSUED": pf_issued,
            "ICI_HOPS": ici_hops,
            # fault lanes (KERNEL_ABORT..RECOVERED live on the FAULT row, but
            # serve/pool layers may attribute them on other rows too — sum
            # the whole column; demand rows never record these outcomes)
            "KERNEL_ABORT": int(col(AccessOutcome.KERNEL_ABORT).sum()),
            "RETRY": int(col(AccessOutcome.RETRY).sum()),
            "TIMEOUT_EXPIRED": int(col(AccessOutcome.TIMEOUT_EXPIRED).sum()),
            "SHED": int(col(AccessOutcome.SHED).sum()),
            "RECOVERED": int(col(AccessOutcome.RECOVERED).sum()),
        }
        got["TOTAL"] = (
            got["HIT"] + got["MSHR_HIT"] + got["MISS"]
            + got["VICTIM_HIT"] + got["MISS_CACHE_HIT"] + got["PREFETCH_HIT"]
        )
        return got

    # -- grouping -----------------------------------------------------------------------
    def groupby(self, key: str) -> "FrameGroupBy":
        """Group by ``"stream"`` / ``"access_type"`` / ``"outcome"`` /
        ``"kernel"`` (kernel grouping = each kernel's own stream over its
        timeline window; needs a timeline + events) / ``"tenant"`` (streams
        rolled up by the frame's tenant map; unattributed streams group
        under ``""``) / ``"device"`` (streams rolled up by the frame's
        device map; unattributed streams group under device ``0``)."""
        if key not in _AXES:
            raise QueryError(f"unknown groupby key {key!r}; expected one of {_AXES}")
        return FrameGroupBy(self, key)

    def pivot(self, rows: str = "stream", cols: str = "outcome"):
        """``(row_labels, col_labels, int64 matrix)`` of summed counts.

        Column labels are the union over every row's groups in first-seen
        order (row groups can expose different columns — e.g. each stream
        owns different *kernels*); a cell whose column never occurs in its
        row is 0."""
        if rows == cols:
            raise QueryError("pivot needs two distinct axes")
        row_groups = self.groupby(rows).frames()
        row_labels = list(row_groups)
        per_row: List[Dict] = [f.groupby(cols).frames() for f in row_groups.values()]
        col_labels: List = []
        seen = set()
        for cgroups in per_row:
            for c in cgroups:
                if c not in seen:
                    seen.add(c)
                    col_labels.append(c)
        table = [
            [cgroups[c].sum() if c in cgroups else 0 for c in col_labels]
            for cgroups in per_row
        ]
        shape = (len(row_labels), len(col_labels))
        return row_labels, col_labels, np.asarray(table, dtype=np.int64).reshape(shape)

    # -- export -------------------------------------------------------------------------
    def _cells(self):
        """Nonzero selected cells: (stream_label, type_idx, out_idx, count)."""
        fail = self._view in ("fail", "clean_fail")
        if not _VIEWS[self._view][0]:
            m = self.matrix()
            for t, o in zip(*np.nonzero(m)):
                yield "ALL", int(t), int(o), int(m[t, o]), fail
            return
        for sid in self.streams():
            m = self.filter(stream=sid).matrix()
            label = self.stream_label(sid)
            for t, o in zip(*np.nonzero(m)):
                yield label, int(t), int(o), int(m[t, o]), fail

    def to_dict(self) -> dict:
        """Plain nested structure:
        ``{stream_label: {type_name: {outcome_name: count}}}``."""
        out: Dict = {}
        for label, t, o, v, fail in self._cells():
            out.setdefault(str(label), {}).setdefault(_type_name(t), {})[
                _outcome_name(o, fail=fail)
            ] = v
        return out

    def to_csv(self) -> str:
        """CSV (``view,stream,access_type,outcome,count``), nonzero cells."""
        buf = io.StringIO()
        buf.write("view,stream,access_type,outcome,count\n")
        for label, t, o, v, fail in self._cells():
            buf.write(
                f"{self._view},{label},{_type_name(t)},{_outcome_name(o, fail=fail)},{v}\n"
            )
        return buf.getvalue()

    def __repr__(self) -> str:
        parts = [f"view={self._view!r}"]
        if self._streams is not None:
            parts.append(f"streams={[self.stream_label(s) for s in self._streams]}")
        if self._types is not None:
            parts.append(f"types={[_type_name(t) for t in self._types]}")
        if self._outcomes is not None:
            fail = self._view in ("fail", "clean_fail")
            parts.append(f"outcomes={[_outcome_name(o, fail=fail) for o in self._outcomes]}")
        if self._window is not None:
            parts.append(f"window={self._window}")
        return f"StatsFrame({', '.join(parts)})"


class FrameGroupBy:
    """Lazy group handle from :meth:`StatsFrame.groupby`."""

    def __init__(self, frame: StatsFrame, key: str) -> None:
        self._frame = frame
        self._key = key

    def frames(self) -> Dict:
        """Ordered ``{label: sub-frame}`` — one narrowed frame per group."""
        f = self._frame
        out: Dict = {}
        if self._key == "stream":
            for sid in f.streams():
                out[f.stream_label(sid)] = f.filter(stream=sid)
        elif self._key == "tenant":
            # one sub-frame per tenant over the *present* selected streams,
            # in first-seen stream order (stable rollup for reports)
            members: Dict[str, list] = {}
            for sid in f.streams():
                members.setdefault(f.tenant_label(sid), []).append(sid)
            for label, sids in members.items():
                out[label] = f._derive(streams=tuple(sids))
        elif self._key == "device":
            # one sub-frame per device over the *present* selected streams,
            # in device-id order (stable rollup for reports); unmapped
            # streams land on device 0
            dev_members: Dict[int, list] = {}
            for sid in f.streams():
                dev_members.setdefault(f.device_label(sid), []).append(sid)
            for label in sorted(dev_members):
                out[label] = f._derive(streams=tuple(dev_members[label]))
        elif self._key == "access_type":
            n_t, _ = f._geometry()
            sel = f._types if f._types is not None else range(n_t)
            for t in sel:
                out[_type_name(int(t))] = f.filter(access_type=int(t))
        elif self._key == "outcome":
            _, n_o = f._geometry()
            fail = f._view in ("fail", "clean_fail")
            sel = f._outcomes if f._outcomes is not None else range(n_o)
            for o in sel:
                out[_outcome_name(int(o), fail=fail)] = f.filter(outcome=int(o))
        else:  # kernel
            # honor the frame's stream filter: only the selected streams'
            # kernels become groups (no phantom zero-count groups)
            rows = f.kernels(stream=f._streams)
            names = [r[2] for r in rows]
            for sid, uid, name, start, end in rows:
                label = name if names.count(name) == 1 else f"{name}#{uid}"
                out[label] = f.between_cycles(start, end).filter(stream=sid)
        return out

    def sum(self) -> Dict:
        """``{label: total count}`` per group."""
        return {label: sub.sum() for label, sub in self.frames().items()}

    def matrix(self) -> Dict:
        """``{label: (T, O) matrix}`` per group."""
        return {label: sub.matrix() for label, sub in self.frames().items()}
