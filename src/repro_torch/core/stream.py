"""Logical execution streams — the framework's CUDA-stream analog.

JAX/TPU exposes no user-visible stream API; the observable problem the paper
solves (statistics conflated across concurrent contexts) appears at the
framework layer: concurrent serving request streams, overlapped train/eval
lanes, tenants sharing a pod in the simulator.  ``Stream`` + ``StreamManager``
give those contexts identity and CUDA-like ordering semantics:

* work items on one stream run **in order** (FIFO);
* different streams may run **concurrently** (unless serialized, which
  reproduces the paper's ``busy_streams.size() == 0`` patch);
* cross-stream dependencies are expressed with events
  (``cudaStreamWaitEvent`` analog) — benchmark_1_stream.cu's "kernel 4 depends
  on kernel 2" is expressed this way.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .stats import DEFAULT_STREAM

__all__ = ["Stream", "StreamEvent", "StreamManager", "WorkItem"]


@dataclass(frozen=True)
class Stream:
    """A logical execution lane (CUDA-stream analog)."""

    stream_id: int
    name: str = ""
    priority: int = 0

    def __repr__(self) -> str:  # keep log lines short
        return f"Stream({self.stream_id}{', ' + self.name if self.name else ''})"


@dataclass
class StreamEvent:
    """``cudaEvent_t`` analog — recorded on a stream, waitable by others."""

    event_id: int
    recorded_after_uid: Optional[int] = None  # kernel uid it fires after
    fired: bool = False


@dataclass
class WorkItem:
    """A unit of stream work (kernel launch analog)."""

    uid: int
    stream_id: int
    name: str
    payload: object = None
    wait_events: Tuple[int, ...] = ()
    record_events: Tuple[int, ...] = ()
    launched: bool = False  # k->was_launched() analog
    done: bool = False


class StreamManager:
    """Registry + FIFO queues for all streams in a runtime or simulator.

    Mirrors the launch loop in Accel-Sim's ``main.cc``: kernels are launched
    when (a) their stream has no kernel in flight, (b) the device can start a
    kernel, and (c) — under the paper's serialization patch — no *other*
    stream is busy either.
    """

    def __init__(self) -> None:
        self._streams: Dict[int, Stream] = {DEFAULT_STREAM: Stream(DEFAULT_STREAM, "default")}
        self._queues: Dict[int, List[WorkItem]] = {DEFAULT_STREAM: []}
        self._events: Dict[int, StreamEvent] = {}
        self._busy_streams: List[int] = []  # busy_streams analog
        self._uid_counter = itertools.count(1)
        self._event_counter = itertools.count(1)
        self._lock = threading.Lock()

    # -- stream / event lifecycle ---------------------------------------------
    def create_stream(self, name: str = "", priority: int = 0) -> Stream:
        with self._lock:
            sid = max(self._streams) + 1
            s = Stream(sid, name or f"stream_{sid}", priority)
            self._streams[sid] = s
            self._queues[sid] = []
            return s

    def get_stream(self, stream_id: int) -> Stream:
        return self._streams[stream_id]

    def streams(self) -> Tuple[Stream, ...]:
        return tuple(self._streams[k] for k in sorted(self._streams))

    def create_event(self) -> StreamEvent:
        with self._lock:
            ev = StreamEvent(next(self._event_counter))
            self._events[ev.event_id] = ev
            return ev

    # -- enqueue ---------------------------------------------------------------
    def launch(
        self,
        stream_id: int,
        name: str,
        payload: object = None,
        wait_events: Sequence[int] = (),
        record_events: Sequence[int] = (),
    ) -> WorkItem:
        """Enqueue a kernel on a stream (``<<<..., stream>>>`` analog)."""
        if stream_id not in self._streams:
            raise KeyError(f"unknown stream {stream_id}")
        w = WorkItem(
            uid=next(self._uid_counter),
            stream_id=stream_id,
            name=name,
            payload=payload,
            wait_events=tuple(wait_events),
            record_events=tuple(record_events),
        )
        self._queues[stream_id].append(w)
        return w

    # -- scheduling (Accel-Sim main.cc launch-window loop analog) --------------
    def _launch_candidates(self, *, serialize: bool = False, can_start: bool = True):
        """Yield launchable kernels in selection order (highest stream
        priority first, then lowest stream id; FIFO head only) — the one
        definition of launch eligibility, shared by :meth:`launchable` and
        :meth:`next_launchable` so the two engine loops can never drift in
        scheduling.  All streams default to priority 0, where the order
        degenerates to the classic lowest-stream-id scan; a higher-priority
        stream (``cudaStreamCreateWithPriority`` analog) wins every contended
        launch slot."""
        if not can_start:
            return
        if serialize and self._busy_streams:
            return  # §5.1 patch: require busy_streams.size() == 0
        for sid in sorted(self._queues, key=lambda s: (-self._streams[s].priority, s)):
            if sid in self._busy_streams:
                continue  # stream_busy = true
            for w in self._queues[sid]:
                if w.done:
                    continue
                if w.launched:
                    break  # head of FIFO still in flight → stream busy
                if all(self._events[e].fired for e in w.wait_events if e in self._events):
                    yield w
                    if serialize:
                        return  # at most one kernel in flight globally
                break  # only the FIFO head is a candidate

    def launchable(self, *, serialize: bool = False, can_start: bool = True) -> List[WorkItem]:
        """Kernels that may start now.

        ``serialize=True`` reproduces the paper's §5.1 patch: additionally
        require ``busy_streams.size() == 0`` so streams run in isolation.
        """
        return list(self._launch_candidates(serialize=serialize, can_start=can_start))

    def next_launchable(self, *, serialize: bool = False, can_start: bool = True) -> Optional[WorkItem]:
        """First kernel that may start now — ``launchable(...)[0]`` without
        building the full candidate list.

        The event-driven executor calls this only on cycles where the
        candidate set can have changed (simulation start, and the cycle after
        a kernel retires — ``mark_done`` is the sole transition that frees a
        stream or fires an event), instead of scanning every queue every
        cycle.
        """
        return next(self._launch_candidates(serialize=serialize, can_start=can_start), None)

    def mark_launched(self, w: WorkItem) -> None:
        w.launched = True
        if w.stream_id not in self._busy_streams:
            self._busy_streams.append(w.stream_id)

    def mark_done(self, w: WorkItem) -> None:
        w.done = True
        if w.stream_id in self._busy_streams:
            self._busy_streams.remove(w.stream_id)
        for eid in w.record_events:
            ev = self._events.get(eid)
            if ev is not None:
                ev.fired = True

    def structure(self, payload_key: Optional[Callable[[object], object]] = None) -> Tuple:
        """Canonical structural digest of the whole launch graph: per stream
        (in id order) its priority and queued work rows — name, wait/record
        event ids, and ``payload_key(payload)`` (hashable; identity default).

        Two managers with equal structures enqueue *the same simulation*:
        stream ids, priorities, FIFO order, event wiring, and in-flight state
        (launched/done flags, fired events, busy streams) all appear, while
        run-varying identifiers (work uids, stream display names) do not.
        The compiled-trace engine keys its shape cache on this."""
        key = payload_key if payload_key is not None else (lambda p: p)
        streams = tuple(
            (
                sid,
                self._streams[sid].priority,
                tuple(
                    (w.name, w.wait_events, w.record_events, w.launched, w.done,
                     key(w.payload))
                    for w in self._queues[sid]
                ),
            )
            for sid in sorted(self._queues)
        )
        fired = tuple(sorted(e for e, ev in self._events.items() if ev.fired))
        return (streams, fired, tuple(self._busy_streams))

    # -- queries ---------------------------------------------------------------
    def pending(self) -> int:
        return sum(1 for q in self._queues.values() for w in q if not w.done)

    def busy_streams(self) -> Tuple[int, ...]:
        return tuple(self._busy_streams)

    def stream_of(self, uid: int) -> int:
        for sid, q in self._queues.items():
            for w in q:
                if w.uid == uid:
                    return sid
        raise KeyError(uid)
