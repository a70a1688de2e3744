"""Per-stream, per-kernel launch/exit tracking — paper §3.2.

The paper adds to ``gpu-sim.h``::

    typedef struct { unsigned long long start_cycle, end_cycle; } kernel_time_t;
    std::map<unsigned long long, std::map<unsigned, kernel_time_t>> gpu_kernel_time;
    unsigned long long last_streamID;
    unsigned long long last_uid;

updated in ``gpgpu_sim::launch`` / ``gpgpu_sim::set_kernel_done`` and printed
with each kernel's stats.  :class:`KernelTimeline` is that structure plus the
overlap/utilisation queries the paper's Figures 2–5 timelines are drawn from.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, IO, Iterable, List, Optional, Tuple

import sys

__all__ = ["KernelTime", "KernelTimeline"]

_UNFINISHED = 0xFFFF_FFFF_FFFF_FFFF


@dataclass
class KernelTime:
    """``kernel_time_t`` analog."""

    start_cycle: int
    end_cycle: int = _UNFINISHED
    name: str = ""

    @property
    def done(self) -> bool:
        return self.end_cycle != _UNFINISHED

    @property
    def duration(self) -> int:
        if not self.done:
            raise ValueError("kernel not finished")
        return self.end_cycle - self.start_cycle


class KernelTimeline:
    """``gpu_kernel_time`` analog: streamID → {kernel uid → (start, end)}."""

    def __init__(self) -> None:
        self.gpu_kernel_time: Dict[int, Dict[int, KernelTime]] = {}
        self.last_streamID: int = 0
        self.last_uid: int = 0

    # -- update points (gpgpu_sim::launch / ::set_kernel_done analogs) -------
    def on_launch(self, stream_id: int, uid: int, cycle: int, name: str = "") -> None:
        per_stream = self.gpu_kernel_time.setdefault(stream_id, {})
        if uid in per_stream:
            raise ValueError(f"kernel uid {uid} launched twice on stream {stream_id}")
        per_stream[uid] = KernelTime(start_cycle=cycle, name=name)
        self.last_streamID = stream_id
        self.last_uid = uid

    def on_done(self, stream_id: int, uid: int, cycle: int) -> None:
        try:
            kt = self.gpu_kernel_time[stream_id][uid]
        except KeyError:
            raise KeyError(f"kernel uid {uid} on stream {stream_id} was never launched") from None
        if kt.done:
            raise ValueError(f"kernel uid {uid} on stream {stream_id} finished twice")
        kt.end_cycle = cycle
        self.last_streamID = stream_id
        self.last_uid = uid

    def drop_stream(self, stream_id: int) -> int:
        """Forget every interval recorded for one stream (long-running
        engines drop retired request streams so the timeline stays O(live);
        see :meth:`repro.core.instrument.StreamStats.retire_stream`).
        Returns how many intervals were dropped."""
        per = self.gpu_kernel_time.pop(stream_id, None)
        return 0 if per is None else len(per)

    # -- queries ---------------------------------------------------------------
    def get(self, stream_id: int, uid: int) -> KernelTime:
        return self.gpu_kernel_time[stream_id][uid]

    def streams(self) -> Tuple[int, ...]:
        return tuple(sorted(self.gpu_kernel_time))

    def kernels(self, stream_id: int) -> List[Tuple[int, KernelTime]]:
        return sorted(self.gpu_kernel_time.get(stream_id, {}).items())

    def intervals(self) -> List[Tuple[int, int, int, int, str]]:
        """(stream, uid, start, end, name) for every finished kernel."""
        out = []
        for sid, per in self.gpu_kernel_time.items():
            for uid, kt in per.items():
                if kt.done:
                    out.append((sid, uid, kt.start_cycle, kt.end_cycle, kt.name))
        out.sort(key=lambda t: (t[2], t[0], t[1]))
        return out

    def overlap_cycles(self, stream_a: int, stream_b: int) -> int:
        """Total cycles during which *any* kernel of a overlaps any of b —
        the quantity the paper's timing diagrams (Fig 1/2/5) visualise."""

        def merged(stream: int) -> List[Tuple[int, int]]:
            ivs = sorted(
                (kt.start_cycle, kt.end_cycle)
                for _, kt in self.gpu_kernel_time.get(stream, {}).items()
                if kt.done
            )
            out: List[Tuple[int, int]] = []
            for s, e in ivs:
                if out and s <= out[-1][1]:
                    out[-1] = (out[-1][0], max(out[-1][1], e))
                else:
                    out.append((s, e))
            return out

        total = 0
        for sa, ea in merged(stream_a):
            for sb, eb in merged(stream_b):
                total += max(0, min(ea, eb) - max(sa, sb))
        return total

    def state(self) -> Tuple:
        """Canonical comparable snapshot: every kernel's (stream, uid, start,
        end, name) — unfinished kernels included — plus the last-updated
        markers.  Two timelines produced by different engine loops (the
        cycle-stepped and the cycle-skipping one) must compare equal; the
        cross-engine identity suite relies on this."""
        rows = []
        for sid, per in self.gpu_kernel_time.items():
            for uid, kt in per.items():
                rows.append((sid, uid, kt.start_cycle, kt.end_cycle, kt.name))
        rows.sort()
        return (tuple(rows), self.last_streamID, self.last_uid)

    @classmethod
    def from_state(cls, state: Tuple) -> "KernelTimeline":
        """Rebuild a timeline from a :meth:`state` snapshot (the compiled
        engine's replay path).  ``from_state(t.state()).state() == t.state()``
        for every timeline ``t``."""
        rows, last_sid, last_uid = state
        tl = cls()
        for sid, uid, start, end, name in rows:
            per_stream = tl.gpu_kernel_time.setdefault(sid, {})
            per_stream[uid] = KernelTime(start_cycle=start, end_cycle=end, name=name)
        tl.last_streamID = last_sid
        tl.last_uid = last_uid
        return tl

    def makespan(self) -> int:
        ivs = self.intervals()
        if not ivs:
            return 0
        return max(e for _, _, _, e, _ in ivs) - min(s for _, _, s, _, _ in ivs)

    def serialized_span(self) -> int:
        """Sum of kernel durations — what the makespan would be if streams
        were serialized (the paper's ``tip_serialized`` configuration)."""
        return sum(e - s for _, _, s, e, _ in self.intervals())

    # -- printing (appended to each kernel's stat dump, per the paper) --------
    def print_kernel(self, fout: IO[str], stream_id: int, uid: int) -> None:
        kt = self.get(stream_id, uid)
        end = kt.end_cycle if kt.done else -1
        fout.write(
            f"kernel_launch_uid = {uid} stream = {stream_id} "
            f"start_cycle = {kt.start_cycle} end_cycle = {end}\n"
        )

    def print_stream(self, fout: IO[str] = sys.stdout, stream_id: int = 0) -> None:
        for uid, _ in self.kernels(stream_id):
            self.print_kernel(fout, stream_id, uid)

    def ascii_timeline(self, width: int = 72) -> str:
        """Render the Fig-2/5-style per-stream timeline as ASCII art."""
        ivs = self.intervals()
        if not ivs:
            return "(empty timeline)"
        t0 = min(s for _, _, s, _, _ in ivs)
        t1 = max(e for _, _, _, e, _ in ivs)
        span = max(1, t1 - t0)
        lines = []
        for sid in self.streams():
            row = [" "] * width
            for uid, kt in self.kernels(sid):
                if not kt.done:
                    continue
                a = int((kt.start_cycle - t0) / span * (width - 1))
                b = max(a + 1, int((kt.end_cycle - t0) / span * (width - 1)))
                ch = chr(ord("A") + (uid % 26))
                for i in range(a, min(b, width)):
                    row[i] = ch
            lines.append(f"stream {sid:>3} |{''.join(row)}|")
        lines.append(f"cycles {t0} .. {t1}")
        return "\n".join(lines)
