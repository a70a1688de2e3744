"""Pluggable report sinks — one reporting code path for every subsystem.

The seed had three ad-hoc printers: the simulator's kernel-exit dump
(``sim/executor.py``), the serving engine's request exit report
(``serve/engine.py``) and the live-runtime summary
(``core/instrument.py``).  All three now build a :class:`Report` and hand it
to whatever sinks the caller plugged in:

* :class:`TextSink` — the per-kernel-exit printer, byte-identical to the
  seed output (it renders stat blocks through
  :func:`repro.core.stats.format_breakdown`, the same formatter the legacy
  ``print_stats`` path uses);
* :class:`JSONSink` — newline-delimited JSON, one object per report;
* :class:`CSVSink`  — one row per nonzero stat cell.

``make_sink("text" | "json" | "csv", fout)`` builds one by name;
:class:`MultiSink` fans a report out to several.  See docs/DESIGN.md §5.
"""

from __future__ import annotations

import csv
import io
import json
from dataclasses import dataclass, field
from typing import IO, Dict, Iterable, List, Sequence

import numpy as np

from .stats import format_breakdown, _outcome_name, _type_name

__all__ = [
    "StatBlock",
    "Report",
    "ReportSink",
    "TextSink",
    "JSONSink",
    "CSVSink",
    "MultiSink",
    "make_sink",
    "render_text",
    "merged_report",
    "frame_block",
    "stream_report",
    "ALL_STREAMS",
    "SINK_KINDS",
]

#: ``Report.stream_id`` value meaning "aggregated over every stream" — used
#: by multi-run merge reports, where a single stream id no longer applies.
ALL_STREAMS = -1


@dataclass
class StatBlock:
    """One named per-stream count matrix inside a report."""

    cache_name: str
    matrix: np.ndarray  # (n_types, n_outcomes) uint64
    fail: bool = False  # outcome axis uses FailOutcome names


@dataclass
class Report:
    """A per-stream reporting event (kernel exit, request done, summary)."""

    source: str  # emitting subsystem: "sim" / "serve" / "train" / ...
    event: str  # "kernel_exit" / "request_done" / "stream_summary" / ...
    stream_id: int
    header: str = ""  # preformatted header lines (text sink only)
    fields: Dict[str, object] = field(default_factory=dict)
    blocks: List[StatBlock] = field(default_factory=list)


class ReportSink:
    """Base sink: receives reports, owns no formatting of its own."""

    def emit(self, report: Report) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class TextSink(ReportSink):
    """Seed-format text printer: header lines, then each stat block via the
    canonical breakdown formatter."""

    def __init__(self, fout: IO[str]) -> None:
        self.fout = fout

    def emit(self, report: Report) -> None:
        if report.header:
            self.fout.write(report.header)
        for b in report.blocks:
            self.fout.write(format_breakdown(b.cache_name, report.stream_id, b.matrix, fail=b.fail))


def _block_cells(block: StatBlock) -> Iterable:
    m = block.matrix
    for t, o in zip(*np.nonzero(m)):
        yield int(t), int(o), _type_name(int(t)), _outcome_name(int(o), fail=block.fail), int(m[t, o])


class JSONSink(ReportSink):
    """Newline-delimited JSON: one self-describing object per report."""

    def __init__(self, fout: IO[str]) -> None:
        self.fout = fout

    def emit(self, report: Report) -> None:
        obj = {
            "source": report.source,
            "event": report.event,
            "stream_id": report.stream_id,
            "fields": {k: v for k, v in report.fields.items()},
            "blocks": [
                {
                    "cache_name": b.cache_name,
                    "fail": b.fail,
                    "shape": list(b.matrix.shape),
                    "cells": [
                        {"type": t, "outcome": o, "type_name": tn, "outcome_name": on, "count": v}
                        for t, o, tn, on, v in _block_cells(b)
                    ],
                }
                for b in report.blocks
            ],
        }
        self.fout.write(json.dumps(obj) + "\n")

    @staticmethod
    def parse(text: str) -> List[dict]:
        """Inverse of :meth:`emit` for a whole NDJSON document."""
        return [json.loads(line) for line in text.splitlines() if line.strip()]

    @staticmethod
    def block_matrix(block_obj: dict) -> np.ndarray:
        """Rebuild a block's count matrix from its parsed JSON object."""
        m = np.zeros(tuple(block_obj["shape"]), dtype=np.uint64)
        for cell in block_obj["cells"]:
            m[cell["type"], cell["outcome"]] = np.uint64(cell["count"])
        return m


CSV_HEADER = ("source", "event", "stream_id", "cache_name", "access_type", "outcome", "count")


class CSVSink(ReportSink):
    """One CSV row per nonzero stat cell; header written lazily."""

    def __init__(self, fout: IO[str]) -> None:
        self.fout = fout
        self._writer = csv.writer(fout, lineterminator="\n")
        self._wrote_header = False

    def emit(self, report: Report) -> None:
        if not self._wrote_header:
            self._writer.writerow(CSV_HEADER)
            self._wrote_header = True
        for b in report.blocks:
            for _t, _o, tn, on, v in _block_cells(b):
                self._writer.writerow(
                    (report.source, report.event, report.stream_id, b.cache_name, tn, on, v)
                )

    @staticmethod
    def parse(text: str) -> List[dict]:
        """Rows as dicts keyed by :data:`CSV_HEADER` (counts as ints)."""
        rows = list(csv.reader(io.StringIO(text)))
        if not rows:
            return []
        header, body = rows[0], rows[1:]
        out = []
        for r in body:
            d = dict(zip(header, r))
            d["stream_id"] = int(d["stream_id"])
            d["count"] = int(d["count"])
            out.append(d)
        return out


class MultiSink(ReportSink):
    """Fan one report out to several sinks."""

    def __init__(self, sinks: Sequence[ReportSink]) -> None:
        self.sinks = list(sinks)

    def emit(self, report: Report) -> None:
        for s in self.sinks:
            s.emit(report)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


SINK_KINDS = {"text": TextSink, "json": JSONSink, "csv": CSVSink}


def make_sink(kind: str, fout: IO[str]) -> ReportSink:
    try:
        return SINK_KINDS[kind](fout)
    except KeyError:
        raise ValueError(f"unknown sink kind {kind!r}; expected one of {sorted(SINK_KINDS)}") from None


def render_text(report: Report) -> str:
    """Convenience: the exact text a :class:`TextSink` would write."""
    buf = io.StringIO()
    TextSink(buf).emit(report)
    return buf.getvalue()


def frame_block(frame, cache_name: str, *, stream=None, view: str = None) -> StatBlock:
    """One :class:`StatBlock` materialized from a
    :class:`~repro.core.query.StatsFrame` selection.

    ``view``/``stream`` narrow the frame first (``view="fail"`` marks the
    block's outcome axis as failure reasons).  For a single-stream tip/fail
    selection the matrix equals the legacy ``stream_matrix()`` exactly, so
    text rendering through :func:`format_breakdown` stays byte-identical to
    the pre-frame report path — ``benchmarks/query_overhead.py`` gates it."""
    f = frame if view is None else frame.filter(view=view)
    if stream is not None:
        f = f.filter(stream=stream)
    return StatBlock(cache_name, f.matrix(), fail=f._view in ("fail", "clean_fail"))


def stream_report(
    frame,
    stream,
    *,
    source: str,
    event: str,
    cache_name: str,
    fail_cache_name: str = None,
    header: str = "",
    fields: Dict[str, object] = None,
) -> Report:
    """The canonical per-stream exit report, rendered from a
    :class:`~repro.core.query.StatsFrame`: the stream's tip matrix under
    ``cache_name`` plus (when ``fail_cache_name`` is given) its failure
    matrix.  This is the one report shape the simulator's kernel-exit, the
    serving engine's request-done and the runtime summary all emit."""
    sid = stream if type(stream) is int else frame.stream_id(stream)
    if fail_cache_name is None:
        blocks = [StatBlock(cache_name, frame.stream_matrix(sid))]
    else:
        blocks = [
            StatBlock(cache_name, frame.stream_matrix(sid)),
            StatBlock(fail_cache_name, frame.stream_matrix(sid, view="fail"), fail=True),
        ]
    return Report(
        source=source,
        event=event,
        stream_id=sid,
        header=header,
        fields=fields if fields is not None else {},  # report takes ownership
        blocks=blocks,
    )


def merged_report(
    stats,
    *,
    source: str = "batch",
    event: str = "batch_merged",
    fields: Dict[str, object] = None,
    header: str = "",
) -> Report:
    """A multi-run merge report: the aggregate of every stream in ``stats``.

    ``stats`` is anything with the :class:`~repro.core.stats.StatTable` read
    API (``aggregate(fail=...)`` and a ``name``) — a
    :class:`~repro.core.engine.StatsEngine` holding a batch merge, a plain
    table, a collector result.  The report carries the summed main and
    failure matrices under ``stream_id=ALL_STREAMS`` (-1), flowing through
    every sink like any per-stream report."""
    return Report(
        source=source,
        event=event,
        stream_id=ALL_STREAMS,
        header=header,
        fields=dict(fields or {}),
        blocks=[
            StatBlock(stats.name, stats.aggregate()),
            StatBlock(f"{stats.name}_fail", stats.aggregate(fail=True), fail=True),
        ],
    )
