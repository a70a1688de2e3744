"""Per-stream stat tracking: the stats core the serving engine runs on.

The modules here are copies of the reference package's framework-free stats
core, kept file for file so that the per-stream lanes the port records are
the reference's by construction.  ``array_ops.py`` differs: beside the NumPy
backend it holds ``TorchOps``, whose landing ops run the CUDA kernels of
:mod:`repro_torch.kernels.segment_scatter`, and it has no JAX backend.

Public API:

    from repro_torch.core import (
        AccessType, AccessOutcome, FailOutcome,
        StatTable, CleanStatTable,
        StatsEngine,                      # vectorized batch ingestion
        StatsFrame, EventJournal,         # per-stream query layer (core/query.py)
        Report, StatBlock,                # report model
        TextSink, JSONSink, CSVSink,      # pluggable report sinks
        KernelTimeline, KernelTime,
        Stream, StreamManager,
        StreamStats, StepCost, stream_scope, current_stream,
        FaultPlan, KernelFaultSpec,       # deterministic fault injection (core/faults.py)
        check_sim_conservation,
    )
"""

from .stats import (
    DEFAULT_STREAM,
    AccessOutcome,
    AccessType,
    CleanStatTable,
    FailOutcome,
    StatTable,
    format_breakdown,
)
from .engine import CleanView, StatsEngine
from .query import EventJournal, FrameGroupBy, QueryError, StatsFrame
from .sinks import (
    ALL_STREAMS,
    CSVSink,
    JSONSink,
    MultiSink,
    Report,
    ReportSink,
    StatBlock,
    TextSink,
    frame_block,
    make_sink,
    merged_report,
    render_text,
    stream_report,
)
from .faults import (
    FAULT_KINDS,
    FAULT_LANES,
    FaultPlan,
    KernelFaultSpec,
    check_sim_conservation,
)
from .timeline import KernelTime, KernelTimeline
from .stream import Stream, StreamEvent, StreamManager, WorkItem
from .instrument import StepCost, StepRecord, StreamStats, current_stream, stream_scope
from .collector import StatCollector, namespace_stream, split_namespaced

__all__ = [
    "DEFAULT_STREAM",
    "AccessOutcome",
    "AccessType",
    "CleanStatTable",
    "FailOutcome",
    "StatTable",
    "format_breakdown",
    "StatsEngine",
    "CleanView",
    "StatsFrame",
    "FrameGroupBy",
    "EventJournal",
    "QueryError",
    "Report",
    "StatBlock",
    "ReportSink",
    "TextSink",
    "JSONSink",
    "CSVSink",
    "MultiSink",
    "make_sink",
    "render_text",
    "stream_report",
    "frame_block",
    "merged_report",
    "ALL_STREAMS",
    "FAULT_KINDS",
    "FAULT_LANES",
    "FaultPlan",
    "KernelFaultSpec",
    "check_sim_conservation",
    "KernelTime",
    "KernelTimeline",
    "Stream",
    "StreamEvent",
    "StreamManager",
    "WorkItem",
    "StepCost",
    "StepRecord",
    "StreamStats",
    "current_stream",
    "stream_scope",
    "StatCollector",
    "namespace_stream",
    "split_namespaced",
]
