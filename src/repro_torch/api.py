"""repro_torch.api — the stable public facade of the PyTorch/CUDA port.

The reference's ``repro/api.py`` with only its imports changed: the same
names over the port's simulator, stats core and (lazily) its torch
trainer and serving engine.  Everything a user of this reproduction needs
sits behind four names::

    from repro_torch import simulate, sweep, Session, StatsFrame

* :func:`simulate` — run one scenario (or an ad-hoc launch list) on any
  engine and get a :class:`RunResult` whose :attr:`~RunResult.frame` answers
  per-stream questions declaratively;
* :func:`sweep` — fan scenario × engine × config jobs over the batch runner
  (``backend="vector"`` for trace-compile/replay) and get a
  :class:`~repro_torch.sim.batch.BatchResult` with ``.frame()`` / ``.job_frame()``;
* :class:`Session` — the imperative surface (create named streams, launch
  kernels, run, query) for workloads the scenario registry does not model;
* :class:`~repro_torch.core.query.StatsFrame` — the query layer itself, usable
  over any engine/table this codebase produces.

Stability policy (semver)
-------------------------

Names exported in this module's ``__all__`` — and re-exported from
``repro_torch``'s own ``__all__`` — are the **stable API**: they follow semantic
versioning against :data:`repro_torch.__version__` (breaking changes only on a
major bump; additions bump the minor).  ``tests/test_torch_api_surface.py``
pins the surface to the reference's — adding or removing a public name
without updating its snapshot fails CI.  Everything else
(``repro_torch.core`` / ``repro_torch.sim`` internals, leading-underscore
names) may change between minor versions;
legacy entry points being phased out (``repro_torch.sim.microbench`` wrappers)
emit a single :class:`DeprecationWarning` and keep bit-identical behaviour
until removed at the next major version.  See ``docs/API.md`` for the
full reference and the StatsFrame cookbook.

The module imports only the simulator stack.  The torch model-backed
framework entry points (:class:`Trainer`, :class:`ServeEngine`, …) are
re-exported lazily via PEP 562 so ``import repro_torch`` stays light and the
batch runner's pool heuristics keep working.  The simulator's
``SimConfig.array_backend`` defaults to ``"torch"`` (the card);
``"torch:cpu"`` and ``"numpy"`` run on the host.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, fields as dataclass_fields
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .core.query import EventJournal, QueryError, StatsFrame
from .core.sinks import ReportSink, make_sink
from .core.stats import AccessOutcome
from .sim.batch import BatchJob, BatchResult, BatchRunner, same_shape_jobs, sweep_jobs
from .sim.executor import SimConfig, SimResult, TPUSimulator
from .sim.kernel_desc import Access, KernelDesc
from .sim.scenarios import (
    Launch,
    ScenarioInstance,
    build as build_scenario,
    get_spec,
    list_scenarios,
)

__all__ = [
    # the facade
    "simulate",
    "sweep",
    "Session",
    "RunResult",
    # the query layer
    "StatsFrame",
    "EventJournal",
    "QueryError",
    # declarative inputs (keyword-first constructors)
    "SimConfig",
    "KernelDesc",
    "Access",
    "Launch",
    "BatchJob",
    "BatchResult",
    "make_sink",
    # scenario registry handles
    "list_scenarios",
    "build_scenario",
    # torch model-backed framework entry points (lazy; see __getattr__)
    "Trainer",
    "TrainConfig",
    "ServeEngine",
    "ServeConfig",
    "ServeRequest",
    "LoadSpec",
    "TenantSpec",
    "generate_load",
    "replay_load",
]

#: model-backed re-exports, resolved on first attribute access (PEP 562) so
#: ``import repro_torch`` never loads the models, the trainer or the engine.
_LAZY = {
    "Trainer": ("repro_torch.train.trainer", "Trainer"),
    "TrainConfig": ("repro_torch.train.trainer", "TrainConfig"),
    "ServeEngine": ("repro_torch.serve.engine", "Engine"),
    "ServeConfig": ("repro_torch.serve.engine", "ServeConfig"),
    "ServeRequest": ("repro_torch.serve.engine", "Request"),
    "LoadSpec": ("repro_torch.serve.loadgen", "LoadSpec"),
    "TenantSpec": ("repro_torch.serve.loadgen", "TenantSpec"),
    "generate_load": ("repro_torch.serve.loadgen", "generate_load"),
    "replay_load": ("repro_torch.serve.loadgen", "replay_load"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target[0]), target[1])
    globals()[name] = value  # cache for subsequent lookups
    return value


def _make_config(
    config: Union[SimConfig, Mapping[str, object], None],
    overrides: Mapping[str, object],
    engine: Optional[str],
) -> SimConfig:
    """Keyword-first SimConfig assembly: ``config`` (object or field dict)
    is copied, loose keyword overrides land on top, then ``engine``.
    Unknown fields fail fast."""
    if config is None:
        cfg = SimConfig()
    elif isinstance(config, SimConfig):
        cfg = copy.copy(config)
    else:
        cfg = SimConfig(**dict(config))
    valid = {f.name for f in dataclass_fields(SimConfig)}
    for k, v in overrides.items():
        if k not in valid:
            raise TypeError(f"unknown SimConfig field {k!r}; known: {sorted(valid)}")
        setattr(cfg, k, v)
    if engine is not None:
        cfg.engine = engine
    return cfg


def _inject_event_journal(sim: TPUSimulator) -> EventJournal:
    """Swap an :class:`EventJournal` into a *fresh* simulator — the same
    injection point the compiled-trace recorder uses (reassign the engine
    and its three view aliases before the first event lands)."""
    if sim._cycle != 0 or sim.log or sim.engine.streams():
        raise RuntimeError("keep_events requires a fresh simulator (nothing run yet)")
    journal = EventJournal(
        name=sim.engine.name,
        clean_fail_cols=sim.engine._clean_fail.matrix.shape[1],
    )
    sim.engine = journal
    sim.stats = journal
    sim.clean = journal.clean
    sim.clean_fail = journal.clean_fail
    return journal


@dataclass
class RunResult:
    """One simulation through the facade: the raw
    :class:`~repro_torch.sim.executor.SimResult` plus the query layer wired up
    (stream names, timeline, optional event journal)."""

    result: SimResult = field(repr=False)
    frame: StatsFrame = field(repr=False)
    scenario: Optional[str] = None
    params: Dict[str, object] = field(default_factory=dict)
    stream_ids: Dict[str, int] = field(default_factory=dict)
    _instance: Optional[ScenarioInstance] = field(default=None, repr=False)

    # -- SimResult passthrough ----------------------------------------------------
    @property
    def cycles(self) -> int:
        return self.result.cycles

    @property
    def stats(self):
        return self.result.stats

    @property
    def clean(self):
        return self.result.clean

    @property
    def clean_fail(self):
        return self.result.clean_fail

    @property
    def timeline(self):
        return self.result.timeline

    @property
    def log(self):
        return self.result.log

    def signature(self) -> dict:
        """The run's full comparable identity (tri-engine invariant):
        delegates to :meth:`repro_torch.sim.executor.SimResult.signature`."""
        return self.result.signature()

    def check_oracle(self) -> Optional[Dict[str, object]]:
        """The scenario's per-stream oracle as StatsFrame queries, or
        ``None`` for ad-hoc / golden-table runs."""
        if self._instance is None:
            return None
        return self._instance.check_oracle(self.result)


def _launches_instance(launches: Sequence[Launch]) -> ScenarioInstance:
    return ScenarioInstance(
        name="adhoc", params={}, launches=list(launches), expected=None,
    )


def simulate(
    scenario: Union[str, ScenarioInstance, Sequence[Launch]],
    *,
    engine: Optional[str] = None,
    config: Union[SimConfig, Mapping[str, object], None] = None,
    sinks: Optional[Sequence[ReportSink]] = None,
    keep_events: bool = False,
    **params,
) -> RunResult:
    """Run one multi-stream workload and return a queryable result.

    ``scenario`` is a registered scenario name (remaining keywords are its
    params), an already-built :class:`~repro_torch.sim.scenarios.ScenarioInstance`,
    or a plain list of :class:`~repro_torch.sim.scenarios.Launch` rows (ad-hoc
    workload; stream names and event labels resolve exactly as in the
    registry).  ``config`` is a :class:`SimConfig` or a field dict;
    ``engine`` picks the loop (``"cycle"`` / ``"event"`` / ``"compiled"``).
    ``keep_events=True`` retains the per-event journal so the result frame
    answers cycle-window queries (``during`` / ``between_kernels`` /
    ``groupby("kernel")``); it forces a real simulation, so it cannot be
    combined with the compiled replay engine.

        res = simulate("l2_lat", n_streams=4, n_loads=256)
        res.frame.filter(stream="stream_2", outcome="MSHR_HIT").sum()
    """
    if isinstance(scenario, str):
        inst = build_scenario(scenario, **params)
    elif isinstance(scenario, ScenarioInstance):
        if params:
            raise TypeError("params only apply when scenario is a registry name")
        inst = scenario
    else:
        if params:
            raise TypeError("params only apply when scenario is a registry name")
        inst = _launches_instance(scenario)
    cfg = _make_config(config, {}, engine)
    if keep_events and cfg.engine == "compiled":
        raise ValueError(
            "keep_events needs a real simulation (cycle/event engine); the "
            "compiled engine replays recorded state without landing events"
        )
    sim = inst.make_sim(config=cfg, sinks=sinks)
    events = _inject_event_journal(sim) if keep_events else None
    result = sim.run()
    frame = StatsFrame(
        result.stats,
        timeline=result.timeline,
        names=inst.stream_ids,
        events=events,
        devices=result.devices or None,
    )
    return RunResult(
        result=result,
        frame=frame,
        scenario=inst.name,
        params=dict(inst.params),
        stream_ids=dict(inst.stream_ids),
        _instance=inst,
    )


def sweep(
    scenarios: Optional[Sequence[str]] = None,
    *,
    engines: Optional[Sequence[str]] = None,
    params: Optional[Mapping[str, Mapping[str, object]]] = None,
    jobs: Optional[Sequence[BatchJob]] = None,
    workers: Optional[int] = None,
    backend: str = "pool",
    parallel: bool = True,
) -> BatchResult:
    """Fan a scenario sweep over the batch runner and return its
    :class:`~repro_torch.sim.batch.BatchResult` (ordered payloads, deterministic
    merge, ``.frame()`` / ``.job_frame()`` for queries).

    Default is the whole registry × ``engines`` (default ``("event",)``)
    with per-scenario ``params`` overrides; pass ``jobs`` (e.g. from
    :func:`repro_torch.sim.batch.same_shape_jobs`) for full control — ``jobs``
    carry their own engine/params, so combining them with
    ``scenarios``/``engines``/``params`` is rejected rather than silently
    ignored.  ``backend="vector"`` compiles each scenario shape once and
    lockstep-replays its jobs; ``backend="batched"`` advances every
    (divergent) job in one process with a single SoA stat landing
    (``repro_torch.sim.batched``); ``parallel=False`` is the bit-identical
    serial fallback."""
    if jobs is None:
        jobs = sweep_jobs(
            scenarios=scenarios,
            engines=engines if engines is not None else ("event",),
            params=params,
        )
    else:
        clashing = [
            kw for kw, v in (("scenarios", scenarios), ("engines", engines), ("params", params))
            if v is not None
        ]
        if clashing:
            raise TypeError(
                f"jobs= already fixes each job's scenario/engine/params; "
                f"also passing {clashing} would be silently ignored"
            )
    return BatchRunner(jobs, workers=workers, backend=backend).run(parallel=parallel)


class Session:
    """Imperative facade: named streams, keyword-first kernel launches, one
    ``run()``, then queries — for workloads the registry does not model::

        s = Session(hbm_latency=200)
        s.stream("prefetch", priority=1)
        s.launch("prefetch", rd_bytes=1 << 20, record="chunk0")
        s.launch("compute", flops=2e7, wr_bytes=1 << 16, wait="chunk0")
        res = s.run()
        res.frame.groupby("stream").sum()

    ``launch`` accepts a prebuilt :class:`KernelDesc` via ``kernel=`` or
    builds one from keywords (``rd_bytes`` / ``wr_bytes`` / ``ici_bytes`` /
    ``flops`` / ``trace`` / ``dependent`` / ``issue_width``).  Streams are
    created on first mention; ``wait`` / ``record`` are event labels, like
    :class:`~repro_torch.sim.scenarios.Launch` rows.  A session runs once.
    """

    def __init__(
        self,
        *,
        config: Union[SimConfig, Mapping[str, object], None] = None,
        engine: Optional[str] = None,
        sinks: Optional[Sequence[ReportSink]] = None,
        keep_events: bool = False,
        **config_overrides,
    ) -> None:
        cfg = _make_config(config, config_overrides, engine)
        if keep_events and cfg.engine == "compiled":
            raise ValueError("keep_events cannot be combined with the compiled engine")
        self.config = cfg
        self.sim = TPUSimulator(cfg, sinks=sinks)
        self.events = _inject_event_journal(self.sim) if keep_events else None
        self._streams: Dict[str, int] = {"": 0, "default": 0}
        self._priorities: Dict[str, int] = {"": 0, "default": 0}
        self._events_by_label: Dict[str, int] = {}
        self._n_launched = 0
        self._result: Optional[RunResult] = None

    # -- build-up -------------------------------------------------------------------
    def stream(self, name: str, *, priority: Optional[int] = None) -> int:
        """Create (or fetch) a named stream; returns its id.

        ``priority=None`` (default) means "whatever the stream has" (0 at
        creation).  A stream's priority binds at creation, so an *explicit*
        priority that disagrees with an existing stream's bound value would
        be silently dropped — that fails loudly instead (the same rule
        :class:`~repro_torch.sim.scenarios.ScenarioInstance` enforces for
        declarative launch rows)."""
        sid = self._streams.get(name)
        if sid is None:
            bound = 0 if priority is None else priority
            sid = self.sim.create_stream(name, priority=bound).stream_id
            self._streams[name] = sid
            self._priorities[name] = bound
        elif priority is not None and priority != self._priorities.get(name, 0):
            raise ValueError(
                f"stream {name!r} already exists with priority "
                f"{self._priorities.get(name, 0)}; a priority binds at creation "
                "— set it before the stream's first launch"
            )
        return sid

    def _event(self, label: str) -> int:
        eid = self._events_by_label.get(label)
        if eid is None:
            eid = self.sim.create_event().event_id
            self._events_by_label[label] = eid
        return eid

    def launch(
        self,
        stream: str = "",
        kernel: Optional[KernelDesc] = None,
        *,
        name: Optional[str] = None,
        wait: Union[str, Sequence[str]] = (),
        record: Union[str, Sequence[str]] = (),
        rd_bytes: int = 0,
        wr_bytes: int = 0,
        ici_bytes: int = 0,
        flops: float = 0.0,
        trace: Optional[List[Access]] = None,
        dependent: bool = False,
        issue_width: int = 1,
        addr_base: int = 0,
        device: int = 0,
        ici_route: Sequence[int] = (),
    ) -> KernelDesc:
        """Queue one kernel on ``stream`` (created on first mention).

        ``device`` / ``ici_route`` place the kernel in a multi-chip topology
        (``topology_shape`` in the session config — docs/DESIGN.md §5.14);
        both are ignored on single-chip sessions."""
        if self._result is not None:
            raise RuntimeError("session already ran; build a new Session")
        if kernel is not None:
            used = [k for k, v in (
                ("name", name), ("trace", trace), ("rd_bytes", rd_bytes),
                ("wr_bytes", wr_bytes), ("ici_bytes", ici_bytes),
                ("flops", flops), ("addr_base", addr_base), ("dependent", dependent),
                ("device", device), ("ici_route", tuple(ici_route)),
            ) if v]
            if issue_width != 1:
                used.append("issue_width")
            if used:
                raise TypeError(
                    f"launch() got both kernel= and builder keyword(s) {used}; "
                    "the keywords would be silently ignored — pass one or the other"
                )
        if kernel is None:
            kernel = KernelDesc(
                name=name or f"k{self._n_launched}",
                flops=flops,
                trace=trace,
                hbm_rd_bytes=rd_bytes,
                hbm_wr_bytes=wr_bytes,
                ici_bytes=ici_bytes,
                addr_base=addr_base,
                dependent=dependent,
                issue_width=issue_width,
                device=device,
                ici_route=tuple(ici_route),
            )
        waits = (wait,) if isinstance(wait, str) else tuple(wait)
        records = (record,) if isinstance(record, str) else tuple(record)
        self.sim.launch(
            self.stream(stream),
            kernel,
            wait_events=[self._event(l) for l in waits],
            record_events=[self._event(l) for l in records],
        )
        self._n_launched += 1
        return kernel

    # -- run + query -----------------------------------------------------------------
    def run(self) -> RunResult:
        if self._result is not None:
            return self._result
        result = self.sim.run()
        names = {n: sid for n, sid in self._streams.items() if n != ""}
        frame = StatsFrame(
            result.stats, timeline=result.timeline, names=names, events=self.events,
            devices=result.devices or None,
        )
        self._result = RunResult(
            result=result, frame=frame, scenario=None, params={}, stream_ids=names,
        )
        return self._result

    @property
    def frame(self) -> StatsFrame:
        """The run's query frame (runs the session if needed)."""
        return self.run().frame
