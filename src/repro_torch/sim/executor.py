"""Simulator executor: concurrent streams over shared TPU resources.

This is the GPGPU-Sim analog.  Three interchangeable main loops drive it:

* ``SimConfig.engine="cycle"`` — the reference cycle-stepped loop: one Python
  iteration per simulated cycle (tick cache, scan launchables, issue, retire).
* ``SimConfig.engine="event"`` (default) — the event-driven loop with exact
  cycle-skipping: it computes the next *interesting* cycle (min over every
  run's ``next_issue_cycle``, drained runs' retire cycles, and the
  launch-stagger slot after a retire) and jumps straight to it, and collapses
  pure synthesized-beat stretches into one vectorized batch.  It is
  **bit-identical** to the cycle loop — same cycle counts, same per-stream /
  clean / failure stats, same report text — because it provably visits every
  cycle on which the cycle loop would have changed state (see
  docs/DESIGN.md, "Event-driven scheduler").
* ``SimConfig.engine="compiled"`` — trace-compile/replay
  (:mod:`repro.sim.compiled`): the first run of a scenario *shape* executes
  the event loop once under a recording stat engine; every further run of
  that shape replays the recorded trace without simulating, still
  bit-identical (docs/DESIGN.md, "Trace compilation & lockstep replay").

It drives **three stat views in one pass**,
which is how we reproduce the paper's three builds from a single binary:

* ``tip``   — :class:`repro.core.StatTable`, per-stream (the paper's feature);
* ``clean`` — :class:`repro.core.CleanStatTable`, aggregated *with* the
  baseline's same-cycle lost-update undercount (§5.2);
* serialized execution — ``SimConfig.serialize_streams=True`` reproduces the
  paper's ``busy_streams.size() == 0`` patch to ``main.cc`` (§5.1), and
  ``concurrent_streams=False`` models an unset ``-gpgpu_concurrent_kernel_sm``.

Per the paper's §3 plumbing, every access event carries its kernel's stream
id (``mem_fetch`` propagation), kernel launch/exit cycles land in a
:class:`KernelTimeline` (``gpu_kernel_time``), and on kernel exit only the
exiting kernel's stream stats are printed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, IO, List, Optional, Sequence, Tuple

import heapq
import io
import re

import numpy as np

from ..core.engine import CleanView, StatsEngine
from ..core.faults import FaultPlan
from ..core.query import StatsFrame
from ..core.sinks import ReportSink, render_text, stream_report
from ..core.stats import AccessOutcome, AccessType
from ..core.stream import StreamManager, WorkItem
from ..core.timeline import KernelTimeline

from .kernel_desc import Access, KernelDesc, LINE_SIZE
from .resources import Bandwidth, CacheDecision, Compute, HW_V5E, VMEMCache

__all__ = ["SimConfig", "TPUSimulator", "SimResult", "VALUE_ONLY_CONFIG"]

# Hot-path constants (module-level lookups are cheaper than enum attribute
# access inside the per-access inner loops).
_GLOBAL_R = AccessType.GLOBAL_ACC_R
_GLOBAL_W = AccessType.GLOBAL_ACC_W
_KV_W = AccessType.KV_ACC_W
_ICI_SND = AccessType.ICI_SND
_ICI_RCV = AccessType.ICI_RCV
_HIT = AccessOutcome.HIT
_MISS = AccessOutcome.MISS
_RESFAIL = AccessOutcome.RESERVATION_FAILURE
_FAULT = AccessType.FAULT
_KERNEL_ABORT = AccessOutcome.KERNEL_ABORT
_RECOVERED = AccessOutcome.RECOVERED
_ICI_HOP = AccessType.ICI_HOP


@dataclass
class SimConfig:
    """Simulator knobs (``gpgpusim.config`` analog)."""

    concurrent_streams: bool = True  # -gpgpu_concurrent_kernel_sm
    serialize_streams: bool = False  # the paper's main.cc serialization patch
    line_size: int = LINE_SIZE
    vmem_capacity: int = HW_V5E.vmem_core_bytes
    hbm_latency: int = 100  # cycles HBM round-trip
    vmem_hit_latency: int = 8  # cycles for a resident-line access
    hbm_bytes_per_cycle: float = HW_V5E.hbm_bytes_per_cycle
    ici_bytes_per_cycle: float = HW_V5E.ici_bytes_per_cycle
    flops_per_cycle: float = HW_V5E.flops_per_cycle
    mshr_entries: int = 2048  # DMA engines track thousands of in-flight lines
    mshr_max_merge: int = 8
    bw_stall_horizon: int = 4096  # HBM queue depth before issue stalls
    #: miss-path mechanism between a VMEMCache miss and HBM (docs/DESIGN.md
    #: §5.10): "none" (bit-identical to the pre-mechanism simulator),
    #: "victim", "miss_cache", "stream_buffer", or "victim+stream".  These
    #: five fields are structural — they join structural_key(), so the
    #: compiled-trace cache never replays a stale mechanism config.
    miss_mechanism: str = "none"
    victim_entries: int = 8
    miss_cache_entries: int = 8
    stream_buffers: int = 4
    stream_buffer_depth: int = 4
    max_cycles: int = 50_000_000
    max_synth_beats: int = 4096  # beat granularity for aggregate-cost kernels
    #: straggler injection: stream_id -> slowdown factor (>1 = slower)
    stream_slowdown: Dict[int, float] = field(default_factory=dict)
    #: deterministic fault injection (docs/DESIGN.md §5.11): a seeded
    #: :class:`repro.core.faults.FaultPlan` whose ``kernel_faults`` specs the
    #: executor schedules at absolute cycles both engine loops provably
    #: visit — abort-at-cycle, transient slowdown windows, HBM stall bursts —
    #: recording every fault/recovery on the FAULT stat row.  ``None`` (or a
    #: plan with no kernel specs) is bit-identical to a build without the
    #: subsystem.  Structural: a plan change is a different simulation, so
    #: this field joins structural_key() and the compiled-trace cache key.
    fault_plan: Optional[FaultPlan] = None
    #: multi-chip topology (docs/DESIGN.md §5.14): a device-mesh shape in the
    #: launch layer's axis vocabulary — ``()`` (default) is the single-chip
    #: legacy model, ``(4,)`` a 4-device ring over ("data",), ``(2, 2)`` a
    #: mesh over ("data", "model"), rank 3 adds "pod".  Non-empty shapes give
    #: every device its own VMEMCache + HBM ledger (device 0 *shares* the
    #: simulator's legacy self.cache/self.hbm, so a single-device topology is
    #: bit-identical to no topology) and route kernel ICI traffic hop-by-hop
    #: over contended per-link Bandwidth ledgers (repro.sim.topology).  All
    #: three topology fields are structural: they change what a simulation
    #: does, so they join structural_key() and the compiled-trace cache key.
    topology_shape: Tuple[int, ...] = ()
    #: per-axis ring wraparound links (only at axis sizes > 2, where the wrap
    #: link is distinct from the existing neighbour pair)
    topology_wrap: bool = True
    #: inter-chip link bandwidth; 0.0 defaults to ``ici_bytes_per_cycle``
    link_bytes_per_cycle: float = 0.0
    #: main-loop implementation: "event" (cycle-skipping, default), "cycle"
    #: (reference cycle-stepped loop), or "compiled" (trace-compile/replay:
    #: the event loop runs once per scenario *shape* and every further run of
    #: that shape replays the recorded trace — see repro/sim/compiled.py).
    #: Results are bit-identical across all three.
    engine: str = "event"
    #: array-ops backend for the hottest landing paths (stat-flush scatter,
    #: bandwidth-pointer running sums, batched cache-tag probe): "torch"
    #: (the CUDA kernels on the card, the default), "torch:cpu" (their plain
    #: torch versions on the host) or "numpy" (reference), all
    #: element-identical — see repro_torch/core/array_ops.py.  Value-only:
    #: backends are proven element-identical, so the event sequence cannot
    #: depend on the choice.
    array_backend: str = "torch"
    verbose: bool = False

    def structural_key(self) -> Tuple:
        """The config fields that can change what a simulation *does* — the
        shape-defining part of the compiled engine's cache key.  Fields in
        :data:`VALUE_ONLY_CONFIG` are excluded: they never alter the event
        sequence of a completing run (``max_cycles`` only guards against
        non-termination — replay re-checks it — and ``verbose`` only mirrors
        the log to stdout), so runs differing only there replay one trace."""
        return tuple(
            tuple(sorted(v.items())) if isinstance(v, dict) else v
            for f, v in sorted(self.__dict__.items())
            if f not in VALUE_ONLY_CONFIG and f != "engine"
        )


#: SimConfig fields that never change a completing simulation's event
#: sequence; a change here invalidates nothing in the compiled-trace cache.
VALUE_ONLY_CONFIG = frozenset({"max_cycles", "verbose", "array_backend"})


_UID_IN_LOG = re.compile(r"uid[ =:]+\d+")


@dataclass
class SimResult:
    cycles: int
    stats: StatsEngine  # tip (per-stream), StatTable-compatible API
    clean: CleanView  # baseline emulation (aggregated + undercount bug)
    clean_fail: CleanView
    timeline: KernelTimeline
    log: List[str]
    #: stream id → owning device id (docs/DESIGN.md §5.14).  Populated from
    #: each stream's first kernel launch when a topology is configured;
    #: empty on single-chip runs (every stream then reads as device 0
    #: through the frame's device axis).  Deliberately *not* part of
    #: :meth:`signature` — the device map is launch metadata, and keeping it
    #: out is what makes a single-device topology signature-identical to the
    #: legacy single-chip model.
    devices: Dict[int, int] = field(default_factory=dict)

    def tip_aggregate(self):
        return self.stats.aggregate()

    @property
    def frame(self) -> StatsFrame:
        """The run's stats as a :class:`~repro.core.query.StatsFrame`
        (timeline and the stream → device map attached; stream *names*
        attach at the ``repro.api`` layer, which knows the scenario's
        name → id map)."""
        return StatsFrame(self.stats, timeline=self.timeline,
                          devices=self.devices or None)

    def signature(self) -> dict:
        """Everything observable about the simulation, as comparable plain
        structures: cycles, all stat views (:meth:`StatsEngine.signature`),
        the timeline, and the rendered log.  Kernel ``uid``s come from a
        process-global counter, so uid digits in log text are normalized and
        timeline rows are re-keyed by (stream, per-stream launch order) —
        two simulations of one workload built twice still compare equal.
        The cross-engine identity suite (``tests/test_sim_event.py``) and
        ``benchmarks/sim_speed.py`` both compare exactly this."""
        tl_rows, last_sid, _last_uid = self.timeline.state()
        order: Dict[int, int] = {}
        tl_norm = []
        for sid, _uid, start, end, name in sorted(tl_rows, key=lambda r: (r[0], r[1])):
            k = order.get(sid, 0)
            order[sid] = k + 1
            tl_norm.append((sid, k, start, end, name))
        return {
            "cycles": self.cycles,
            "stats": self.stats.signature(),
            "timeline": sorted(tl_norm),
            "timeline_last_stream": last_sid,
            "log": [_UID_IN_LOG.sub("uid N", line) for line in self.log],
        }


class _Run:
    """In-flight kernel state (one per launched KernelDesc)."""

    __slots__ = (
        "desc",
        "work",
        "sid",
        "trace",
        "trace_len",
        "dep",
        "slowdown",
        "trace_pos",
        "next_issue_cycle",
        "compute_end",
        "syn_rd",
        "syn_wr",
        "syn_ici",
        "syn_lines_per_beat",
        "syn_cursor",
        "issue_tokens",
        "device",
        "cache",
        "hbm",
        "hops",
        "ff_at_np",
        "ff_tag_np",
        "ff_wr_np",
        "ff_gok",
        "ff_gtag",
        "ff_gend",
        "ff_gok_np",
        "ff_gtag_np",
        "ff_gend_np",
        "ff_g",
    )

    def __init__(
        self,
        desc: KernelDesc,
        work: WorkItem,
        launch_cycle: int,
        compute_end: int,
        max_beats: int,
        slowdown: float = 1.0,
    ):
        self.desc = desc
        self.work = work
        self.sid = work.stream_id
        self.trace = desc.trace
        self.trace_len = len(desc.trace) if desc.trace is not None else 0
        self.dep = desc.dependent
        self.slowdown = slowdown
        self.trace_pos = 0
        self.next_issue_cycle = launch_cycle
        self.compute_end = compute_end
        rd, wr, ici = desc.synthesized_lines()
        total = rd + wr + ici
        self.syn_lines_per_beat = max(1, (total + max_beats - 1) // max_beats)
        self.syn_rd, self.syn_wr, self.syn_ici = rd, wr, ici
        self.syn_cursor = desc.addr_base
        self.issue_tokens = 0.0
        # Device binding (docs/DESIGN.md §5.14): TPUSimulator._launch points
        # cache/hbm at the owning device's resources (aliases of the
        # simulator's own on single-chip runs) and resolves the kernel's ICI
        # route into link hops; empty hops = the legacy single-link model.
        self.device = desc.device
        self.cache = None
        self.hbm = None
        self.hops: Tuple[Tuple[int, int], ...] = ()
        self.ff_gend: Optional[List[int]] = None  # built lazily by _build_ff

    def _build_ff(self, line_size: int) -> None:
        """Precompute columns for dependent hit-chain batching: per-access
        type / line tag / is-write arrays (sliced verbatim into the emitted
        batch), plus run-length *groups* of consecutive accesses sharing one
        tag and eligibility (single-line, non-ICI), so chain scanning costs
        one residency lookup per touched line instead of one per access.
        Built once per descriptor (cached on the KernelDesc), on the first
        fast-forward attempt."""
        cached = self.desc.ff_cache
        if cached is not None and cached[0] == line_size:
            (_, self.ff_at_np, self.ff_tag_np, self.ff_wr_np,
             self.ff_gok, self.ff_gtag, self.ff_gend,
             self.ff_gok_np, self.ff_gtag_np, self.ff_gend_np) = cached
            self.ff_g = 0
            return
        trace = self.trace or []
        n = len(trace)
        at_np = np.array([a.atype for a in trace], dtype=np.int64)
        addr_np = np.array([a.addr for a in trace], dtype=np.int64)
        size_np = np.array([a.size for a in trace], dtype=np.int64)
        tag_np = addr_np // line_size
        hi_np = (addr_np + np.maximum(size_np, 1) - 1) // line_size
        ok_np = (tag_np == hi_np) & (at_np != int(_ICI_SND)) & (at_np != int(_ICI_RCV))
        self.ff_at_np = at_np
        self.ff_tag_np = tag_np
        self.ff_wr_np = (at_np == int(_GLOBAL_W)) | (at_np == int(_KV_W))
        change = np.empty(n, dtype=bool)
        if n:
            change[0] = True
            change[1:] = (tag_np[1:] != tag_np[:-1]) | (ok_np[1:] != ok_np[:-1])
        starts = np.flatnonzero(change)
        # Group arrays kept both ways: Python lists for the scalar per-group
        # scan (cheap indexing) and NumPy for the vectorized residency probe
        # over long chains (_fast_forward_dep).
        self.ff_gok_np = ok_np[starts]
        self.ff_gtag_np = tag_np[starts]
        self.ff_gend_np = np.append(starts[1:], n)
        self.ff_gok = self.ff_gok_np.tolist()
        self.ff_gtag = self.ff_gtag_np.tolist()
        self.ff_gend = self.ff_gend_np.tolist()
        self.ff_g = 0
        self.desc.ff_cache = (
            line_size, self.ff_at_np, self.ff_tag_np, self.ff_wr_np,
            self.ff_gok, self.ff_gtag, self.ff_gend,
            self.ff_gok_np, self.ff_gtag_np, self.ff_gend_np,
        )

    def drained(self) -> bool:
        return (
            self.trace_pos >= self.trace_len
            and self.syn_rd == 0
            and self.syn_wr == 0
            and self.syn_ici == 0
        )


def _occupy_sequence(bw: Bandwidth, cycles: np.ndarray, nbytes: np.ndarray, wr_mask,
                     ops=None) -> None:
    """Apply a sequence of ``bw.occupy(nbytes[i], cycles[i])`` calls with
    **bit-identical** float arithmetic to the scalar loop.

    The next-free pointer evolves as ``nf = max(cycle, nf) + nbytes/bpc``.
    The head is replayed scalar-by-scalar while an issue cycle can still bind
    the ``max``; once ``nf`` passes the window's last cycle, the remaining
    updates are pure left-to-right additions, which ``np.add.accumulate``
    performs in the same order (ufunc accumulation is strictly sequential, so
    the result is the same IEEE-754 double at every step).
    """
    total = int(nbytes.sum())
    bw.total_bytes += total
    if wr_mask is None:
        bw.total_rd_bytes += total
    else:
        wr_total = int(nbytes[wr_mask].sum())
        bw.total_wr_bytes += wr_total
        bw.total_rd_bytes += total - wr_total
    nf = bw.next_free_cycle
    bpc = bw.bytes_per_cycle
    cl = cycles.tolist()
    bl = nbytes.tolist()
    n = len(cl)
    last_c = cl[-1]
    i = 0
    while i < n and nf < last_c:
        c = cl[i]
        start = c if c > nf else nf
        nf = start + bl[i] / bpc
        i += 1
    if i < n:
        # tail: max() can no longer bind (cycles are non-decreasing ≤ nf)
        durs = np.empty(n - i + 1, dtype=np.float64)
        durs[0] = nf
        np.divide(nbytes[i:], bpc, out=durs[1:])
        if ops is None:
            nf = float(np.add.accumulate(durs)[-1])
        else:
            nf = float(ops.running_sum(durs)[-1])
    bw.next_free_cycle = nf


class _FaultState:
    """Kernel-layer fault schedule for one simulation (docs/DESIGN.md §5.11).

    Built from ``SimConfig.fault_plan.kernel_faults`` when non-empty; the
    simulator carries ``_faults = None`` otherwise, so fault-plan-off runs
    execute exactly the pre-fault code path.

    Every injection lands at an *absolute cycle* that both engine loops
    provably visit: the cycle loop visits every cycle, and the event loop
    caps its next-cycle jump and both fast-forward windows at :attr:`next`
    (the earliest pending fault cycle).  Specs targeting the k-th kernel
    launched on a stream are armed by :meth:`arm_launch` (relative ``after``
    becomes absolute at launch); ``hbm_stall`` specs are absolute from the
    start.  Conservation: every spec resolves exactly once — ``KERNEL_ABORT``
    when an abort kills work, else ``RECOVERED`` (slowdown window closed,
    stall applied, kernel retired first, or target never launched — the last
    two swept by :meth:`on_retire` / :meth:`finish`).
    """

    __slots__ = ("specs", "resolved", "by_launch", "launch_counts",
                 "pending", "next", "armed", "_seq")

    _SENTINEL = 1 << 62

    def __init__(self, plan: FaultPlan) -> None:
        self.specs = plan.kernel_faults
        self.resolved = [False] * len(self.specs)
        #: (stream, per-stream launch index) -> spec indices armed there
        self.by_launch: Dict[Tuple[int, int], List[int]] = {}
        self.launch_counts: Dict[int, int] = {}
        #: min-heap of (cycle, seq, action, spec index, run); seq breaks ties
        #: deterministically (spec order) and keeps runs out of comparisons
        self.pending: List[Tuple[int, int, str, int, Optional[_Run]]] = []
        self.armed: Dict[_Run, List[int]] = {}
        self._seq = 0
        self.next = self._SENTINEL
        for i, spec in enumerate(self.specs):
            if spec.kind == "hbm_stall":
                self._push(spec.after, "hbm", i, None)
            else:
                self.by_launch.setdefault((spec.stream, spec.kernel), []).append(i)

    def _push(self, cycle: int, action: str, i: int, run: Optional[_Run]) -> None:
        heapq.heappush(self.pending, (cycle, self._seq, action, i, run))
        self._seq += 1
        if cycle < self.next:
            self.next = cycle

    def arm_launch(self, run: _Run, sid: int, cycle: int) -> None:
        """Hook in :meth:`TPUSimulator._launch`: schedule the specs that
        target this (stream, launch-index) at their absolute cycles."""
        k = self.launch_counts.get(sid, 0)
        self.launch_counts[sid] = k + 1
        ids = self.by_launch.get((sid, k))
        if not ids:
            return
        for i in ids:
            spec = self.specs[i]
            self._push(
                cycle + spec.after,
                "abort" if spec.kind == "abort" else "slow_start",
                i,
                run,
            )
        self.armed[run] = list(ids)

    def process(self, sim: "TPUSimulator", cycle: int) -> None:
        """Apply every pending fault due at ``cycle``.  Called from the same
        position in both loop bodies (after the launch step), and the loops
        guarantee each event's exact cycle is visited, so the applications —
        and the stat events they record — are identical across engines."""
        pending = self.pending
        while pending and pending[0][0] <= cycle:
            _, _, action, i, run = heapq.heappop(pending)
            if self.resolved[i]:
                continue  # run retired first — already swept as RECOVERED
            spec = self.specs[i]
            if action == "abort":
                # Discard remaining work; the clamps make the normal retire
                # condition (drained + compute_end + next_issue_cycle ≤ now)
                # hold this cycle, so the kernel exits through _retire with
                # its timeline row and exit report intact.
                run.syn_rd = run.syn_wr = run.syn_ici = 0
                run.trace_pos = run.trace_len
                if run.compute_end > cycle:
                    run.compute_end = cycle
                if run.next_issue_cycle > cycle:
                    run.next_issue_cycle = cycle
                self.resolved[i] = True
                sim._count(_FAULT, _KERNEL_ABORT, spec.stream, cycle, 1)
            elif action == "slow_start":
                run.slowdown = spec.factor
                run.issue_tokens = 0.0
                self._push(cycle + spec.duration, "slow_end", i, run)
            elif action == "slow_end":
                run.slowdown = sim.cfg.stream_slowdown.get(run.sid, 1.0)
                # Zeroing the fractional tokens makes the window boundary a
                # clean state (and re-enables fast-forward eligibility).
                run.issue_tokens = 0.0
                self.resolved[i] = True
                sim._count(_FAULT, _RECOVERED, spec.stream, cycle, 1)
            else:  # hbm_stall: push the HBM token bucket into the future
                bw = sim.hbm
                nf = bw.next_free_cycle
                bw.next_free_cycle = (nf if nf > cycle else float(cycle)) + spec.duration
                self.resolved[i] = True
                sim._count(_FAULT, _RECOVERED, spec.stream, cycle, 1)
        self.next = pending[0][0] if pending else self._SENTINEL

    def on_retire(self, sim: "TPUSimulator", run: _Run, cycle: int) -> None:
        """A retiring kernel resolves its still-pending specs as RECOVERED
        (the fault window never closed / never fired before the exit)."""
        ids = self.armed.pop(run, None)
        if ids:
            for i in ids:
                if not self.resolved[i]:
                    self.resolved[i] = True
                    sim._count(_FAULT, _RECOVERED, self.specs[i].stream, cycle, 1)

    def finish(self, sim: "TPUSimulator", cycle: int) -> None:
        """End of run: any spec that never resolved (target kernel never
        launched, or an absolute cycle past the end) sweeps to RECOVERED at
        the final cycle — this is what makes conservation exact for *any*
        plan against *any* workload."""
        for i, spec in enumerate(self.specs):
            if not self.resolved[i]:
                self.resolved[i] = True
                sim._count(_FAULT, _RECOVERED, spec.stream, cycle, 1)
        self.pending.clear()
        self.next = self._SENTINEL


class TPUSimulator:
    """Discrete-event simulator with per-stream stat tracking."""

    def __init__(
        self,
        config: Optional[SimConfig] = None,
        sinks: Optional[Sequence[ReportSink]] = None,
    ) -> None:
        self.cfg = config or SimConfig()
        # Array-ops backend (SimConfig.array_backend): routes the stat-flush
        # scatter and the bandwidth-pointer running sums.  Element-identical
        # across backends, so this is value-only config.
        from ..core.array_ops import get_backend

        self._ops = get_backend(self.cfg.array_backend)
        self.streams = StreamManager()
        # One engine drives all three stat views (tip / per-window / clean):
        # events buffer in columnar form and land via vectorized scatters.
        # The compiled-trace compiler swaps in its RecordingStatsEngine by
        # reassigning this attribute (and the three view aliases below)
        # before the first event lands — see repro.sim.compiled._compile.
        self.engine = StatsEngine(
            name="Total_core_cache_stats",
            clean_fail_cols=max(AccessOutcome.count(), 8),
        )
        self.engine.ops = self._ops
        self.stats = self.engine  # StatTable-compatible view (tip)
        self.clean = self.engine.clean
        self.clean_fail = self.engine.clean_fail
        self.sinks: List[ReportSink] = list(sinks) if sinks else []
        self.timeline = KernelTimeline()
        self.hbm = Bandwidth(self.cfg.hbm_bytes_per_cycle)
        self.ici = Bandwidth(self.cfg.ici_bytes_per_cycle)
        self.compute = Compute(self.cfg.flops_per_cycle)
        self.cache = self._make_cache(self.hbm)
        # Multi-chip topology (docs/DESIGN.md §5.14): devices 1..N-1 get
        # their own HBM ledger + VMEMCache; device 0 *shares* self.hbm /
        # self.cache above, which is what makes a single-device topology —
        # and the base resource columns of a compiled trace — bit-identical
        # to the legacy single-chip model.
        self.topology = None
        self.stream_devices: Dict[int, int] = {}
        if self.cfg.topology_shape:
            from .topology import DeviceTopology  # deferred: only multi-chip runs pay it

            topo = DeviceTopology(
                self.cfg.topology_shape,
                wrap=self.cfg.topology_wrap,
                link_bytes_per_cycle=(
                    self.cfg.link_bytes_per_cycle or self.cfg.ici_bytes_per_cycle
                ),
            )
            topo.hbms = [self.hbm]
            topo.caches = [self.cache]
            for _ in range(1, topo.n_devices):
                hbm = Bandwidth(self.cfg.hbm_bytes_per_cycle)
                topo.hbms.append(hbm)
                topo.caches.append(self._make_cache(hbm))
            self.topology = topo
        for cache in ([self.cache] if self.topology is None else self.topology.caches):
            if cache.miss_path is not None:
                # Prefetch traffic lands on the PREFETCH stat row through the
                # same late-bound path as demand events, so the compiled-trace
                # recorder swap (which reassigns self.engine) captures it too.
                cache.miss_path.record = self._count
        self.log: List[str] = []
        # Bandwidth next-free/byte-total bookkeeping is observable through
        # SimResult.resources and the compiled engine's resource columns; the
        # batched backend flips this off for all-synthetic workloads, whose
        # results never read it, to skip the occupy calls entirely.
        self._occupy_bw = True
        self._active: List[_Run] = []
        self._n_synth = 0  # active runs without an explicit trace (FF-eligible)
        self._cycle = 0
        self._frame: Optional[StatsFrame] = None  # lazy; rebuilt on engine swap
        # Fault injection: None unless the plan carries kernel-layer specs,
        # so fault-plan-off runs take exactly the pre-fault code path.
        plan = self.cfg.fault_plan
        self._faults = _FaultState(plan) if plan is not None and plan.kernel_faults else None

    def _make_cache(self, hbm: Bandwidth) -> VMEMCache:
        """One device's VMEMCache over its HBM ledger, from the config."""
        cfg = self.cfg
        return VMEMCache(
            cfg.vmem_capacity,
            cfg.line_size,
            hbm,
            hbm_latency=cfg.hbm_latency,
            mshr_entries=cfg.mshr_entries,
            mshr_max_merge=cfg.mshr_max_merge,
            bw_stall_horizon=cfg.bw_stall_horizon,
            miss_mechanism=cfg.miss_mechanism,
            victim_entries=cfg.victim_entries,
            miss_cache_entries=cfg.miss_cache_entries,
            stream_buffers=cfg.stream_buffers,
            stream_buffer_depth=cfg.stream_buffer_depth,
            hit_latency=cfg.vmem_hit_latency,
        )

    def _resource_snapshot(self) -> Tuple[float, ...]:
        """Flat resource columns for the compiled engine's per-segment rows
        (:mod:`repro.sim.compiled`): the 9 legacy base columns — device-0
        HBM (next-free, total, rd, wr), the legacy ICI link (same four),
        device-0 writebacks — then, when a topology is attached, its extra
        per-device / per-link columns in deterministic order."""
        base = (
            self.hbm.next_free_cycle,
            float(self.hbm.total_bytes),
            float(self.hbm.total_rd_bytes),
            float(self.hbm.total_wr_bytes),
            self.ici.next_free_cycle,
            float(self.ici.total_bytes),
            float(self.ici.total_rd_bytes),
            float(self.ici.total_wr_bytes),
            float(self.cache.writebacks),
        )
        if self.topology is None:
            return base
        return base + self.topology.resource_snapshot()

    def _restore_resources(self, row: Sequence[float]) -> None:
        """Inverse of :meth:`_resource_snapshot` — mirror a compiled trace's
        end-of-run resource state onto this simulator (lockstep replay)."""
        hbm, ici = self.hbm, self.ici
        hbm.next_free_cycle = float(row[0])
        hbm.total_bytes = int(row[1])
        hbm.total_rd_bytes = int(row[2])
        hbm.total_wr_bytes = int(row[3])
        ici.next_free_cycle = float(row[4])
        ici.total_bytes = int(row[5])
        ici.total_rd_bytes = int(row[6])
        ici.total_wr_bytes = int(row[7])
        self.cache._writebacks = int(row[8])
        if self.topology is not None:
            self.topology.restore_resource_snapshot(row[9:])

    # -- stream/launch API (mirrors cuda<<<>>> + events) -------------------------
    def create_stream(self, name: str = "", priority: int = 0):
        return self.streams.create_stream(name, priority)

    def launch(
        self,
        stream_id: int,
        desc: KernelDesc,
        wait_events: Sequence[int] = (),
        record_events: Sequence[int] = (),
    ) -> WorkItem:
        return self.streams.launch(
            stream_id, desc.name, payload=desc, wait_events=wait_events, record_events=record_events
        )

    def create_event(self):
        return self.streams.create_event()

    # -- logging -------------------------------------------------------------------
    def _emit(self, line: str) -> None:
        self.log.append(line)
        if self.cfg.verbose:
            print(line)

    # -- main loop -------------------------------------------------------------------
    def run(self) -> SimResult:
        if self.cfg.engine == "cycle":
            self._run_cycle()
        elif self.cfg.engine == "event":
            self._run_event()
        elif self.cfg.engine == "compiled":
            from .compiled import run_compiled  # deferred: compiled imports us

            return run_compiled(self)
        else:
            raise ValueError(
                f"unknown SimConfig.engine {self.cfg.engine!r} "
                "(want 'cycle', 'event' or 'compiled')"
            )
        return SimResult(
            cycles=self._cycle,
            stats=self.stats,
            clean=self.clean,
            clean_fail=self.clean_fail,
            timeline=self.timeline,
            log=self.log,
            devices=dict(self.stream_devices),
        )

    def _launch(self, w: WorkItem, cycle: int) -> _Run:
        """Start one queued kernel (shared by both engine loops)."""
        cfg = self.cfg
        desc: KernelDesc = w.payload  # type: ignore[assignment]
        self.streams.mark_launched(w)
        topo = self.topology
        if topo is None:
            n_sharers = len(self._active) + 1
        else:
            if not 0 <= desc.device < topo.n_devices:
                raise ValueError(
                    f"kernel {desc.name!r} targets device {desc.device} but the "
                    f"topology {cfg.topology_shape} has {topo.n_devices} devices"
                )
            # Compute units are per chip: only co-resident kernels on the
            # same device share its FLOP rate.
            n_sharers = sum(1 for r in self._active if r.device == desc.device) + 1
        compute_end = cycle + self.compute.cycles_for(desc.flops, n_sharers)
        run = _Run(
            desc,
            w,
            cycle,
            compute_end,
            cfg.max_synth_beats,
            cfg.stream_slowdown.get(w.stream_id, 1.0),
        )
        if topo is None:
            run.cache = self.cache
            run.hbm = self.hbm
        else:
            run.cache = topo.caches[desc.device]
            run.hbm = topo.hbms[desc.device]
            # Non-empty on multi-device topologies: the kernel's explicit
            # ici_route (or default ring-successor route) resolved to link
            # hops; flips the ICI issue path from the legacy single link to
            # hop-by-hop routed occupancy.
            run.hops = topo.hops_for(desc)
            # First launch binds the stream to its device — the stream ×
            # device attribution map (SimResult.devices / StatsFrame axis).
            self.stream_devices.setdefault(w.stream_id, desc.device)
        self._active.append(run)
        if run.trace is None:
            self._n_synth += 1
        self.timeline.on_launch(w.stream_id, desc.uid, cycle, desc.name)
        self._emit(f"launching kernel name: {desc.name} uid: {desc.uid} stream: {w.stream_id}")
        if self._faults is not None:
            self._faults.arm_launch(run, w.stream_id, cycle)
        return run

    def _run_cycle(self) -> None:
        """Reference loop: one Python iteration per simulated cycle."""
        cfg = self.cfg
        serialize = cfg.serialize_streams or not cfg.concurrent_streams
        while self.streams.pending() > 0:
            if self._cycle >= cfg.max_cycles:
                raise RuntimeError(f"simulation exceeded max_cycles={cfg.max_cycles}")
            cycle = self._cycle
            if self.topology is None:
                self.cache.tick(cycle)
            else:
                for cache in self.topology.caches:
                    cache.tick(cycle)

            # Launch at most one kernel per cycle (Accel-Sim launches happen on
            # distinct cycles; this stagger is also what keeps the §5.1
            # latency-bound benchmark free of same-cycle stat collisions).
            cands = self.streams.launchable(serialize=serialize)
            if cands:
                self._launch(cands[0], cycle)

            # Apply faults due this cycle (after the launch step, so specs
            # armed with after=0 fire immediately; same position as the
            # event loop, keeping the two engines' event orders identical).
            faults = self._faults
            if faults is not None and faults.next <= cycle:
                faults.process(self, cycle)

            # Issue memory accesses for every active kernel (uid order — the
            # deterministic analog of GPGPU-Sim's core iteration order).
            for run in list(self._active):
                self._issue(run, cycle)

            # Retire finished kernels.
            for run in list(self._active):
                if run.drained() and cycle >= run.compute_end and cycle >= run.next_issue_cycle:
                    self._retire(run, cycle)

            self._cycle += 1
        if self._faults is not None:
            self._faults.finish(self, self._cycle)

    def _run_event(self) -> None:
        """Event-driven loop with exact cycle-skipping.

        Invariant: every cycle on which the cycle-stepped loop would change
        any state is visited, and visited cycles run the exact per-cycle
        body.  A cycle can only be interesting if (a) an MSHR fetch comes due
        — handled lazily, installs land at their own ready cycles; (b) a
        kernel is launchable — only at start and the cycle after a retire
        (``mark_done`` is the sole transition that frees a stream / fires an
        event), tracked by ``launch_ready``; (c) some run issues — at
        ``next_issue_cycle``, and every subsequent cycle while it still has
        work (degrading to per-cycle stepping exactly where the reference
        loop does per-cycle work); or (d) a drained run retires — at
        ``max(compute_end, next_issue_cycle)``.  The next visited cycle is
        the min over (b)-(d); pure synthesized-beat stretches are additionally
        collapsed by :meth:`_fast_forward`.
        """
        cfg = self.cfg
        serialize = cfg.serialize_streams or not cfg.concurrent_streams
        streams = self.streams
        active = self._active
        cache = self.cache
        heap = cache._mshr_heap
        max_cycles = cfg.max_cycles
        faults = self._faults
        if streams.pending() == 0:
            if faults is not None:
                faults.finish(self, self._cycle)
            return
        topo = self.topology
        launch_ready = True
        cycle = self._cycle
        while True:
            if cycle >= max_cycles:
                self._cycle = cycle
                raise RuntimeError(f"simulation exceeded max_cycles={cfg.max_cycles}")
            if topo is None:
                if heap and heap[0][0] <= cycle:
                    cache.tick(cycle)
            else:
                for c in topo.caches:
                    h = c._mshr_heap
                    if h and h[0][0] <= cycle:
                        c.tick(cycle)

            if launch_ready:
                w = streams.next_launchable(serialize=serialize)
                if w is None:
                    launch_ready = False
                else:
                    self._launch(w, cycle)

            # Apply faults due this cycle (same loop position as the cycle
            # engine; the nxt / fast-forward caps below guarantee every
            # pending fault's exact cycle is visited).
            if faults is not None and faults.next <= cycle:
                faults.process(self, cycle)

            # Collapse deterministic stretches into one vectorized batch:
            # pure synthesized-beat windows, or dependent hit-chain windows.
            # Topology runs step per-cycle instead: both fast-forward paths
            # assume the single shared cache/HBM/ICI triple, and FF is a pure
            # speed optimization (provably bit-identical to stepping), so
            # skipping it under a topology changes nothing observable.
            if active and not launch_ready and topo is None:
                n_synth = self._n_synth
                if n_synth == len(active):
                    nxt = self._fast_forward(cycle)
                    if nxt > cycle:
                        cycle = nxt if nxt < max_cycles else max_cycles
                        continue
                elif n_synth == 0:
                    nxt = self._fast_forward_dep(cycle)
                    if nxt > cycle:
                        cycle = nxt if nxt < max_cycles else max_cycles
                        continue

            for run in active:
                if run.next_issue_cycle <= cycle:
                    self._issue_event(run, cycle)

            # ---- retire + next interesting cycle, one pass
            to_retire = None
            nxt = cycle + 1 if launch_ready else max_cycles
            for run in active:
                t = run.next_issue_cycle
                if (
                    run.trace_pos >= run.trace_len
                    and run.syn_rd == 0
                    and run.syn_wr == 0
                    and run.syn_ici == 0
                ):
                    if run.compute_end > t:
                        t = run.compute_end  # drained: wake at retire time
                    if t <= cycle:  # retire condition met this cycle
                        if to_retire is None:
                            to_retire = [run]
                        else:
                            to_retire.append(run)
                        continue
                elif t <= cycle:
                    t = cycle + 1
                if t < nxt:
                    nxt = t
            if to_retire is not None:
                for run in to_retire:
                    self._retire(run, cycle)
                if streams.pending() == 0:
                    self._cycle = cycle + 1
                    if faults is not None:
                        faults.finish(self, self._cycle)
                    return
                launch_ready = True
                if cycle + 1 < nxt:
                    nxt = cycle + 1
            if faults is not None and faults.next < nxt:
                nxt = faults.next  # visit the fault's exact cycle
            cycle = nxt

    # -- access issue ------------------------------------------------------------------
    def _issue(self, run: _Run, cycle: int) -> None:
        """Reference per-cycle issue (cycle engine)."""
        if cycle < run.next_issue_cycle:
            return

        # Straggler injection: a slowed stream accrues fractional issue tokens.
        run.issue_tokens += 1.0 / run.slowdown
        if run.issue_tokens < 1.0:
            return
        run.issue_tokens -= 1.0
        self._issue_body(run, cycle)

    def _issue_body(self, run: _Run, cycle: int) -> None:
        cfg = self.cfg
        sid = run.sid
        budget = 1 if run.desc.dependent else run.desc.issue_width
        while budget > 0:
            acc = self._next_access(run)
            if acc is None:
                return
            access, n_lines = acc
            if access.atype in (AccessType.ICI_SND, AccessType.ICI_RCV):
                # Collectives bypass VMEM; they occupy ICI link bandwidth.
                hops = run.hops
                if hops:
                    # Routed over the topology's links (docs/DESIGN.md
                    # §5.14): store-and-forward — hop i+1 enters its link's
                    # contention queue when hop i completes — with one
                    # ICI_HOP stat event per line per link traversed, on the
                    # sending stream.  The legacy single-link ledger is
                    # untouched on this path.
                    if self._occupy_bw:
                        nb = n_lines * cfg.line_size
                        links = self.topology.links
                        t = cycle
                        for hop in hops:
                            t = links[hop].occupy(nb, t)
                    self._count(_ICI_HOP, AccessOutcome.MISS, sid, cycle,
                                n_lines * len(hops))
                elif self._occupy_bw:
                    self.ici.occupy(n_lines * cfg.line_size, cycle)
                self._count(access.atype, AccessOutcome.MISS, sid, cycle, n_lines)
                if run.desc.trace is not None and run.trace_pos < len(run.desc.trace):
                    # ICI access from an explicit trace: consume the trace
                    # entry (the seed only decremented synth counters here,
                    # livelocking any trace that contained an ICI access).
                    run.trace_pos += 1
                else:
                    self._advance(run, access, n_lines)
                budget -= 1
                continue

            if run.desc.trace is not None and run.trace_pos < len(run.desc.trace):
                # Explicit traces go through the VMEM residency model.
                decision = self._trace_access(run, access, cycle, sid)
                if decision is None:
                    return  # reservation failure → retry next cycle
                budget -= 1
            else:
                # Synthesized streaming beats bypass residency (.cg analog):
                # straight HBM traffic, classified MISS.  Writes share the
                # half-duplex HBM bucket with reads; the distinction is kept
                # for byte attribution (Bandwidth.total_wr_bytes).
                is_wr = access.atype in (AccessType.GLOBAL_ACC_W, AccessType.KV_ACC_W)
                if self._occupy_bw:
                    run.hbm.occupy(n_lines * cfg.line_size, cycle, is_write=is_wr)
                self._count(access.atype, AccessOutcome.MISS, sid, cycle, n_lines)
                self._advance(run, access, n_lines)
                budget -= 1

    def _issue_event(self, run: _Run, cycle: int) -> None:
        """Event-engine issue: semantically identical to :meth:`_issue` for
        ``cycle >= run.next_issue_cycle`` (the caller guarantees the guard),
        with the §5.1 hot path — one dependent VMEM trace access — inlined.
        """
        if run.slowdown != 1.0:
            run.issue_tokens += 1.0 / run.slowdown
            if run.issue_tokens < 1.0:
                return
            run.issue_tokens -= 1.0

        tp = run.trace_pos
        if run.dep and tp < run.trace_len:
            access = run.trace[tp]
            at = access.atype
            if at != _ICI_SND and at != _ICI_RCV:
                cfg = self.cfg
                ls = cfg.line_size
                addr = access.addr
                size = access.size
                lo = addr // ls
                hi = (addr + (size if size > 1 else 1) - 1) // ls
                is_wr = at == _GLOBAL_W or at == _KV_W
                sid = run.sid
                engine = self.engine
                cache_access = run.cache.access_line
                if lo == hi:
                    decision = cache_access(lo, is_wr, cycle, sid)
                    outcome = decision.outcome
                    if outcome == _RESFAIL:
                        engine.record_fail(at, decision.fail_reason, sid, 1, cycle)
                        return
                    engine.record(at, outcome, sid, 1, cycle)
                else:
                    decision = None
                    for tag in range(lo, hi + 1):
                        decision = cache_access(tag, is_wr, cycle, sid)
                        outcome = decision.outcome
                        if outcome == _RESFAIL:
                            engine.record_fail(at, decision.fail_reason, sid, 1, cycle)
                            return
                        engine.record(at, outcome, sid, 1, cycle)
                run.trace_pos = tp + 1
                if decision.outcome == _HIT:
                    wait = cfg.vmem_hit_latency
                else:
                    wait = decision.ready_cycle - cycle
                    if wait < 1:
                        wait = 1
                if run.slowdown != 1.0:
                    run.next_issue_cycle = cycle + int(wait * run.slowdown)
                else:
                    run.next_issue_cycle = cycle + wait
                return

        self._issue_body(run, cycle)

    # -- synthesized-beat fast-forward ------------------------------------------------
    def _fast_forward(self, cycle: int) -> int:
        """Batch-issue pure synthesized-beat cycles; returns the new cycle.

        Preconditions (checked here; any miss returns ``cycle`` unchanged and
        the caller falls back to per-cycle stepping): every active run is
        trace-free, un-slowed, with no fractional issue tokens and no future
        ``next_issue_cycle``; no kernel is launchable (caller guarantees);
        and no MSHR fetch comes due inside the window.  Under those
        conditions the per-cycle reference loop is fully determined:
        each run issues ``issue_width`` (or 1 if dependent) beats per cycle
        in active-list order, each beat occupying HBM/ICI and recording one
        MISS event.  The window ends one cycle before the earliest retire
        (``E``); beats for ``[cycle, E-1]`` are emitted in exactly the
        reference order (cycle-major, then active-list order), bandwidth
        pointers advanced with bit-identical float arithmetic, and stats
        landed through one ``record_batch``.  Cycle ``E`` itself is processed
        by the normal loop body (remaining beats, then the retire).
        """
        cfg = self.cfg
        active = self._active
        if self.topology is not None:
            return cycle  # routed ICI / per-device resources: step per-cycle
        E = cfg.max_cycles
        for run in active:
            if run.slowdown != 1.0 or run.issue_tokens != 0.0:
                return cycle
            rd, wr, ici = run.syn_rd, run.syn_wr, run.syn_ici
            if rd or wr or ici:
                if run.next_issue_cycle > cycle:
                    return cycle
                b = run.syn_lines_per_beat
                beats = (rd + b - 1) // b + (wr + b - 1) // b + (ici + b - 1) // b
                budget = 1 if run.dep else run.desc.issue_width
                t = cycle + (beats + budget - 1) // budget - 1  # drain cycle
                if run.compute_end > t:
                    t = run.compute_end
            else:
                t = run.compute_end
                if run.next_issue_cycle > t:
                    t = run.next_issue_cycle
                if t < cycle:
                    t = cycle
            if t < E:
                E = t
        rc = self.cache.earliest_ready()
        if rc is not None and rc < E:
            E = rc  # never emit past a pending MSHR install
        faults = self._faults
        if faults is not None and faults.next < E:
            E = faults.next  # never emit across a pending fault cycle
        if E <= cycle:
            return cycle

        K = E - cycle
        ls = cfg.line_size
        col_t: List[np.ndarray] = []
        col_n: List[np.ndarray] = []
        col_c: List[np.ndarray] = []
        col_s: List[np.ndarray] = []
        col_r: List[np.ndarray] = []
        for pos, run in enumerate(active):
            rd, wr, ici = run.syn_rd, run.syn_wr, run.syn_ici
            if not (rd or wr or ici):
                continue
            b = run.syn_lines_per_beat
            budget = 1 if run.dep else run.desc.issue_width
            parts_t: List[np.ndarray] = []
            parts_n: List[np.ndarray] = []
            for rem, at in ((rd, _GLOBAL_R), (wr, _GLOBAL_W), (ici, _ICI_SND)):
                if rem <= 0:
                    continue
                nph = (rem + b - 1) // b
                sizes = np.full(nph, b, dtype=np.int64)
                sizes[-1] = rem - (nph - 1) * b
                parts_n.append(sizes)
                parts_t.append(np.full(nph, int(at), dtype=np.int64))
            sizes = np.concatenate(parts_n)
            types = np.concatenate(parts_t)
            nb = min(len(sizes), K * budget)
            sizes = sizes[:nb]
            types = types[:nb]
            # consume in rd → wr → ici order, exactly like _advance
            t_rd = int(sizes[types == int(_GLOBAL_R)].sum())
            t_wr = int(sizes[types == int(_GLOBAL_W)].sum())
            t_ici = int(sizes[types == int(_ICI_SND)].sum())
            run.syn_rd -= t_rd
            run.syn_wr -= t_wr
            run.syn_ici -= t_ici
            run.syn_cursor += (t_rd + t_wr + t_ici) * ls
            col_t.append(types)
            col_n.append(sizes)
            col_c.append(cycle + np.arange(nb, dtype=np.int64) // budget)
            col_s.append(np.full(nb, run.sid, dtype=np.int64))
            col_r.append(np.full(nb, pos, dtype=np.int64))
        if not col_t:
            return E  # nothing issues in the window (all drained, waiting on compute)

        types = np.concatenate(col_t)
        sizes = np.concatenate(col_n)
        cycles = np.concatenate(col_c)
        sids = np.concatenate(col_s)
        rpos = np.concatenate(col_r)
        order = np.lexsort((rpos, cycles))  # stable: cycle-major, active order
        types = types[order]
        sizes = sizes[order]
        cycles = cycles[order]
        sids = sids[order]

        if self._occupy_bw:
            is_ici = types == int(_ICI_SND)
            if is_ici.any():
                _occupy_sequence(self.ici, cycles[is_ici], sizes[is_ici] * ls, None,
                                 ops=self._ops)
            hbm_sel = ~is_ici
            if hbm_sel.any():
                _occupy_sequence(
                    self.hbm,
                    cycles[hbm_sel],
                    sizes[hbm_sel] * ls,
                    types[hbm_sel] == int(_GLOBAL_W),
                    ops=self._ops,
                )
        self.engine.record_batch(
            types,
            np.full(len(types), int(_MISS), dtype=np.int64),
            sids,
            counts=sizes.astype(np.uint64),
            cycles=cycles,
        )
        return E

    #: max chain accesses scanned per run per fast-forward window
    _DEP_FF_CAP = 1 << 15
    #: chains spanning at least this many groups use the vectorized
    #: resident-tag probe instead of per-group dict lookups
    _DEP_PROBE_MIN_GROUPS = 8

    def _fast_forward_dep(self, cycle: int) -> int:
        """Batch dependent hit-chain cycles; returns the new cycle.

        While every active run is a dependent trace kernel whose next
        accesses HIT resident lines, the reference loop is fully determined:
        each run issues one access per ``vmem_hit_latency`` stride, each a
        HIT that only touches LRU recency (residency never shrinks inside
        the window — hits install nothing, and the window ends before any
        MSHR promotion).  The window ends at the earliest non-hit access,
        issue wake-up of a stalled run, retire, or promotion; events before
        that are emitted in reference order (cycle-major, then active-list
        order) through one ``record_batch``, and the LRU effect is replayed
        exactly by moving each touched line in final-touch order.
        """
        cfg = self.cfg
        if self.topology is not None:
            return cycle  # per-device caches: step per-cycle instead
        cache = self.cache
        lines = cache._lines
        active = self._active
        hl = cfg.vmem_hit_latency
        stride = hl if hl >= 1 else 1
        E = cfg.max_cycles
        scanners = None
        for pos, run in enumerate(active):
            if run.slowdown != 1.0 or run.issue_tokens != 0.0:
                return cycle
            tp = run.trace_pos
            if tp >= run.trace_len:
                if run.syn_rd or run.syn_wr or run.syn_ici:
                    return cycle  # trace done but synth beats remain — bail
                t = run.compute_end
                if run.next_issue_cycle > t:
                    t = run.next_issue_cycle
                if t < cycle:
                    t = cycle
                if t < E:
                    E = t  # drained: retires at t
                continue
            if not run.dep:
                return cycle
            if run.ff_gend is None:
                run._build_ff(cfg.line_size)
            g_end = run.ff_gend
            g = run.ff_g
            while g_end[g] <= tp:
                g += 1  # resync the group cursor (trace_pos moved elsewhere)
            run.ff_g = g
            nic = run.next_issue_cycle
            start = nic if nic > cycle else cycle
            if not run.ff_gok[g] or run.ff_gtag[g] not in lines:
                # next access is not a chain hit (residency is constant
                # inside the window, so this holds at `start` too)
                if start <= cycle:
                    return cycle  # it issues right now — no window
                if start < E:
                    E = start
                continue
            if scanners is None:
                scanners = [(pos, run, start)]
            else:
                scanners.append((pos, run, start))
        rc = cache.earliest_ready()
        if rc is not None and rc < E:
            E = rc  # promotions mutate residency/LRU — end the window first
        faults = self._faults
        if faults is not None and faults.next < E:
            E = faults.next  # never emit across a pending fault cycle
        if E <= cycle or scanners is None:
            return cycle

        chains = []
        for pos, run, start in scanners:
            g_ok = run.ff_gok
            g_tag = run.ff_gtag
            g_end = run.ff_gend
            ng = len(g_end)
            tp = run.trace_pos
            tl = run.trace_len
            cap = tp + self._DEP_FF_CAP
            g = run.ff_g
            j = tp
            # First access index that would end the window: the scan cap, or
            # the first access issuing at/after E (the scalar loop consumes
            # the group containing it, then breaks).
            if E > start:
                jcut = min(cap, tp + (E - start + stride - 1) // stride)
            else:
                jcut = tp
            L = int(np.searchsorted(run.ff_gend_np, jcut, side="left"))
            if L < g:
                L = g
            hi = L + 1 if L + 1 < ng else ng
            if hi - g >= self._DEP_PROBE_MIN_GROUPS:
                # Long chain: one batched cache-tag probe over every group
                # this window could consume (sorted-membership against the
                # cache's resident-tag snapshot) instead of per-group dict
                # lookups.  G = first non-chain-hit group; the scalar loop
                # stops at min(G, L+1) with j at the last consumed group end.
                res = cache.resident_mask(run.ff_gtag_np[g:hi], self._ops)
                bad = np.flatnonzero(~(run.ff_gok_np[g:hi] & res))
                G = g + int(bad[0]) if bad.size else hi
                g_stop = G if G <= L else L + 1
                if g_stop > g:
                    j = g_end[g_stop - 1]
                g = g_stop
            else:
                # scan whole groups: one residency lookup per touched line
                while g < ng and g_ok[g] and g_tag[g] in lines:
                    j = g_end[g]
                    g += 1
                    if j >= cap or start + (j - tp) * stride >= E:
                        break
            if j == tl and not (run.syn_rd or run.syn_wr or run.syn_ici):
                # chain drains the whole trace → the next event is the retire
                t = run.compute_end
                last_nic = start + (j - tp - 1) * stride + hl
                if last_nic > t:
                    t = last_nic
                if t < E:
                    E = t
            else:
                c = start + (j - tp) * stride  # first non-hit access (or cap)
                if c < E:
                    E = c
            chains.append((pos, run, tp, j, start))
        if E <= cycle:
            return cycle

        # cut each chain at the final window end and emit
        col_at: List[np.ndarray] = []
        col_tag: List[np.ndarray] = []
        col_wr: List[np.ndarray] = []
        col_c: List[np.ndarray] = []
        col_s: List[np.ndarray] = []
        col_r: List[np.ndarray] = []
        for pos, run, tp, jmax, start in chains:
            if start > E - 1:
                continue  # wakes after the window closes — untouched
            kept = jmax - tp
            kcut = (E - 1 - start) // stride + 1
            if kept > kcut:
                kept = kcut
            j2 = tp + kept
            col_at.append(run.ff_at_np[tp:j2])
            col_tag.append(run.ff_tag_np[tp:j2])
            col_wr.append(run.ff_wr_np[tp:j2])
            col_c.append(start + stride * np.arange(kept, dtype=np.int64))
            col_s.append(np.full(kept, run.sid, dtype=np.int64))
            col_r.append(np.full(kept, pos, dtype=np.int64))
            run.trace_pos = j2
            run.next_issue_cycle = start + (kept - 1) * stride + hl
        if not col_at:
            return E  # every chain wakes at/after E — pure jump
        at_m = np.concatenate(col_at)
        tag_m = np.concatenate(col_tag)
        wr_m = np.concatenate(col_wr)
        c_m = np.concatenate(col_c)
        s_m = np.concatenate(col_s)
        r_m = np.concatenate(col_r)
        order = np.lexsort((r_m, c_m))  # stable: cycle-major, active order
        at_m = at_m[order]
        tag_m = tag_m[order]
        wr_m = wr_m[order]
        c_m = c_m[order]
        s_m = s_m[order]

        self.engine.record_batch(
            at_m, np.full(len(at_m), int(_HIT), dtype=np.int64), s_m, cycles=c_m
        )
        # Replay the LRU effect: each touched line ends with last_use = its
        # final touch cycle, and touched lines move behind untouched ones in
        # final-touch order — identical to per-touch move_to_end.
        m = len(tag_m)
        u, first_rev = np.unique(tag_m[::-1], return_index=True)
        last_idx = m - 1 - first_rev
        apply_order = np.argsort(last_idx)
        for tg, lc in zip(u[apply_order].tolist(), c_m[last_idx[apply_order]].tolist()):
            ln = lines[tg]
            ln.last_use = lc
            lines.move_to_end(tg)
        if wr_m.any():
            for tg in np.unique(tag_m[wr_m]).tolist():
                lines[tg].dirty = True
        return E

    def _trace_access(self, run: _Run, access: Access, cycle: int, sid: int) -> Optional[CacheDecision]:
        cfg = self.cfg
        last_decision: Optional[CacheDecision] = None
        for tag in access.lines(cfg.line_size):
            decision = run.cache.access_line(
                tag, access.atype in (AccessType.GLOBAL_ACC_W, AccessType.KV_ACC_W), cycle, sid
            )
            if decision.outcome == AccessOutcome.RESERVATION_FAILURE:
                self.engine.record_fail(access.atype, decision.fail_reason, sid, 1, cycle)
                return None
            self._count(access.atype, decision.outcome, sid, cycle, 1)
            last_decision = decision
        run.trace_pos += 1
        if run.desc.dependent and last_decision is not None:
            if last_decision.outcome == AccessOutcome.HIT:
                wait = cfg.vmem_hit_latency
            else:
                wait = max(last_decision.ready_cycle - cycle, 1)
            # straggler injection scales the dependent-load latency too
            # (run.slowdown, not the config base: transient fault slowdown
            # windows live on the run, and the event engine's inlined hot
            # path already reads run.slowdown)
            run.next_issue_cycle = cycle + int(wait * run.slowdown)
        return last_decision

    def _next_access(self, run: _Run) -> Optional[Tuple[Access, int]]:
        """The next access event and the number of lines it represents."""
        d = run.desc
        if d.trace is not None and run.trace_pos < len(d.trace):
            return d.trace[run.trace_pos], 1
        beat = run.syn_lines_per_beat
        if run.syn_rd > 0:
            n = min(beat, run.syn_rd)
            return Access(AccessType.GLOBAL_ACC_R, run.syn_cursor, n * self.cfg.line_size), n
        if run.syn_wr > 0:
            n = min(beat, run.syn_wr)
            return Access(AccessType.GLOBAL_ACC_W, run.syn_cursor, n * self.cfg.line_size), n
        if run.syn_ici > 0:
            n = min(beat, run.syn_ici)
            return Access(AccessType.ICI_SND, run.syn_cursor, n * self.cfg.line_size), n
        return None

    def _advance(self, run: _Run, access: Access, n_lines: int) -> None:
        if access.atype == AccessType.GLOBAL_ACC_R and run.syn_rd:
            run.syn_rd -= n_lines
        elif access.atype == AccessType.GLOBAL_ACC_W and run.syn_wr:
            run.syn_wr -= n_lines
        elif access.atype in (AccessType.ICI_SND, AccessType.ICI_RCV) and run.syn_ici:
            run.syn_ici -= n_lines
        run.syn_cursor += n_lines * self.cfg.line_size

    def _count(self, atype: int, outcome: int, sid: int, cycle: int, n: int) -> None:
        """One event → all three stat views (tip per-stream, tip per-window,
        clean-with-undercount).  ``n`` covers beat-compressed events.  The
        clean build loses the update iff a *different* stream touched the
        same (type, outcome) cell in the same cycle (§5.2)."""
        self.engine.record(atype, outcome, sid, n, cycle)

    # -- retire ------------------------------------------------------------------------
    def _retire(self, run: _Run, cycle: int) -> None:
        if self._faults is not None:
            # Resolve this run's still-pending fault specs before the exit
            # report renders, so the report's stream stats include them.
            self._faults.on_retire(self, run, cycle)
        self._active.remove(run)
        if run.trace is None:
            self._n_synth -= 1
        self.streams.mark_done(run.work)
        self.timeline.on_done(run.work.stream_id, run.desc.uid, cycle)
        sid = run.work.stream_id
        # Paper §3.1: report only the exiting kernel's stream stats.  The
        # report is a StatsFrame selection through the sink subsystem; the
        # single-stream frame matrix equals the legacy ``stream_matrix``
        # exactly, so the text rendering stays byte-identical to the seed
        # printer (shared formatter; gated by benchmarks/query_overhead.py).
        buf = io.StringIO()
        buf.write(f"kernel '{run.desc.name}' uid {run.desc.uid} finished on stream {sid} @ cycle {cycle}\n")
        self.timeline.print_kernel(buf, sid, run.desc.uid)
        # The frame is cached across retires; rebuilt if a recorder swapped
        # the engine after construction (repro.sim.compiled / EventJournal).
        frame = self._frame
        if frame is None or frame._src is not self.engine:
            frame = self._frame = StatsFrame(self.engine, timeline=self.timeline)
        report = stream_report(
            frame,
            sid,
            source="sim",
            event="kernel_exit",
            cache_name="Total_core_cache_stats",
            fail_cache_name="Total_core_cache_fail_stats",
            header=buf.getvalue(),
            fields={"kernel": run.desc.name, "uid": run.desc.uid, "cycle": cycle},
        )
        self._emit(render_text(report).rstrip("\n"))
        for sink in self.sinks:
            sink.emit(report)
        # End of the kernel's stat window (m_stats_pw semantics).
        self.engine.clear_pw()
