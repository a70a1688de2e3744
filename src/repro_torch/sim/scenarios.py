"""Scenario library — a registry of parameterized multi-stream workloads.

The paper validates per-stream stat tracking by "designing a series of
multi-stream microbenchmarks and checking their reported per-kernel,
per-stream counts".  This module turns that method into infrastructure: every
validation workload is a **registered scenario** — a named, parameterized
builder that returns

* a list of :class:`Launch` rows (stream name, kernel descriptor, event
  dependencies, stream priority) — the declarative form of a multi-stream
  workload, executable on either simulator engine; and
* an **expected-count oracle**: per-stream analytic access counts in the
  style of :func:`repro.sim.microbench.l2_lat_expected_counts`, or ``None``
  where no closed form exists (those scenarios are pinned by checked-in
  golden tables in ``tests/test_scenarios.py``).

Registry API::

    @scenario("mps_like", space={"tenants": (2, 3, 4)})
    def mps_like(tenants=4, kernels_each=3, ...): ...

    list_scenarios()            -> tuple of registered names
    get_spec(name)              -> ScenarioSpec (builder, defaults, space)
    build(name, **params)       -> ScenarioInstance
    build(name).run(engine=...) -> SimResult

Scenarios modeled here (beyond the paper's §5 suite, which
:mod:`repro.sim.microbench` registers as ``l2_lat`` / ``mixed_stream`` /
``deepbench``): priority-stream preemption pressure, copy/compute overlap,
fork-join event chains, bursty Poisson serving arrivals, cache-thrashing
adversarial pairs, homogeneous MPS-like concurrency, producer-consumer
pipelines, and stragglers.  Oracle derivations live in each builder's
docstring and in docs/DESIGN.md ("Scenario catalog & batch runner").

Oracle key convention (per stream name): ``HIT`` / ``MSHR_HIT`` / ``MISS`` /
``RES_FAIL`` are cumulative end-of-simulation counts summed over access
types; ``TOTAL`` is ``HIT + MSHR_HIT + MISS`` (successful line touches —
reservation failures retry, so they are excluded from TOTAL).  An oracle
asserts only the keys it provides.
"""

from __future__ import annotations

import copy
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .executor import SimConfig, SimResult, TPUSimulator
from .kernel_desc import KernelDesc, LINE_SIZE, pointer_chase_trace, streaming_trace
from ..core.faults import FaultPlan, KernelFaultSpec
from ..core.query import StatsFrame
from ..core.sinks import ReportSink
from ..core.stats import AccessType

__all__ = [
    "Launch",
    "ScenarioSpec",
    "ScenarioInstance",
    "scenario",
    "register_mech_oracle",
    "build",
    "get_spec",
    "list_scenarios",
    "space_draws",
    "divergent_draws",
    "value_only_draws",
    "ORACLE_KEYS",
    "DEFAULT_STREAM_NAME",
]

#: Oracle key convention (see module docstring) — exactly what
#: :meth:`repro.core.query.StatsFrame.outcome_counts` returns.  The middle
#: four keys are the miss-path mechanism lanes (``SimConfig.miss_mechanism``,
#: docs/DESIGN.md §5.10); they stay 0 under ``miss_mechanism="none"`` and
#: ``TOTAL`` (every successful demand access, counted once) is
#: mechanism-invariant by conservation.  The last five are the
#: fault-injection lanes (``SimConfig.fault_plan``, docs/DESIGN.md §5.11);
#: they stay 0 without a plan and never join ``TOTAL``.
ORACLE_KEYS = (
    "HIT", "MSHR_HIT", "MISS", "RES_FAIL", "TOTAL",
    "VICTIM_HIT", "MISS_CACHE_HIT", "PREFETCH_HIT", "PREFETCH_ISSUED",
    "ICI_HOPS",
    "KERNEL_ABORT", "RETRY", "TIMEOUT_EXPIRED", "SHED", "RECOVERED",
)

#: Launch.stream value meaning "the default stream" (id 0, like CUDA's).
DEFAULT_STREAM_NAME = ""

# --------------------------------------------------------------------------- mechanism oracles
#: scenario name -> adjuster(params, config, base_expected) -> expected|None.
#: Consulted by :meth:`ScenarioInstance.expected_for` when
#: ``config.miss_mechanism != "none"``: the adjuster returns the per-stream
#: oracle that holds *under that mechanism config*, or ``None`` when no
#: analytic claim is derivable for the given geometry (callers fall back to
#: golden tables, e.g. tests/test_mechanisms.py).
_MECH_ORACLES: Dict[str, Callable] = {}


def register_mech_oracle(name: str, adjuster: Callable) -> None:
    """Register a mechanism-aware oracle adjuster for scenario ``name``."""
    _MECH_ORACLES[name] = adjuster


_ZERO_MECH_LANES = {
    "VICTIM_HIT": 0, "MISS_CACHE_HIT": 0, "PREFETCH_HIT": 0, "PREFETCH_ISSUED": 0,
}

#: Fault lanes pinned to zero — what every non-fault scenario's oracle can
#: assert without a FaultPlan (docs/DESIGN.md §5.11).
_ZERO_FAULT_LANES = {
    "KERNEL_ABORT": 0, "RETRY": 0, "TIMEOUT_EXPIRED": 0, "SHED": 0, "RECOVERED": 0,
}


def mech_invariant_oracle(params, config, expected):
    """Adjuster for synthesized-beat scenarios: aggregate-cost kernels never
    touch the VMEM line cache, so no miss-path mechanism can engage — the
    base oracle holds verbatim and every mechanism lane is pinned to 0."""
    if expected is None:
        return None
    return {s: {**row, **_ZERO_MECH_LANES} for s, row in expected.items()}


def mech_totals_only_oracle(params, config, expected):
    """Adjuster for trace scenarios whose hit/miss split reshuffles under a
    mechanism but whose per-stream TOTALs are conserved (every successful
    demand access counts exactly once across HIT/MSHR_HIT/MISS and the
    three mechanism hit lanes)."""
    if expected is None:
        return None
    totals = {s: {"TOTAL": row["TOTAL"]} for s, row in expected.items() if "TOTAL" in row}
    return totals or None


@dataclass(frozen=True)
class Launch:
    """One kernel launch row: ``<<<..., stream>>>`` plus event dependencies.

    ``stream`` is a *name*; stream ids are assigned in order of first
    appearance (the default stream :data:`DEFAULT_STREAM_NAME` is always id
    0).  ``wait`` / ``record`` are event *labels*, resolved to simulator
    events on first mention.  ``priority`` applies to the stream at creation
    (first launch on that stream wins)."""

    stream: str
    desc: KernelDesc
    wait: Tuple[str, ...] = ()
    record: Tuple[str, ...] = ()
    priority: int = 0


@dataclass(frozen=True)
class ScenarioSpec:
    """Registry entry: builder + defaults + randomization space."""

    name: str
    builder: Callable
    defaults: Dict[str, object]
    #: param -> tuple of candidate values, for randomized/differential tests
    space: Dict[str, Tuple]
    doc: str = ""


_REGISTRY: Dict[str, ScenarioSpec] = {}


def scenario(name: str, *, space: Optional[Dict[str, Tuple]] = None):
    """Register a scenario builder.

    The builder's keyword defaults become the scenario's default params.  It
    returns ``(launches, expected)`` or ``(launches, expected, config)``
    where ``config`` maps :class:`~repro.sim.executor.SimConfig` attribute
    names to required overrides (e.g. a thrash-sized ``vmem_capacity``).
    """

    def deco(fn: Callable) -> Callable:
        import inspect

        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} registered twice")
        defaults = {
            k: p.default
            for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty
        }
        _REGISTRY[name] = ScenarioSpec(
            name=name,
            builder=fn,
            defaults=defaults,
            space=dict(space or {}),
            doc=next(iter((fn.__doc__ or "").strip().splitlines()), ""),
        )
        return fn

    return deco


def list_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_spec(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {', '.join(list_scenarios())}"
        ) from None


def build(name: str, **params) -> "ScenarioInstance":
    """Instantiate a registered scenario with ``params`` over its defaults."""
    spec = get_spec(name)
    unknown = set(params) - set(spec.defaults)
    if unknown:
        raise TypeError(f"scenario {name!r} has no params {sorted(unknown)}")
    merged = dict(spec.defaults)
    merged.update(params)
    out = spec.builder(**merged)
    if len(out) == 2:
        launches, expected = out
        config: Dict[str, object] = {}
    else:
        launches, expected, config = out
    return ScenarioInstance(
        name=name, params=merged, launches=list(launches), expected=expected,
        config_overrides=dict(config),
    )


@dataclass
class ScenarioInstance:
    """A built scenario: launch rows + oracle, runnable on either engine."""

    name: str
    params: Dict[str, object]
    launches: List[Launch]
    #: per-stream-name analytic counts, or None (golden-table scenario)
    expected: Optional[Dict[str, Dict[str, int]]]
    config_overrides: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self) -> None:
        # A stream's priority binds at creation (its first launch row), so a
        # priority anywhere it cannot take effect — on the pre-existing
        # default stream, or disagreeing between rows of one stream — would
        # be silently dropped.  Fail loudly at build time instead.
        seen: Dict[str, int] = {}
        for l in self.launches:
            if l.stream == DEFAULT_STREAM_NAME:
                if l.priority != 0:
                    raise ValueError(
                        f"scenario {self.name!r}: the default stream always has "
                        "priority 0; use a named stream to set one"
                    )
                continue
            prev = seen.setdefault(l.stream, l.priority)
            if prev != l.priority:
                raise ValueError(
                    f"scenario {self.name!r}: stream {l.stream!r} launches disagree "
                    f"on priority ({prev} vs {l.priority}); only the first row's "
                    "value could bind"
                )

    @property
    def stream_ids(self) -> Dict[str, int]:
        """Stream name -> id, mirroring :meth:`run`'s creation order."""
        ids = {DEFAULT_STREAM_NAME: 0}
        for l in self.launches:
            if l.stream not in ids:
                ids[l.stream] = max(ids.values()) + 1
        return ids

    def kernels_per_stream(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for l in self.launches:
            out[l.stream] = out.get(l.stream, 0) + 1
        return out

    def make_sim(
        self,
        engine: Optional[str] = None,
        config: Optional[SimConfig] = None,
        sinks: Optional[Sequence[ReportSink]] = None,
        sim_cls: type = TPUSimulator,
    ) -> TPUSimulator:
        """A fresh, fully-enqueued simulator for this scenario (streams
        created, events wired, kernels launched — ready to ``run()``).
        Scenario config overrides (then ``engine``) are applied on top of
        ``config``/defaults.  The caller's ``config`` object is never mutated
        — overrides land on a copy, so one config can seed many scenario
        runs.  The compiled-trace batch backend uses this to compile a shape
        without immediately running it; the batched divergent backend passes
        its own ``sim_cls`` (a TPUSimulator subclass with deferred report
        landing — see ``repro.sim.batched``)."""
        cfg = copy.copy(config) if config is not None else SimConfig()
        for k, v in self.config_overrides.items():
            if not hasattr(cfg, k):
                raise AttributeError(f"scenario {self.name!r} overrides unknown SimConfig.{k}")
            setattr(cfg, k, v)
        if engine is not None:
            cfg.engine = engine
        sim = sim_cls(cfg, sinks=sinks)
        ids = {DEFAULT_STREAM_NAME: 0}
        for l in self.launches:
            if l.stream not in ids:
                ids[l.stream] = sim.create_stream(l.stream, priority=l.priority).stream_id
        events: Dict[str, int] = {}
        for l in self.launches:
            for label in (*l.wait, *l.record):
                if label not in events:
                    events[label] = sim.create_event().event_id
        for l in self.launches:
            sim.launch(
                ids[l.stream],
                l.desc,
                wait_events=[events[e] for e in l.wait],
                record_events=[events[e] for e in l.record],
            )
        return sim

    def run(
        self,
        engine: Optional[str] = None,
        config: Optional[SimConfig] = None,
        sinks: Optional[Sequence[ReportSink]] = None,
    ) -> SimResult:
        """Execute on a fresh simulator (see :meth:`make_sim`)."""
        return self.make_sim(engine=engine, config=config, sinks=sinks).run()

    # -- oracle as a StatsFrame query ---------------------------------------------
    def frame(self, res: SimResult) -> StatsFrame:
        """``res``'s stats as a query frame with this scenario's stream
        *names* resolvable (``frame.filter(stream="prio_hi")``) and, for
        topology scenarios, the stream→device map bound
        (``frame.groupby("device")``)."""
        return StatsFrame(res.stats, timeline=res.timeline,
                          names=self.stream_ids, devices=res.devices or None)

    def expected_for(self, config=None) -> Optional[Dict]:
        """The per-stream oracle for a run under ``config``.

        With no config (or ``miss_mechanism="none"``) this is the builder's
        ``expected`` table unchanged.  Under an active miss-path mechanism
        the base oracle may no longer hold (mechanism hits reclassify
        misses), so the table is rewritten by the scenario's registered
        mechanism adjuster (:func:`register_mech_oracle`); scenarios without
        one return ``None`` — no analytic claim under that mechanism."""
        if config is None or getattr(config, "miss_mechanism", "none") == "none":
            return self.expected
        adjust = _MECH_ORACLES.get(self.name)
        if adjust is None:
            return None
        return adjust(dict(self.params), config, self.expected)

    def check_oracle(self, res: SimResult, config=None) -> Optional[Dict[str, object]]:
        """Declarative conformance: each expected per-stream row is one
        :meth:`~repro.core.query.StatsFrame.outcome_counts` query compared
        against the oracle's :data:`ORACLE_KEYS`.  Returns ``None`` when the
        scenario has no analytic oracle (golden-table scenarios, or an
        active ``config.miss_mechanism`` without a registered mechanism
        oracle — see :meth:`expected_for`), else
        ``{"ok": bool, "mismatches": [...]}`` — the payload the batch runner
        ships inline with every job."""
        expected = self.expected_for(config)
        if expected is None:
            return None
        frame = self.frame(res)
        mismatches = []
        for sname, exp in expected.items():
            got = frame.filter(stream=sname).outcome_counts()
            for key, want in exp.items():
                if got[key] != want:
                    mismatches.append(
                        {"stream": sname, "key": key, "want": want, "got": got[key]}
                    )
        return {"ok": not mismatches, "mismatches": mismatches}


# --------------------------------------------------------------------------- sweep helpers
def space_draws(name: str, k: int, seed: int = 0) -> List[Dict[str, object]]:
    """``k`` randomized param draws from a scenario's declared ``space`` —
    the differential suites' sampling helper.  Each draw picks one candidate
    per space axis with a seeded RNG; draws are full param dicts over the
    scenario defaults.  Distinct draws are distinct *shapes*: every scenario
    param can change the launch structure, so the compiled engine recompiles
    per draw (value-only variation lives in ``SimConfig`` — see
    ``repro.sim.executor.VALUE_ONLY_CONFIG``)."""
    spec = get_spec(name)
    rng = random.Random(seed)
    keys = sorted(spec.space)
    return [{key: rng.choice(spec.space[key]) for key in keys} for _ in range(k)]


def divergent_draws(k: int, seed: int = 0) -> List[Dict[str, object]]:
    """The whole-registry *divergent* sweep: ``k`` param draws from **every**
    scenario's space, as ``{"scenario": name, "params": {...}}`` job specs.

    Divergent means the draws deliberately differ in control flow — stream
    counts, trace lengths, launch staggers, fault arm points — so no two
    jobs share a shape and the vector (same-shape replay) backend cannot
    amortize them.  This is the workload the batched backend exists for;
    each scenario's draws are independently seeded so adding a scenario
    never reshuffles another's draws."""
    return [
        {"scenario": name, "params": params}
        for name in list_scenarios()
        for params in space_draws(name, k, seed=seed + _stable_seed(name))
    ]


def _stable_seed(name: str) -> int:
    """Deterministic per-scenario seed offset (hash() is salted per process)."""
    h = 0
    for ch in name:
        h = (h * 131 + ord(ch)) % 1_000_000_007
    return h


def value_only_draws(k: int, seed: int = 0,
                     base_max_cycles: int = 50_000_000) -> List[Dict[str, object]]:
    """``k`` randomized *value-only* ``SimConfig`` override dicts (jittered
    ``max_cycles``) — draws that share one scenario shape by construction,
    so a same-shape sweep compiles once and replays ``k`` times.  This is
    the benchmark's Monte-Carlo axis: the event engine must re-simulate
    every draw, the compiled engine must not."""
    rng = random.Random(seed)
    return [
        {"max_cycles": base_max_cycles + rng.randrange(1 << 20)}
        for _ in range(k)
    ]


# --------------------------------------------------------------------------- oracle helpers
def _lines(n_bytes: int) -> int:
    return (n_bytes + LINE_SIZE - 1) // LINE_SIZE


def _synth(name: str, *, rd: int = 0, wr: int = 0, ici: int = 0, flops: float = 0.0,
           base: int = 0, device: int = 0) -> Tuple[KernelDesc, int]:
    """An aggregate-cost kernel plus its exact access count: synthesized
    beats bypass VMEM residency and are classified MISS, so the per-kernel
    count is ``ceil(rd/line) + ceil(wr/line) + ceil(ici/line)`` regardless of
    scheduling — the most robust oracle the model offers.  ``device`` places
    the kernel on a topology device (distributed scenarios)."""
    kd = KernelDesc(
        name=name, flops=flops, hbm_rd_bytes=rd, hbm_wr_bytes=wr, ici_bytes=ici,
        addr_base=base, device=device,
    )
    return kd, _lines(rd) + _lines(wr) + _lines(ici)


def _miss_only(n: int) -> Dict[str, int]:
    return {"HIT": 0, "MSHR_HIT": 0, "MISS": n, "RES_FAIL": 0, "TOTAL": n}


# --------------------------------------------------------------------------- scenarios
@scenario("priority_preemption", space={"hi_kernels": (4, 8), "lo_streams": (2, 3),
                                        "lo_kernels": (2, 4)})
def priority_preemption(hi_kernels=8, lo_streams=3, lo_kernels=4, kb_per_kernel=32):
    """Priority-stream preemption pressure: one high-priority stream of many
    short kernels contends with low-priority streams for the one-per-cycle
    launch slot; the high-priority stream wins every contended slot
    (``cudaStreamCreateWithPriority`` idiom).

    Oracle: priorities change *scheduling*, never classification — every
    kernel is synthesized, so each stream's count is the sum of its kernels'
    line counts, all MISS.
    """
    launches: List[Launch] = []
    expected: Dict[str, Dict[str, int]] = {}
    nbytes = kb_per_kernel << 10
    hi_total = 0
    for i in range(hi_kernels):
        kd, n = _synth(f"hi_{i}", rd=nbytes, base=(i + 1) << 22)
        launches.append(Launch("prio_hi", kd, priority=1))
        hi_total += n
    expected["prio_hi"] = _miss_only(hi_total)
    for s in range(lo_streams):
        total = 0
        for i in range(lo_kernels):
            kd, n = _synth(f"lo{s}_{i}", rd=nbytes, wr=nbytes // 2,
                           base=(16 + s * lo_kernels + i) << 22)
            launches.append(Launch(f"prio_lo_{s}", kd))
            total += n
        expected[f"prio_lo_{s}"] = _miss_only(total)
    return launches, expected


@scenario("copy_compute_overlap", space={"chunks": (2, 3, 4)})
def copy_compute_overlap(chunks=4, chunk_kb=256, gemm_flops=2.0e7, out_kb=64):
    """Copy/compute overlap (double buffering): a copy stream prefetches
    chunk ``i`` and records an event; the compute stream's GEMM ``i`` waits
    on it while copy ``i+1`` proceeds concurrently.

    Oracle: both streams are synthesized-cost kernels (copies are straight
    HBM reads, GEMMs write their outputs), so counts are exact line sums,
    all MISS; the overlap shows in the timeline, not in the counts.
    """
    launches: List[Launch] = []
    copy_total = compute_total = 0
    for i in range(chunks):
        ckd, cn = _synth(f"copy_{i}", rd=chunk_kb << 10, base=(i + 1) << 24)
        launches.append(Launch("copy", ckd, record=(f"chunk_{i}",)))
        copy_total += cn
        gkd, gn = _synth(f"gemm_{i}", wr=out_kb << 10, flops=gemm_flops,
                         base=(64 + i) << 24)
        launches.append(Launch("compute", gkd, wait=(f"chunk_{i}",)))
        compute_total += gn
    return launches, {"copy": _miss_only(copy_total), "compute": _miss_only(compute_total)}


@scenario("fork_join", space={"rounds": (1, 2), "width": (2, 3, 4)})
def fork_join(rounds=2, width=3, work_kb=64):
    """Fork-join event dependency chains: per round, a root kernel records an
    event; ``width`` workers (one stream each) wait on it, run, and record
    their own; a join kernel waits on all workers (``cudaStreamWaitEvent``
    fan-in).

    Oracle: all kernels synthesized -> exact per-stream MISS line sums.
    """
    launches: List[Launch] = []
    nbytes = work_kb << 10
    root_total = join_total = 0
    worker_total = [0] * width
    for r in range(rounds):
        kd, n = _synth(f"fork_{r}", rd=nbytes, base=(r + 1) << 24)
        launches.append(Launch("fj_root", kd, record=(f"fork_{r}",)))
        root_total += n
        for w in range(width):
            kd, n = _synth(f"work_{r}_{w}", rd=nbytes, wr=nbytes // 2,
                           base=(8 + r * width + w) << 24)
            launches.append(
                Launch(f"fj_worker_{w}", kd, wait=(f"fork_{r}",), record=(f"done_{r}_{w}",))
            )
            worker_total[w] += n
        kd, n = _synth(f"join_{r}", wr=nbytes, base=(64 + r) << 24)
        launches.append(
            Launch("fj_join", kd, wait=tuple(f"done_{r}_{w}" for w in range(width)))
        )
        join_total += n
    expected = {"fj_root": _miss_only(root_total), "fj_join": _miss_only(join_total)}
    for w in range(width):
        expected[f"fj_worker_{w}"] = _miss_only(worker_total[w])
    return launches, expected


def _poisson_draw(rng: random.Random, lam: float) -> int:
    """Knuth's Poisson sampler over the scenario's seeded RNG."""
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


@scenario("poisson_burst", space={"servers": (2, 3), "bursts": (2, 3), "seed": (0, 1, 7)})
def poisson_burst(servers=3, bursts=3, lam=2.5, seed=0, req_lines=24):
    """Bursty serving arrivals: each server stream receives per-burst batches
    of decode-like requests, batch sizes drawn Poisson(lam) from a seeded RNG
    (deterministic given ``seed``) — the continuous-batching backlog shape.

    Oracle: request kernels are synthesized reads of
    ``req_lines + (request index mod 3) * 8`` lines, so each server's count
    is the (seed-determined) sum over its draws, all MISS.
    """
    rng = random.Random(seed)
    launches: List[Launch] = []
    expected: Dict[str, Dict[str, int]] = {}
    totals = [0] * servers
    for b in range(bursts):
        for s in range(servers):
            n_req = 1 + _poisson_draw(rng, lam)  # at least one request per burst
            for r in range(n_req):
                lines = req_lines + (r % 3) * 8
                kd, n = _synth(
                    f"decode_b{b}_s{s}_r{r}", rd=lines * LINE_SIZE,
                    base=((b * servers + s) * 64 + r) << 20,
                )
                launches.append(Launch(f"server_{s}", kd))
                totals[s] += n
    for s in range(servers):
        expected[f"server_{s}"] = _miss_only(totals[s])
    return launches, expected


@scenario("cache_thrash", space={"arr_lines": (24, 32), "passes": (2, 3)})
def cache_thrash(arr_lines=32, passes=3):
    """Cache-thrashing adversarial pair: two dependent-chase streams walk
    *disjoint* arrays, each half the VMEM working set, repeatedly — together
    they exceed capacity, so each pass evicts the other stream's lines.

    No closed form: the HIT/MISS split depends on LRU interleaving under
    concurrency, so this scenario is pinned by a checked-in golden table
    (``tests/test_scenarios.py``).  Capacity is overridden to
    ``arr_lines`` total lines (each array alone would fit; the pair cannot).
    """
    launches = []
    for i, name in enumerate(("thrash_a", "thrash_b")):
        trace = pointer_chase_trace(
            (i + 1) << 24, arr_lines, load_size=8, stride=LINE_SIZE
        ) * passes
        launches.append(Launch(name, KernelDesc(name=name, trace=list(trace), dependent=True)))
    return launches, None, {"vmem_capacity": arr_lines * LINE_SIZE}


@scenario("mps_like", space={"tenants": (2, 3, 4), "kernels_each": (2, 3)})
def mps_like(tenants=4, kernels_each=3, rd_kb=128, wr_kb=32, flops=1.0e7):
    """Homogeneous MPS-like concurrency: N identical tenant streams submit
    identical GEMM-shaped kernels — the fair-sharing sanity case in which
    every per-stream row must come out equal.

    Oracle: synthesized kernels -> per-tenant MISS =
    ``kernels_each * (rd_lines + wr_lines)``, identical across tenants.
    """
    launches = []
    per = 0
    for t in range(tenants):
        for k in range(kernels_each):
            kd, n = _synth(f"tenant{t}_k{k}", rd=rd_kb << 10, wr=wr_kb << 10,
                           flops=flops, base=((t * kernels_each + k) + 1) << 24)
            launches.append(Launch(f"tenant_{t}", kd))
            if t == 0:
                per += n
    return launches, {f"tenant_{t}": _miss_only(per) for t in range(tenants)}


@scenario("producer_consumer", space={"stages": (2, 3, 4)})
def producer_consumer(stages=3, stage_lines=32, producer_flops=5.0e7):
    """Producer-consumer pipeline: per stage, a producer writes a region and
    records an event; the consumer waits on it and reads the same region.

    Oracle: the producer's streaming writes first-touch every line (MISS,
    write-allocate).  ``producer_flops`` keeps each producer resident well
    past the HBM round-trip (``compute cycles ~ flops / flops_per_cycle >>
    hbm_latency``), so by the time its exit event releases the consumer all
    its lines are installed: the consumer's reads are pure HITs.  Producer
    MISS = consumer HIT = ``stages * stage_lines``; regions are disjoint and
    far under capacity, so no evictions perturb this.
    """
    launches = []
    nbytes = stage_lines * LINE_SIZE
    for s in range(stages):
        base = (s + 1) << 24
        launches.append(Launch(
            "producer",
            KernelDesc(name=f"produce_{s}",
                       trace=streaming_trace(base, nbytes, AccessType.GLOBAL_ACC_W),
                       flops=producer_flops),
            record=(f"stage_{s}",),
        ))
        launches.append(Launch(
            "consumer",
            KernelDesc(name=f"consume_{s}",
                       trace=streaming_trace(base, nbytes, AccessType.GLOBAL_ACC_R)),
            wait=(f"stage_{s}",),
        ))
    total = stages * stage_lines
    return launches, {
        "producer": {"HIT": 0, "MSHR_HIT": 0, "MISS": total, "RES_FAIL": 0, "TOTAL": total},
        "consumer": {"HIT": total, "MSHR_HIT": 0, "MISS": 0, "RES_FAIL": 0, "TOTAL": total},
    }


@scenario("straggler", space={"fast_streams": (2, 3), "short_kernels": (3, 6)})
def straggler(fast_streams=3, short_kernels=6, short_lines=16, long_lines=2048,
              slowdown=1.0):
    """Straggler: one stream runs a single long kernel while the others each
    run many short ones (the tail-latency shape); optional ``slowdown``
    additionally throttles the laggard's issue rate
    (``SimConfig.stream_slowdown``).

    Oracle: all synthesized -> laggard MISS = ``long_lines``; each fast
    stream MISS = ``short_kernels * short_lines``.  The slowdown stretches
    the timeline, never the counts.
    """
    launches = []
    kd, n_long = _synth("laggard_k", rd=long_lines * LINE_SIZE, base=1 << 28)
    launches.append(Launch("laggard", kd))
    expected = {"laggard": _miss_only(n_long)}
    for s in range(fast_streams):
        total = 0
        for i in range(short_kernels):
            kd, n = _synth(f"fast{s}_{i}", rd=short_lines * LINE_SIZE,
                           base=((s * short_kernels + i) + 2) << 20)
            launches.append(Launch(f"fast_{s}", kd))
            total += n
        expected[f"fast_{s}"] = _miss_only(total)
    config = {}
    if slowdown != 1.0:
        config = {"stream_slowdown": {1: float(slowdown)}}  # laggard is stream id 1
    return launches, expected, config


# --------------------------------------------------------------------------- fault scenarios (§5.11)
@scenario("fault_kernel_abort", space={"streams": (2, 3), "abort_after": (5, 1000)})
def fault_kernel_abort(streams=3, lines=64, abort_after=40, abort_streams=1):
    """Fault injection: every stream runs one synthesized read kernel; the
    first ``abort_streams`` streams carry an abort spec firing ``abort_after``
    cycles after their kernel's launch (``SimConfig.fault_plan``).

    Oracle (all synthesized, so fully analytic): a kernel issues
    ``issue_width`` single-line beats per cycle from its launch cycle, and an
    abort is processed *before* that cycle's issue — so a victim lands
    ``min(lines, abort_after * issue_width)`` MISSes.  Valid for
    ``lines <= SimConfig.max_synth_beats`` (4096): above it, aggregate-cost
    beats coalesce multiple lines each and the per-cycle line rate exceeds
    ``issue_width``, so the issued-before-abort count no longer holds.  The spec resolves
    ``KERNEL_ABORT`` iff it fired while work remained, else the kernel won
    the race and it sweeps to ``RECOVERED`` — conservation's two-sided coin,
    pinned per stream.  Healthy streams keep all fault lanes at 0.
    """
    launches = []
    expected = {}
    faults = []
    for s in range(streams):
        kd, n = _synth(f"fk{s}", rd=lines * LINE_SIZE, base=(s + 2) << 22)
        w = kd.issue_width
        launches.append(Launch(f"s_{s}", kd))
        row = {**_miss_only(n), **_ZERO_FAULT_LANES}
        if s < abort_streams:
            issued = min(n, abort_after * w)
            aborted = issued < n
            row.update(
                MISS=issued, TOTAL=issued,
                KERNEL_ABORT=int(aborted), RECOVERED=int(not aborted),
            )
            # stream ids bind in order of first appearance (default stream
            # is 0), so stream name "s_{s}" is id s+1; each stream launches
            # exactly one kernel, so the per-stream launch index is 0
            faults.append(
                KernelFaultSpec("abort", stream=s + 1, kernel=0, after=int(abort_after))
            )
        expected[f"s_{s}"] = row
    return launches, expected, {"fault_plan": FaultPlan(kernel_faults=tuple(faults))}


@scenario("fault_straggler", space={"slow_factor": (2.0, 4.0), "hbm_stall_at": (0, 64)})
def fault_straggler(fast_streams=2, short_kernels=3, short_lines=16, long_lines=512,
                    slow_after=20, slow_duration=200, slow_factor=3.0,
                    hbm_stall_at=0, hbm_stall_cycles=100):
    """Fault injection: the straggler shape under *transient* faults — the
    laggard's long kernel gets a slowdown window (issue rate divided by
    ``slow_factor`` for ``slow_duration`` cycles starting ``slow_after``
    cycles after launch), plus an optional HBM stall burst at absolute cycle
    ``hbm_stall_at`` (0 = off), both attributed to the laggard stream.

    Oracle: transient faults stretch the timeline, never the counts — every
    MISS count matches the fault-free straggler exactly, ``KERNEL_ABORT``
    stays 0 everywhere, and the laggard's ``RECOVERED`` equals the number of
    injected specs (each transient resolves exactly once: window closed,
    stall applied, or swept at retire/end-of-run).
    """
    launches = []
    kd, n_long = _synth("fs_laggard", rd=long_lines * LINE_SIZE, base=1 << 28)
    launches.append(Launch("laggard", kd))
    zeros = dict(_ZERO_FAULT_LANES)
    faults = [
        KernelFaultSpec("slowdown", stream=1, kernel=0, after=int(slow_after),
                        duration=int(slow_duration), factor=float(slow_factor)),
    ]
    if hbm_stall_at:
        faults.append(
            KernelFaultSpec("hbm_stall", stream=1, after=int(hbm_stall_at),
                            duration=int(hbm_stall_cycles))
        )
    expected = {"laggard": {**_miss_only(n_long), **zeros, "RECOVERED": len(faults)}}
    for s in range(fast_streams):
        total = 0
        for i in range(short_kernels):
            kd, n = _synth(f"fs{s}_{i}", rd=short_lines * LINE_SIZE,
                           base=((s * short_kernels + i) + 2) << 20)
            launches.append(Launch(f"fast_{s}", kd))
            total += n
        expected[f"fast_{s}"] = {**_miss_only(total), **zeros}
    return launches, expected, {"fault_plan": FaultPlan(kernel_faults=tuple(faults))}


# --------------------------------------------------------------------------- mechanism oracle wiring
def _cache_thrash_mech_oracle(params, config, expected):
    """cache_thrash under a mechanism (two dependent chases over disjoint
    ``arr_lines``-line arrays through an ``arr_lines``-line cache, so every
    line's reuse distance is ~2*arr_lines installs):

    * victim cache — once warm, the lines **not** in the main array number
      exactly ``arr_lines``; a victim cache that holds at least that many
      entries catches every re-miss (passes 2+), while one holding at most
      ``arr_lines // 2`` is always overrun before reuse arrives.
    * miss cache — entries survive ~2*arr_lines *misses* (both streams miss
      nearly every access and fills are not removed on promotion), so the
      full-reuse threshold doubles and the always-overrun bound is
      ``arr_lines``.
    * stream buffers — each chase walks sequential tags, so with one buffer
      per stream (``>= 2``) the buffer stays ahead after each pass's first
      miss: 1 MISS + (arr_lines-1) PREFETCH_HITs per pass, plus depth
      initial prefetches and one refill per hit.  A single shared buffer is
      reallocated by the other stream before any head matches (ping-pong):
      every access misses and each miss issues ``depth`` prefetches.

    Geometries between the proven regimes return ``None`` (golden-only).
    """
    arr_lines = int(params["arr_lines"])
    passes = int(params["passes"])
    n = arr_lines * passes
    mech = config.miss_mechanism

    def rows(**kw):
        row = {"HIT": 0, "MSHR_HIT": 0, "MISS": n, "RES_FAIL": 0, "TOTAL": n,
               **_ZERO_MECH_LANES, **kw}
        return {"thrash_a": dict(row), "thrash_b": dict(row)}

    if mech == "victim":
        if config.victim_entries >= arr_lines:
            return rows(MISS=arr_lines, VICTIM_HIT=(passes - 1) * arr_lines)
        if config.victim_entries <= arr_lines // 2:
            return rows()
        return None
    if mech == "miss_cache":
        if config.miss_cache_entries >= 2 * arr_lines:
            return rows(MISS=arr_lines, MISS_CACHE_HIT=(passes - 1) * arr_lines)
        if config.miss_cache_entries <= arr_lines:
            return rows()
        return None
    if mech in ("stream_buffer", "victim+stream"):
        if mech == "victim+stream" and config.victim_entries > arr_lines // 2:
            return None  # victim interferes with the buffer regime
        depth = config.stream_buffer_depth
        if config.stream_buffers >= 2:
            return rows(
                MISS=passes,
                PREFETCH_HIT=passes * (arr_lines - 1),
                PREFETCH_ISSUED=passes * (depth + arr_lines - 1),
            )
        return rows(PREFETCH_ISSUED=n * depth)
    return None


def _producer_consumer_mech_oracle(params, config, expected):
    """producer_consumer under a mechanism: the working set fits (no
    evictions, no re-misses), so the victim and miss caches never hit and
    the base oracle holds for any geometry.  Stream buffers turn the
    producer's sequential whole-line writes into 1 MISS + (stage_lines-1)
    PREFETCH_HITs per stage (one buffer suffices — the consumer never
    misses, so nothing competes for allocation); the consumer still reads
    every line resident."""
    stages = int(params["stages"])
    stage_lines = int(params["stage_lines"])
    n = stages * stage_lines
    mech = config.miss_mechanism
    base = mech_invariant_oracle(params, config, expected)
    if mech in ("victim", "miss_cache"):
        return base
    depth = config.stream_buffer_depth
    out = dict(base or {})
    out["producer"] = {
        "HIT": 0, "MSHR_HIT": 0, "MISS": stages, "RES_FAIL": 0, "TOTAL": n,
        **_ZERO_MECH_LANES,
        "PREFETCH_HIT": stages * (stage_lines - 1),
        "PREFETCH_ISSUED": stages * (depth + stage_lines - 1),
    }
    out["consumer"] = {
        "HIT": n, "MSHR_HIT": 0, "MISS": 0, "RES_FAIL": 0, "TOTAL": n,
        **_ZERO_MECH_LANES,
    }
    return out


# --------------------------------------------------------------------------- distributed
def _topo_for(shape) -> "DeviceTopology":
    """A structural DeviceTopology for oracle hop counting (link bandwidth is
    irrelevant to routing, so any value works; the simulator builds its own
    resource-bearing instance from the config overrides)."""
    from .topology import DeviceTopology

    return DeviceTopology(tuple(shape), link_bytes_per_cycle=1.0)


def _dist_expected(stream: str, demand_lines: int, hop_events: int) -> Dict[str, int]:
    """Per-stream oracle row for a distributed scenario: synthesized kernels
    classify every demand line MISS (ICI_SND included), and routed transfers
    add ``lines × hops`` ICI_HOP link events (excluded from TOTAL — they are
    per-link traffic, not demand accesses)."""
    return {**_miss_only(demand_lines), "ICI_HOPS": hop_events}


@scenario("dist_dp_allreduce", space={"shape": ((2,), (4,), (2, 2), (2, 3)),
                                      "grad_kb": (64, 256)})
def dist_dp_allreduce(shape=(2, 2), grad_kb=128, local_kb=64, flops=1.0e6):
    """Data-parallel step on a device mesh: every device (one stream each)
    computes local gradients, then joins a ring all-reduce — each device
    ships ``2·(N-1)·ceil(bytes/N)`` to its ring successor over the routed
    topology links (docs/DESIGN.md §5.14).

    Oracle: all kernels synthesized → per-stream MISS = local read lines +
    on-wire ICI lines; ICI_HOPS = ICI lines × the device's route hop count
    (ring successors may be multi-hop on a mesh).
    """
    from .topology import all_reduce_ring

    topo = _topo_for(shape)
    launches: List[Launch] = []
    expected: Dict[str, Dict[str, int]] = {}
    ring = all_reduce_ring(topo, grad_kb << 10, name="ar", flops=0.0)
    for d in range(topo.n_devices):
        sname = f"dp_{d}"
        lk, ln = _synth(f"grad_{d}", rd=local_kb << 10, flops=flops,
                        base=(64 + d) << 24, device=d)
        launches.append(Launch(sname, lk))
        ar = ring[d]
        launches.append(Launch(sname, ar))
        ici_lines = _lines(ar.ici_bytes)
        hops = len(topo.hops_for(ar))
        expected[sname] = _dist_expected(sname, ln + ici_lines, ici_lines * hops)
    return launches, expected, {"topology_shape": tuple(shape)}


@scenario("dist_pp_pipeline", space={"shape": ((2,), (4,)),
                                     "microbatches": (2, 4)})
def dist_pp_pipeline(shape=(4,), microbatches=4, act_kb=32, work_kb=64):
    """Pipeline parallelism over topology stages: stage *d* (one stream per
    device, devices in flattened order) runs its microbatch compute, sends
    activations to stage ``d+1`` over the routed link, and the downstream
    stage's compute waits on the send's event (``cudaStreamWaitEvent``
    pipeline idiom).

    Oracle: per-stream MISS = microbatches × (compute read lines + send ICI
    lines, last stage sends nothing); ICI_HOPS = send lines × hops × count.
    """
    from .topology import pipeline_send

    topo = _topo_for(shape)
    n = topo.n_devices
    sends = pipeline_send(topo, act_kb << 10, microbatches=microbatches, name="act")
    by_stage_m = {(k.device, i % microbatches): k
                  for i, k in enumerate(sends)}
    launches: List[Launch] = []
    expected: Dict[str, Dict[str, int]] = {}
    for m in range(microbatches):
        for d in range(n):
            sname = f"stage_{d}"
            ck, cn = _synth(f"fwd_{d}_m{m}", rd=work_kb << 10,
                            base=(128 + d * microbatches + m) << 22, device=d)
            wait = (f"act_{d - 1}_m{m}",) if d > 0 else ()
            launches.append(Launch(sname, ck, wait=wait))
            if d < n - 1:
                launches.append(Launch(sname, by_stage_m[(d, m)],
                                       record=(f"act_{d}_m{m}",)))
    send_lines = _lines(act_kb << 10)
    for d in range(n):
        sname = f"stage_{d}"
        cn = _lines(work_kb << 10) * microbatches
        if d < n - 1:
            hops = len(topo.route(d, d + 1)) - 1
            expected[sname] = _dist_expected(
                sname, cn + send_lines * microbatches,
                send_lines * hops * microbatches)
        else:
            expected[sname] = _dist_expected(sname, cn, 0)
    return launches, expected, {"topology_shape": tuple(shape)}


@scenario("dist_ep_alltoall", space={"shape": ((2, 2), (4,), (2, 3)),
                                     "expert_kb": (16, 64)})
def dist_ep_alltoall(shape=(2, 2), expert_kb=32, local_kb=32):
    """Expert-parallel shuffle: every device runs its expert compute, then
    all-to-alls tokens — one routed transfer per (src, dst) pair, so mesh
    shapes exercise multi-hop dimension-ordered routing and per-link
    contention where routes overlap.

    Oracle: per-stream MISS = local lines + (N-1) × per-pair ICI lines;
    ICI_HOPS = per-pair lines × Σ_dst hops(src → dst).
    """
    from .topology import all_to_all

    topo = _topo_for(shape)
    pair = all_to_all(topo, expert_kb << 10, name="shuffle")
    launches: List[Launch] = []
    expected: Dict[str, Dict[str, int]] = {}
    pair_lines = _lines(expert_kb << 10)
    for d in range(topo.n_devices):
        sname = f"ep_{d}"
        lk, ln = _synth(f"expert_{d}", rd=local_kb << 10, base=(192 + d) << 24,
                        device=d)
        launches.append(Launch(sname, lk))
        hop_sum = 0
        for kd in pair:
            if kd.device == d:
                launches.append(Launch(sname, kd))
                hop_sum += len(topo.hops_for(kd))
        expected[sname] = _dist_expected(
            sname, ln + (topo.n_devices - 1) * pair_lines, pair_lines * hop_sum)
    return launches, expected, {"topology_shape": tuple(shape)}


@scenario("dist_straggler", space={"shape": ((2, 2), (4,)),
                                   "slow_factor": (2.0, 4.0)})
def dist_straggler(shape=(2, 2), grad_kb=128, local_kb=64, slow_device=0,
                   slow_factor=4.0):
    """The DP all-reduce with one straggler device: its stream issues at
    ``1/slow_factor`` rate, so every peer's ring transfer finishes while the
    straggler's lags — visible per-device in the timeline and link ledgers.

    Oracle: a slowdown reschedules, never reclassifies — the per-stream
    counts are exactly :func:`dist_dp_allreduce`'s.
    """
    launches, expected, cfg = dist_dp_allreduce(
        shape=shape, grad_kb=grad_kb, local_kb=local_kb)
    # Stream ids bind in first-appearance order (default stream is 0), and
    # the builder launches device-major, so dp_{d} is stream d+1.
    cfg["stream_slowdown"] = {int(slow_device) + 1: float(slow_factor)}
    return launches, expected, cfg


# Synthesized-beat scenarios never exercise the line cache: every mechanism
# is provably inert (fast-forward windows stay exact — docs/DESIGN.md §5.10).
# The fault scenarios are synthesized too, so their oracles — fault lanes
# included — hold verbatim under every mechanism, and the distributed family
# (synthesized compute + routed ICI, which bypasses VMEM entirely) joins the
# same class.
for _name in ("priority_preemption", "copy_compute_overlap", "fork_join",
              "poisson_burst", "mps_like", "straggler",
              "fault_kernel_abort", "fault_straggler",
              "dist_dp_allreduce", "dist_pp_pipeline", "dist_ep_alltoall",
              "dist_straggler"):
    register_mech_oracle(_name, mech_invariant_oracle)
register_mech_oracle("cache_thrash", _cache_thrash_mech_oracle)
register_mech_oracle("producer_consumer", _producer_consumer_mech_oracle)

# The paper's §5 validation workloads register themselves on import (their
# builders live with the descriptor helpers they share with the legacy
# function API).  Harmless when this module is imported *from* microbench:
# the decorator above is already defined by this point.
from . import microbench  # noqa: E402,F401  (registers l2_lat / mixed_stream / deepbench)
