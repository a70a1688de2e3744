"""Process-parallel batch runner over the scenario library.

Independent simulation configurations are embarrassingly parallel — no state
is shared between two scenario runs — so a sweep fans out across cores the
way "Parallelizing a modern GPU simulator" exploits independent configs.
The unit of work is a :class:`BatchJob` (scenario name + params + engine):
small, picklable, and rebuilt *inside* the worker, so neither kernel
descriptors nor simulator state ever cross a process boundary.  Workers
return plain-structure payloads — the run's :meth:`SimResult.signature`
(uid-normalized, so pooled and serial runs of one job compare equal), the
stream-name map, and an inline oracle check.

Merging is deterministic and order-independent:

* every job's stream ids are **namespaced** by job index
  (:func:`repro.core.collector.namespace_stream` — job index plays the host
  id), so two jobs' ``stream 1`` rows never collide;
* each per-stream matrix lands in one merged
  :class:`~repro.core.engine.StatsEngine` through ``record_batch`` (the
  columnar buffers; one vectorized scatter per flush), with the per-window
  and clean lanes disabled — the merge is a pure ``+=`` over uint64 cells,
  commutative by construction;
* payloads are reduced in job order, so the pooled path (``pool.map``
  preserves order) and the serial fallback are **bit-identical** —
  ``tests/test_batch.py`` asserts equality of full
  :meth:`BatchResult.signature` payloads.

    jobs = sweep_jobs(engines=("event",))          # whole registry
    result = BatchRunner(jobs, workers=8).run()    # or .run(parallel=False)
    result.merged.aggregate()                      # one engine, all runs
    result.emit([TextSink(sys.stdout)])            # merged multi-run report

``backend="vector"`` swaps the one-simulation-per-job strategy for
shape-grouped trace-compile/replay (:mod:`repro.sim.compiled`): jobs sharing
a scenario *shape* (same scenario, params, engine tag and structural config
— see :meth:`BatchJob.group_key`) simulate **once** and replay per draw in
lockstep, while distinct shapes still fan out over the pool.  Both backends
produce bit-identical :meth:`BatchResult.signature` payloads — asserted by
``tests/test_sim_compiled.py`` and gated by ``benchmarks/sim_compiled.py``.
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import pickle
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.collector import namespace_stream, split_namespaced
from ..core.engine import StatsEngine
from ..core.faults import FaultPlan
from ..core.sinks import ReportSink, merged_report
from ..core.stats import AccessOutcome, AccessType
from .executor import SimConfig, VALUE_ONLY_CONFIG
from .scenarios import ScenarioInstance, build, get_spec, list_scenarios

__all__ = [
    "BatchJob", "BatchResult", "BatchRunner", "sweep_jobs", "run_job",
    "run_vector_group", "same_shape_jobs", "merge_payloads",
]

#: ceiling on how long the parent waits for any one pooled result before it
#: declares the worker hung and falls back to in-process retries — the
#: pool path must never block forever on a dead worker, plan or no plan
_DEFAULT_JOB_TIMEOUT_S = 300.0


def _hashable(v: object) -> object:
    return tuple(sorted(v.items())) if isinstance(v, dict) else v


@dataclass(frozen=True)
class BatchJob:
    """One unit of batch work: a scenario instantiation on one engine.

    ``config`` optionally overrides :class:`~repro.sim.executor.SimConfig`
    fields for this job (e.g. a Monte-Carlo ``max_cycles`` draw, or a
    structural knob like ``hbm_latency``).  Dict-valued overrides
    (``stream_slowdown``) are canonicalized to sorted item tuples so jobs
    stay hashable."""

    scenario: str
    params: Tuple[Tuple[str, object], ...] = ()
    engine: str = "event"
    config: Tuple[Tuple[str, object], ...] = ()

    @classmethod
    def make(cls, scenario: str, params: Optional[Mapping[str, object]] = None,
             engine: str = "event",
             config: Optional[Mapping[str, object]] = None) -> "BatchJob":
        return cls(
            scenario,
            tuple(sorted((params or {}).items())),
            engine,
            tuple(sorted((k, _hashable(v)) for k, v in (config or {}).items())),
        )

    def kwargs(self) -> Dict[str, object]:
        return dict(self.params)

    def sim_config(self) -> SimConfig:
        """A fresh :class:`SimConfig` with this job's overrides applied."""
        cfg = SimConfig()
        for k, v in self.config:
            if not hasattr(cfg, k):
                raise AttributeError(f"job overrides unknown SimConfig.{k}")
            setattr(cfg, k, dict(v) if k == "stream_slowdown" else v)
        return cfg

    def group_key(self) -> Tuple:
        """The job's scenario *shape*: everything that can change what its
        simulation does — scenario, params, engine tag, and the structural
        ``SimConfig`` overrides.  Jobs differing only in
        :data:`~repro.sim.executor.VALUE_ONLY_CONFIG` fields share a group,
        and the vector backend simulates each group exactly once."""
        return (
            self.scenario,
            self.params,
            self.engine,
            tuple((k, v) for k, v in self.config if k not in VALUE_ONLY_CONFIG),
        )


def _oracle_check(job: BatchJob, inst: ScenarioInstance, res) -> Optional[Dict[str, object]]:
    """Inline conformance — a declarative StatsFrame query per expected
    stream (see :meth:`repro.sim.scenarios.ScenarioInstance.check_oracle`).
    The job's config rides along so mechanism-aware oracles
    (``miss_mechanism != "none"``) check the adjusted expectation."""
    return inst.check_oracle(res, config=job.sim_config())


def _payload(job: BatchJob, inst: ScenarioInstance, res) -> Dict[str, object]:
    """Flatten one run into the plain-structure worker payload."""
    return {
        "scenario": job.scenario,
        "params": job.kwargs(),
        "engine": job.engine,
        "config": {k: dict(v) if k == "stream_slowdown" else v for k, v in job.config},
        "cycles": res.cycles,
        "stream_ids": dict(inst.stream_ids),
        "oracle": _oracle_check(job, inst, res),
        "signature": res.signature(),
    }


def run_job(job: BatchJob) -> Dict[str, object]:
    """Worker body (also the serial fallback): build, run, flatten.

    Returns only plain structures — everything downstream (merge, JSON
    sweeps, signatures) consumes this payload, never live simulator state.
    """
    inst = build(job.scenario, **job.kwargs())
    res = inst.run(engine=job.engine, config=job.sim_config())
    return _payload(job, inst, res)


def _failure_payload(job: BatchJob, error: BaseException, attempts: int) -> Dict[str, object]:
    """Terminal worker-failure payload: same top-level shape as a success so
    job-ordered reductions stay positional, but ``failed=True`` and no
    signature — graceful degradation, not a poisoned sweep."""
    return {
        "scenario": job.scenario,
        "params": job.kwargs(),
        "engine": job.engine,
        "config": {k: dict(v) if k == "stream_slowdown" else v for k, v in job.config},
        "cycles": 0,
        "stream_ids": {},
        "oracle": None,
        "signature": None,
        "failed": True,
        "error": f"{type(error).__name__}: {error}",
        "attempts": attempts,
    }


def _inject_pool_fault(plan: Optional[FaultPlan], idx: int, attempt: int,
                       pooled: bool) -> None:
    """Apply the plan's deterministic worker fault for (job, attempt).

    ``crash`` raises in place.  ``hang`` sleeps past the parent's result
    timeout when pooled (the parent's ``imap`` timeout detects it); the
    serial path cannot be watchdogged from within, so a hang degrades to an
    immediate raise there — either way the attempt fails, keeping the
    attempt sequence (and so every downstream count) pooled==serial."""
    if plan is None:
        return
    kind = plan.pool_fault(idx, attempt)
    if kind == "crash":
        raise RuntimeError(f"injected worker crash (job={idx}, attempt={attempt})")
    if kind == "hang":
        if pooled:
            time.sleep(plan.job_timeout_s * 10)
        raise RuntimeError(f"injected worker hang (job={idx}, attempt={attempt})")


def _pool_worker(args: Tuple[int, BatchJob, Optional[FaultPlan]]) -> Dict[str, object]:
    """Pooled attempt 0 of one job; retries happen in the parent."""
    idx, job, plan = args
    _inject_pool_fault(plan, idx, 0, pooled=True)
    payload = run_job(job)
    payload["attempts"] = 1
    return payload


def run_vector_group(jobs: Sequence[BatchJob]) -> List[Dict[str, object]]:
    """Worker body for one same-shape group under ``backend="vector"``.

    The scenario builds **once**, its shape compiles **once** (via the
    event loop + :mod:`repro.sim.compiled` recorder — or not at all on a
    warm :data:`~repro.sim.compiled.TRACE_CACHE`), and every job in the
    group replays the trace in lockstep (:func:`repro.sim.compiled
    .replay_batch`).  Payloads are per-job and independently materialized —
    bit-identical to what :func:`run_job` would have produced, which the
    pooled==serial cross-checks assert."""
    from .compiled import get_or_compile, replay_batch

    rep = jobs[0]
    inst = build(rep.scenario, **rep.kwargs())
    sim = inst.make_sim(engine="event", config=rep.sim_config())
    trace, _ = get_or_compile(sim)
    cfgs = [j.sim_config() for j in jobs]
    results = replay_batch(trace, cfgs)
    return [_payload(j, inst, r) for j, r in zip(jobs, results)]


def merge_payloads(payloads: Sequence[Mapping[str, object]]) -> StatsEngine:
    """Reduce job payloads into one :class:`StatsEngine`.

    Stream ids are namespaced by job index so per-job rows stay
    distinguishable (recover with
    :func:`repro.core.collector.split_namespaced`); cells land through
    ``record_batch`` with the per-window/clean lanes off, making the merge a
    commutative uint64 sum — independent of job completion order by
    construction, and reduced in job order for byte determinism.

    Worker faults land on each job's FAULT row at stream 0 of its namespace
    (scenario streams start at 1, so the row is otherwise unused): one RETRY
    per re-execution, then RECOVERED when the job eventually produced a
    payload or SHED when the batch dropped it — per job,
    ``RETRY == attempts - 1`` and ``RECOVERED + SHED == (faults hit ? 1 :
    0)``, the pool-layer conservation oracle (docs/DESIGN.md §5.11)."""
    merged = StatsEngine(name="Batch_merged_stats")

    def lane(gid: int, outcome: AccessOutcome, n: int) -> None:
        merged.record_batch(
            np.full(1, int(AccessType.FAULT), np.int64),
            np.full(1, int(outcome), np.int64),
            np.full(1, gid, np.int64),
            counts=np.full(1, n, np.uint64),
            pw=False, clean=False,
        )

    for idx, payload in enumerate(payloads):
        attempts = int(payload.get("attempts", 1))
        gid0 = namespace_stream(idx, 0)
        if attempts > 1:
            lane(gid0, AccessOutcome.RETRY, attempts - 1)
            lane(gid0, AccessOutcome.SHED if payload.get("failed")
                 else AccessOutcome.RECOVERED, 1)
        elif payload.get("failed"):
            lane(gid0, AccessOutcome.SHED, 1)
        if payload.get("failed"):
            continue
        streams = payload["signature"]["stats"]["streams"]
        for sid, views in sorted(streams.items(), key=lambda kv: int(kv[0])):
            gid = namespace_stream(idx, int(sid))
            for key, fail in (("cum", False), ("fail", True)):
                m = np.asarray(views[key], dtype=np.uint64)
                t, o = np.nonzero(m)
                if t.size == 0:
                    # keep the stream row visible even when it counted nothing
                    merged.record_batch(
                        np.zeros(1, np.int64), np.zeros(1, np.int64),
                        np.full(1, gid, np.int64), counts=np.zeros(1, np.uint64),
                        fail=fail, pw=False, clean=False,
                    )
                    continue
                merged.record_batch(
                    t.astype(np.int64), o.astype(np.int64),
                    np.full(t.size, gid, dtype=np.int64),
                    counts=m[t, o],
                    fail=fail, pw=False, clean=False,
                )
    merged.flush()
    return merged


@dataclass
class BatchResult:
    """Outcome of one batch run: ordered payloads + the deterministic merge."""

    jobs: List[BatchJob]
    payloads: List[Dict[str, object]]
    merged: StatsEngine
    workers: int
    parallel: bool
    wall_s: float

    def signature(self) -> dict:
        """Everything comparable about the batch: each job's identity and
        uid-normalized run signature (in job order) plus the merged engine's
        full signature.  The pooled and serial paths must produce equal
        values — the bit-identity contract ``tests/test_batch.py`` enforces
        (wall-clock and worker count are deliberately excluded)."""
        return {
            "jobs": [
                {
                    "scenario": p["scenario"],
                    "params": sorted(p["params"].items()),
                    "engine": p["engine"],
                    "cycles": p["cycles"],
                    "oracle": p["oracle"],
                    "signature": p["signature"],
                }
                for p in self.payloads
            ],
            "merged": self.merged.signature(),
        }

    def oracle_failures(self) -> List[Dict[str, object]]:
        out = []
        for p in self.payloads:
            if p["oracle"] is not None and not p["oracle"]["ok"]:
                out.append({"scenario": p["scenario"], "params": p["params"],
                            "engine": p["engine"],
                            "mismatches": p["oracle"]["mismatches"]})
        return out

    def failures(self) -> List[Dict[str, object]]:
        """Jobs that exhausted their retry budget (``failed=True`` payloads),
        in job order — a degraded sweep reports what it dropped."""
        return [
            {"job_index": i, "scenario": p["scenario"], "params": p["params"],
             "engine": p["engine"], "error": p.get("error"),
             "attempts": p.get("attempts", 1)}
            for i, p in enumerate(self.payloads) if p.get("failed")
        ]

    def stream_rows(self) -> Dict[Tuple[int, int], np.ndarray]:
        """(job index, original stream id) -> merged cumulative matrix."""
        out = {}
        for gid in self.merged.streams():
            out[split_namespaced(gid)] = self.merged.stream_matrix(gid)
        return out

    def frame(self) -> "StatsFrame":
        """The merged per-stream store as a query frame.  Streams are the
        namespaced (job, stream) rows, named ``"job<j>/<scenario>/<stream>"``
        with per-job stream names resolved from each payload — so
        ``result.frame().filter(stream="job0/l2_lat/stream_1").sum()`` and
        ``groupby("stream")`` work across the whole sweep."""
        from ..core.query import StatsFrame

        names: Dict[str, int] = {}
        for idx, p in enumerate(self.payloads):
            if p.get("failed"):
                names[f"job{idx}/{p['scenario']}/failed"] = namespace_stream(idx, 0)
                continue
            by_id = {sid: n for n, sid in p["stream_ids"].items()}
            for sid_str in p["signature"]["stats"]["streams"]:
                sid = int(sid_str)
                local = by_id.get(sid, sid)
                label = local if local != "" else "default"
                names[f"job{idx}/{p['scenario']}/{label}"] = namespace_stream(idx, sid)
        return StatsFrame(self.merged, names=names)

    def job_frame(self, idx: int) -> "StatsFrame":
        """One job's per-stream counts as a query frame, rebuilt from its
        payload signature (plain structures — works on payloads that crossed
        a process boundary)."""
        from ..core.query import StatsFrame
        from ..core.stats import StatTable

        p = self.payloads[idx]
        if p.get("failed"):
            raise ValueError(
                f"job {idx} ({p['scenario']}) failed after "
                f"{p.get('attempts', 1)} attempt(s): {p.get('error')}"
            )
        table = StatTable(name=f"job{idx}_{p['scenario']}")
        for sid_str, views in p["signature"]["stats"]["streams"].items():
            sid = int(sid_str)
            table._stats[sid] = np.asarray(views["cum"], dtype=np.uint64)
            table._stats_pw[sid] = np.asarray(views["pw"], dtype=np.uint64)
            table._fail_stats[sid] = np.asarray(views["fail"], dtype=np.uint64)
        return StatsFrame(table, names=dict(p["stream_ids"]))

    def report(self):
        """Merged multi-run report (``stream_id=ALL_STREAMS``)."""
        return merged_report(
            self.merged,
            source="batch",
            event="batch_merged",
            fields={
                "n_jobs": len(self.payloads),
                "scenarios": sorted({p["scenario"] for p in self.payloads}),
                "engines": sorted({p["engine"] for p in self.payloads}),
                "total_cycles": int(sum(p["cycles"] for p in self.payloads)),
                "workers": self.workers,
                "parallel": self.parallel,
                "failed_jobs": sum(1 for p in self.payloads if p.get("failed")),
            },
        )

    def emit(self, sinks: Sequence[ReportSink]) -> None:
        rep = self.report()
        for sink in sinks:
            sink.emit(rep)


def _pool_context():
    # fork shares the already-imported interpreter (cheap, deterministic);
    # spawn is the fallback — workers re-import repro_torch by module name,
    # so the parent's PYTHONPATH must reach src/ (true for every documented
    # entry point).  A child forked after CUDA is initialised cannot use the
    # card (the CUDA runtime does not survive fork), so spawn wins as soon as
    # the parent has touched the card; sweeps that never did keep the cheap
    # fork path.
    import torch

    methods = mp.get_all_start_methods()
    if "fork" in methods and not torch.cuda.is_initialized():
        return mp.get_context("fork")
    return mp.get_context("spawn")


class BatchRunner:
    """Shards :class:`BatchJob` lists across a process pool and merges.

    Two backends:

    * ``backend="pool"`` (default) — one simulation per job.  The pooled
      path orders jobs shape-grouped (same-shape jobs land in the same pool
      chunk) and maps with an explicit ``chunksize`` so small-job sweeps
      stop paying one IPC round-trip per job; payloads are restored to job
      order before merging, so the pooled and serial paths stay
      bit-identical.
    * ``backend="vector"`` — shape-grouped trace-compile/replay: each
      distinct shape simulates once (the compiled engine's phase 1) and all
      its jobs replay in lockstep (phase 2).  Cross-shape groups still fan
      out over the pool when ``parallel=True`` — the shape-grouped-sharding
      composition.
    * ``backend="batched"`` — SoA batched *divergent* simulation: one
      process advances every job's run with per-kernel reports deferred,
      then lands all staged stat journals at once through the array-ops
      segment-scatter kernel and reconstructs the reports in masked
      lockstep (``repro.sim.batched``).  The backend for sweeps whose
      draws share no shape, where vector replay cannot amortize anything.

    ``run(parallel=False)`` is the serial fallback: same worker bodies, same
    job order, same merge — proven bit-identical to the pooled path (and
    across backends) via :meth:`BatchResult.signature` equality.

    Robustness (docs/DESIGN.md §5.11): the pooled path consumes results via
    ``imap`` with a per-result timeout, so a hung or crashed worker can
    never hang the sweep — the pool is torn down and every unfinished job is
    re-executed in-process with a bounded retry/backoff budget
    (``fault_plan.pool_max_retries`` / ``pool_backoff_s``); jobs that
    exhaust it degrade to ``failed=True`` payloads instead of poisoning the
    run.  ``journal=<path>`` makes the sweep resumable: each payload is
    appended (pickle) as it lands, and a rerun over the same job list skips
    journaled work — a killed sweep resumes bit-identical.  A seeded
    ``fault_plan`` with ``crash_jobs``/``hang_jobs`` injects deterministic
    worker faults for testing; the schedule is a pure function of
    (job index, attempt), so pooled and serial runs fail — and recover —
    identically."""

    def __init__(self, jobs: Iterable[BatchJob], workers: Optional[int] = None,
                 backend: str = "pool", fault_plan: Optional[FaultPlan] = None,
                 journal: Optional[str] = None) -> None:
        self.jobs = list(jobs)
        if not self.jobs:
            raise ValueError("BatchRunner needs at least one job")
        if backend not in ("pool", "vector", "batched"):
            raise ValueError(
                f"unknown backend {backend!r} (want 'pool', 'vector' or 'batched')"
            )
        if backend in ("vector", "batched"):
            # An *empty* plan is bit-identical to no plan (the fault-off
            # identity), so it is accepted here; only an armed plan — or a
            # journal, whose resume semantics are pool bookkeeping — needs
            # the pool's retry/recovery machinery.
            armed = fault_plan is not None and not fault_plan.is_empty()
            if armed:
                # Name the first job the plan's pool schedule would actually
                # fault (falling back to job 0 for kernel-layer-only plans)
                # so the error points at concrete work, not just the flag.
                hit = next(
                    (i for i in range(len(self.jobs))
                     if fault_plan.pool_fault(i, 0) is not None), 0)
                raise ValueError(
                    f"an armed fault_plan requires backend='pool': job {hit} "
                    f"({self.jobs[hit].scenario!r}) would run under "
                    f"backend={backend!r}, which has no worker retry/recovery "
                    f"path"
                )
            if journal is not None:
                raise ValueError(
                    f"journal={str(journal)!r} requires backend='pool': "
                    f"resume bookkeeping is per-worker-payload, and job 0 "
                    f"({self.jobs[0].scenario!r}) under backend={backend!r} "
                    f"produces no journalable worker payloads"
                )
        self.backend = backend
        self.fault_plan = fault_plan
        self.journal = Path(journal) if journal is not None else None
        cpus = mp.cpu_count()
        self.workers = max(1, min(workers if workers is not None else cpus,
                                  len(self.jobs), cpus))

    # ------------------------------------------------------------- journal
    def _jobs_fingerprint(self) -> str:
        # repr of frozen dataclasses over plain values — stable across
        # processes (unlike salted str hashes)
        return hashlib.sha256(repr(self.jobs).encode()).hexdigest()

    def _load_journal(self) -> Dict[int, Dict[str, object]]:
        """Completed payloads from a prior (possibly killed) run.  A journal
        for a different job list is ignored wholesale; a truncated tail
        record (the kill landed mid-append) is dropped silently."""
        if self.journal is None or not self.journal.exists():
            return {}
        done: Dict[int, Dict[str, object]] = {}
        with open(self.journal, "rb") as fh:
            try:
                header = pickle.load(fh)
            except (EOFError, pickle.UnpicklingError):
                return {}
            if not isinstance(header, dict) or \
                    header.get("fingerprint") != self._jobs_fingerprint():
                return {}
            while True:
                try:
                    rec = pickle.load(fh)
                except (EOFError, pickle.UnpicklingError):
                    break
                idx = rec.get("idx")
                if isinstance(idx, int) and 0 <= idx < len(self.jobs):
                    done[idx] = rec["payload"]
        return done

    def _open_journal(self, resumed: bool):
        if self.journal is None:
            return None
        if resumed:
            return open(self.journal, "ab")
        fh = open(self.journal, "wb")
        pickle.dump({"fingerprint": self._jobs_fingerprint()}, fh)
        fh.flush()
        return fh

    @staticmethod
    def _journal_append(fh, idx: int, payload: Dict[str, object]) -> None:
        if fh is None:
            return
        pickle.dump({"idx": idx, "payload": payload}, fh)
        fh.flush()

    # ------------------------------------------------------------- retries
    def _run_one(self, idx: int, job: BatchJob,
                 first_attempt: int) -> Dict[str, object]:
        """In-process execution of one job with the plan's retry budget.
        ``first_attempt`` > 0 means a pooled attempt already burned part of
        the budget — the attempt sequence stays a pure function of the job
        index, so pooled-then-serial and all-serial runs count identically."""
        plan = self.fault_plan
        max_retries = plan.pool_max_retries if plan is not None else 0
        if first_attempt > max_retries:
            return _failure_payload(
                job, RuntimeError("pooled attempt failed; no retry budget"),
                first_attempt,
            )
        attempt = first_attempt
        while True:
            try:
                _inject_pool_fault(plan, idx, attempt, pooled=False)
                payload = run_job(job)
                payload["attempts"] = attempt + 1
                return payload
            except Exception as err:
                if attempt >= max_retries:
                    return _failure_payload(job, err, attempt + 1)
                if plan is not None and plan.pool_backoff_s > 0:
                    time.sleep(plan.pool_backoff_s * (2 ** attempt))
                attempt += 1

    def _shape_groups(self) -> List[List[int]]:
        """Job indices grouped by shape, groups in first-occurrence order."""
        groups: Dict[Tuple, List[int]] = {}
        for i, job in enumerate(self.jobs):
            groups.setdefault(job.group_key(), []).append(i)
        return list(groups.values())

    def _run_pool(self, use_pool: bool) -> List[Dict[str, object]]:
        jobs = self.jobs
        plan = self.fault_plan
        done = self._load_journal()
        payloads: List[Optional[Dict[str, object]]] = [
            done.get(i) for i in range(len(jobs))
        ]
        pending = [i for i in range(len(jobs)) if payloads[i] is None]
        jfh = self._open_journal(resumed=bool(done))
        try:
            if not use_pool:
                for i in pending:
                    payloads[i] = self._run_one(i, jobs[i], first_attempt=0)
                    self._journal_append(jfh, i, payloads[i])
                return payloads  # type: ignore[return-value]
            # Shape-grouped order: one chunk tends to hold one shape's jobs,
            # so a worker's trace/descriptor caches stay warm within a chunk.
            # One job per chunk under an injecting plan: a crash/hang must
            # take down only its own job, never innocent chunk-mates.
            pending_set = set(pending)
            order = [i for grp in self._shape_groups() for i in grp
                     if i in pending_set]
            injecting = plan is not None and bool(plan.crash_jobs or plan.hang_jobs)
            chunksize = 1 if injecting else max(
                1, (len(order) + 4 * self.workers - 1) // (4 * self.workers))
            timeout = plan.job_timeout_s if plan is not None else _DEFAULT_JOB_TIMEOUT_S
            finished = 0
            if order:
                with _pool_context().Pool(self.workers) as pool:
                    it = pool.imap(
                        _pool_worker, [(i, jobs[i], plan) for i in order],
                        chunksize=chunksize,
                    )
                    try:
                        for k, i in enumerate(order):
                            # per-result timeout: a dead/hung worker surfaces
                            # here instead of blocking the sweep forever
                            payloads[i] = it.next(timeout=timeout)
                            self._journal_append(jfh, i, payloads[i])
                            finished = k + 1
                    except Exception:  # worker crash or mp.TimeoutError (hang)
                        pool.terminate()
            if finished < len(order):
                # pool path degraded: the job at the failure point already
                # burned attempt 0 in a worker; it and everything after it
                # re-run in-process under the bounded retry budget
                for k in range(finished, len(order)):
                    i = order[k]
                    payloads[i] = self._run_one(
                        i, jobs[i], first_attempt=1 if k == finished else 0)
                    self._journal_append(jfh, i, payloads[i])
            return payloads  # type: ignore[return-value]
        finally:
            if jfh is not None:
                jfh.close()

    def _run_vector(self, use_pool: bool) -> List[Dict[str, object]]:
        groups = self._shape_groups()
        group_jobs = [[self.jobs[i] for i in grp] for grp in groups]
        if use_pool and len(groups) > 1:
            with _pool_context().Pool(min(self.workers, len(groups))) as pool:
                per_group = pool.map(run_vector_group, group_jobs, chunksize=1)
        else:
            per_group = [run_vector_group(g) for g in group_jobs]
        payloads: List[Optional[Dict[str, object]]] = [None] * len(self.jobs)
        for grp, outs in zip(groups, per_group):
            for i, p in zip(grp, outs):
                payloads[i] = p
        return payloads  # type: ignore[return-value]

    def _run_batched(self) -> List[Dict[str, object]]:
        """One process, N divergent runs, SoA landing (repro.sim.batched)."""
        from .batched import run_batched_jobs

        return run_batched_jobs(self.jobs)

    def run(self, parallel: bool = True) -> BatchResult:
        t0 = time.perf_counter()
        use_pool = (parallel and self.workers > 1 and len(self.jobs) > 1
                    and self.backend != "batched")
        if self.backend == "vector":
            payloads = self._run_vector(use_pool)
        elif self.backend == "batched":
            payloads = self._run_batched()
        else:
            payloads = self._run_pool(use_pool)
        merged = merge_payloads(payloads)
        return BatchResult(
            jobs=list(self.jobs),
            payloads=payloads,
            merged=merged,
            workers=self.workers if use_pool else 1,
            parallel=use_pool,
            wall_s=time.perf_counter() - t0,
        )


def sweep_jobs(
    scenarios: Optional[Sequence[str]] = None,
    engines: Sequence[str] = ("event",),
    params: Optional[Mapping[str, Mapping[str, object]]] = None,
) -> List[BatchJob]:
    """Default-parameter jobs for a scenario x engine sweep.

    ``params`` optionally overrides per scenario name.  Unknown scenario
    names fail fast (``get_spec`` raises)."""
    names = list(scenarios) if scenarios is not None else list(list_scenarios())
    for n in names:
        get_spec(n)
    return [
        BatchJob.make(n, (params or {}).get(n), engine=e)
        for n in names
        for e in engines
    ]


def same_shape_jobs(
    scenario: str,
    n_draws: int,
    params: Optional[Mapping[str, object]] = None,
    engine: str = "event",
    seed: int = 0,
) -> List[BatchJob]:
    """``n_draws`` jobs of one scenario shape, differing only in value-only
    ``SimConfig`` draws (jittered ``max_cycles`` — see
    :func:`repro.sim.scenarios.value_only_draws`).  Under ``backend="pool"``
    every draw re-simulates; under ``backend="vector"`` the shape compiles
    once and every draw replays — the sweep the compiled-engine benchmark
    measures."""
    from .scenarios import value_only_draws

    get_spec(scenario)
    return [
        BatchJob.make(scenario, params, engine=engine, config=cfg)
        for cfg in value_only_draws(n_draws, seed=seed)
    ]
