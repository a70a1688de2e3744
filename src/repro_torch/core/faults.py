"""Deterministic fault injection — the :class:`FaultPlan` vocabulary.

A fault plan is a *declarative, seeded, fully deterministic* description of
what goes wrong during a run.  Three layers consume it (docs/DESIGN.md
§5.11):

* **kernel layer** (:mod:`repro.sim.executor`) — :class:`KernelFaultSpec`
  entries: abort-at-cycle, transient slowdown windows, HBM stall bursts.
  ``SimConfig.fault_plan`` carries the plan; it joins ``structural_key()``
  (a plan change is a different simulation — the compiled trace cache
  recompiles) and every injection point is scheduled at an *absolute cycle*
  both engine loops provably visit, so cycle ↔ event ↔ compiled signature
  identity holds under any plan.
* **request layer** (:mod:`repro.serve.engine`) — admission-queue overflow
  with priority-based load shedding, per-request deadlines, client
  cancellation, bounded retry with exponential backoff + seeded jitter.
* **pool layer** (:mod:`repro.sim.batch`) — simulated worker crash/hang for
  chosen job indices, per-job timeout, bounded retry, and the resumable
  payload journal.

Every fault and every recovery action lands in a per-stream stat lane on the
:data:`~repro.core.stats.AccessType.FAULT` row — ``KERNEL_ABORT`` /
``RETRY`` / ``TIMEOUT_EXPIRED`` / ``SHED`` / ``RECOVERED`` — flowing through
:class:`~repro.core.engine.StatsEngine` / :class:`~repro.core.query
.StatsFrame` like any other outcome, so failure attribution is a frame
query.

**Conservation oracle** — the subsystem's correctness contract: every
injected fault is accounted *exactly once*.  At the kernel layer each
:class:`KernelFaultSpec` resolves as either ``KERNEL_ABORT`` (it killed
work) or ``RECOVERED`` (its window closed, the kernel finished first, the
stall drained, or the target never materialized), so for every stream ``s``::

    KERNEL_ABORT(s) + RECOVERED(s) == #specs attributed to s

:func:`check_sim_conservation` asserts this from a result alone.  The serve
and pool layers keep the analogous ledgers (``Engine.fault_summary()``,
``BatchResult`` payload ``attempts`` fields) checked by their own tests.

Determinism: no wall clocks, no global RNG.  Jitter draws come from
:meth:`FaultPlan.jitter` — a pure function of ``(plan.seed, *key)`` using an
integer mix (never Python's salted string hash), so the same seed produces
the same schedule in every process, pooled or serial.
"""

from __future__ import annotations

from dataclasses import dataclass
from random import Random
from typing import Dict, Optional, Tuple

__all__ = [
    "FAULT_KINDS",
    "FAULT_LANES",
    "FaultPlan",
    "KernelFaultSpec",
    "check_sim_conservation",
]

#: Kernel-layer fault kinds.
FAULT_KINDS = ("abort", "slowdown", "hbm_stall")

#: The five fault stat lanes (AccessOutcome display names, in lane order).
FAULT_LANES = ("KERNEL_ABORT", "RETRY", "TIMEOUT_EXPIRED", "SHED", "RECOVERED")


def _mix(*parts: int) -> int:
    """Deterministic integer fold (FNV-style) — stable across processes and
    interpreter runs, unlike ``hash(str)``."""
    h = 0xCBF29CE484222325
    for p in parts:
        h ^= int(p) & 0xFFFFFFFFFFFFFFFF
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass(frozen=True)
class KernelFaultSpec:
    """One kernel-layer fault.

    ``kind``:

    * ``"abort"``    — kill the ``kernel``-th kernel launched on ``stream``
      once it has run ``after`` cycles: remaining trace/synthesized work is
      discarded and the kernel retires at the fault cycle (lane
      ``KERNEL_ABORT``).  If it finishes in fewer than ``after`` cycles the
      spec resolves ``RECOVERED`` at retire.
    * ``"slowdown"`` — transient straggler: the target kernel's issue rate
      is divided by ``factor`` for ``duration`` cycles starting ``after``
      cycles past its launch; lane ``RECOVERED`` when the window closes
      (or at retire, whichever comes first).
    * ``"hbm_stall"`` — at *absolute* cycle ``after`` the HBM token bucket
      is pushed ``duration`` cycles into the future (a refresh-storm burst);
      ``stream``/``kernel`` only attribute the ``RECOVERED`` lane event.
    """

    kind: str
    stream: int = 0
    kernel: int = 0
    after: int = 0
    duration: int = 0
    factor: float = 2.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.after < 0 or self.duration < 0 or self.kernel < 0:
            raise ValueError("fault after/duration/kernel must be >= 0")
        if self.kind == "slowdown" and not self.factor > 0:
            raise ValueError("slowdown factor must be > 0")


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic fault schedule for all three layers.

    Hashable and equality-comparable (all fields are scalars or tuples), so
    it rides inside ``SimConfig.structural_key()``, ``BatchJob`` config
    tuples, and the compiled-trace shape key unchanged.  The default plan
    (every field at its default) injects nothing; code paths guard on the
    plan being ``None``/empty so fault-plan-off stays bit-identical to a
    build without the subsystem.

    Serve-layer fields (consumed by :class:`repro.serve.engine.Engine`):

    * ``queue_limit`` — admission-queue capacity; ``0`` = unbounded (off).
      On overflow the *lowest-priority* entry (ties: latest submitted) is
      shed (lane ``SHED``) and, while its retry budget lasts, re-enqueued
      after backoff (lane ``RETRY`` per attempt).
    * ``deadline_steps`` — default per-request deadline in engine steps
      (``0`` = none); expiry records ``TIMEOUT_EXPIRED``.
    * ``max_retries`` / ``backoff_base`` / ``backoff_jitter`` — bounded
      retry with exponential backoff: attempt ``a`` waits
      ``backoff_base * 2**a + jitter`` steps, jitter drawn in
      ``[0, backoff_jitter]`` by :meth:`jitter`.

    Pool-layer fields (consumed by :class:`repro.sim.batch.BatchRunner`):

    * ``crash_jobs`` / ``hang_jobs`` — job indices whose first
      ``fail_attempts`` execution attempts raise / stall.
    * ``job_timeout_s`` — per-job wall-clock timeout on the pooled path
      (hangs and dead workers surface as ``WorkerFailure`` payloads instead
      of blocking forever).
    * ``pool_max_retries`` / ``pool_backoff_s`` — bounded re-execution with
      (real-time) backoff; a job that exhausts the budget is dropped from
      the merge (lane ``SHED``), one that recovers records ``RECOVERED``.
    """

    seed: int = 0
    kernel_faults: Tuple[KernelFaultSpec, ...] = ()
    # -- serve layer ---------------------------------------------------------
    queue_limit: int = 0
    deadline_steps: int = 0
    max_retries: int = 1
    backoff_base: int = 1
    backoff_jitter: int = 0
    # -- pool layer ----------------------------------------------------------
    crash_jobs: Tuple[int, ...] = ()
    hang_jobs: Tuple[int, ...] = ()
    fail_attempts: int = 1
    job_timeout_s: float = 30.0
    pool_max_retries: int = 2
    pool_backoff_s: float = 0.0

    def __post_init__(self) -> None:
        # canonicalize sequence fields so plans built from lists stay
        # hashable (structural_key / BatchJob requirements)
        object.__setattr__(self, "kernel_faults", tuple(self.kernel_faults))
        object.__setattr__(self, "crash_jobs", tuple(int(i) for i in self.crash_jobs))
        object.__setattr__(self, "hang_jobs", tuple(int(i) for i in self.hang_jobs))
        if self.queue_limit < 0 or self.deadline_steps < 0:
            raise ValueError("queue_limit/deadline_steps must be >= 0")
        if self.max_retries < 0 or self.backoff_base < 0 or self.backoff_jitter < 0:
            raise ValueError("retry/backoff fields must be >= 0")
        if self.fail_attempts < 0 or self.pool_max_retries < 0:
            raise ValueError("pool retry fields must be >= 0")

    # -- deterministic draws --------------------------------------------------
    def jitter(self, *key: int) -> int:
        """Seeded jitter in ``[0, backoff_jitter]`` — a pure function of
        ``(seed, *key)``; identical in every process."""
        if self.backoff_jitter <= 0:
            return 0
        return Random(_mix(self.seed, *key)).randint(0, self.backoff_jitter)

    def backoff_steps(self, attempt: int, *key: int) -> int:
        """Engine steps to wait before retry ``attempt`` (0-based):
        exponential backoff plus seeded jitter."""
        return self.backoff_base * (2 ** int(attempt)) + self.jitter(attempt, *key)

    # -- pool schedule --------------------------------------------------------
    def pool_fault(self, job_index: int, attempt: int) -> Optional[str]:
        """``"crash"``/``"hang"`` when this (job, attempt) is scheduled to
        fail, else ``None``.  Pure, so pooled and serial execution see the
        same schedule (the hypothesis suite asserts this)."""
        if attempt >= self.fail_attempts:
            return None
        if job_index in self.crash_jobs:
            return "crash"
        if job_index in self.hang_jobs:
            return "hang"
        return None

    # -- introspection --------------------------------------------------------
    def kernel_specs_by_stream(self) -> Dict[int, int]:
        """#kernel-layer specs attributed to each stream (conservation RHS)."""
        out: Dict[int, int] = {}
        for spec in self.kernel_faults:
            out[spec.stream] = out.get(spec.stream, 0) + 1
        return out

    def is_empty(self) -> bool:
        """True when the plan injects nothing at any layer."""
        return not (self.kernel_faults or self.queue_limit or self.deadline_steps
                    or self.crash_jobs or self.hang_jobs)


def check_sim_conservation(result, plan: Optional[FaultPlan]) -> Dict[str, object]:
    """Kernel-layer conservation oracle over a finished simulation.

    Every :class:`KernelFaultSpec` must resolve exactly once —
    ``KERNEL_ABORT`` or ``RECOVERED`` — on the stream it is attributed to,
    and the serve/pool lanes (which the simulator never drives) must be
    zero.  ``result`` is a :class:`~repro.sim.executor.SimResult` (anything
    with a ``frame`` property / per-stream stats works).

    Returns ``{"ok": bool, "mismatches": [...], "per_stream": {...}}``.
    """
    from .query import StatsFrame

    frame = result.frame if hasattr(result, "frame") else StatsFrame(result.stats)
    want = plan.kernel_specs_by_stream() if plan is not None else {}
    mismatches = []
    per_stream: Dict[int, Dict[str, int]] = {}
    sids = set(frame.streams()) | set(want)
    for sid in sorted(sids):
        counts = frame.filter(stream=int(sid)).outcome_counts()
        lanes = {lane: counts[lane] for lane in FAULT_LANES}
        per_stream[int(sid)] = lanes
        injected = want.get(int(sid), 0)
        resolved = lanes["KERNEL_ABORT"] + lanes["RECOVERED"]
        if resolved != injected:
            mismatches.append(
                {"stream": int(sid), "injected": injected,
                 "KERNEL_ABORT": lanes["KERNEL_ABORT"], "RECOVERED": lanes["RECOVERED"]}
            )
        for lane in ("RETRY", "TIMEOUT_EXPIRED", "SHED"):
            if lanes[lane]:
                mismatches.append({"stream": int(sid), "unexpected_lane": lane,
                                   "count": lanes[lane]})
    return {"ok": not mismatches, "mismatches": mismatches, "per_stream": per_stream}
