"""Trace-driven multi-tenant load generator for the serving engine.

Reuses the scenario machinery's arrival model (docs/DESIGN.md §5.12): the
same seeded Knuth Poisson sampler that drives the ``poisson_burst``
simulator scenario draws per-step per-tenant arrival counts, and — like
``mps_like`` — each tenant is a homogeneous request mix (prompt-length and
output-length ranges, priority).  ``generate_load`` turns a :class:`LoadSpec`
into a deterministic trace of ``(arrival_step, Request)`` pairs;
``replay_load`` feeds that trace into an :class:`~repro_torch.serve.Engine`,
interleaving submissions with ``engine.step()`` so admits land *between*
decode steps exactly as live traffic would.

Every SLO number in the resulting report is a :class:`StatsFrame` query over
the engine's stat table — TTFT and latency percentiles from the per-stream
``SLO`` lanes rolled up by ``groupby("tenant")``, goodput from ``TOKENS_OUT``
sums, shed/timeout rates from the ``FAULT`` lanes.  Nothing is measured on
the side: if the per-stream attribution were wrong, the report would be
wrong, which is precisely what makes it a test vehicle for the paper's
thesis.
"""

from __future__ import annotations

import math
import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .engine import Engine, Request

__all__ = [
    "TenantSpec",
    "LoadSpec",
    "LoadReport",
    "generate_load",
    "replay_load",
    "slo_report",
]


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's homogeneous request mix (the ``mps_like`` idiom)."""

    name: str
    #: mean arrivals per engine step (Poisson λ)
    rate: float = 0.5
    #: inclusive prompt-length range
    prompt_len: Tuple[int, int] = (4, 12)
    #: inclusive output-length range
    max_new_tokens: Tuple[int, int] = (2, 8)
    #: admission priority under load shedding (higher = keep longer)
    priority: int = 0


@dataclass(frozen=True)
class LoadSpec:
    """A reproducible multi-tenant arrival trace (the ``poisson_burst``
    idiom): per-step Poisson draws per tenant, with optional periodic bursts
    multiplying every tenant's λ by ``burst_factor``."""

    tenants: Tuple[TenantSpec, ...]
    #: arrival window in engine steps (the engine keeps running past it
    #: until the admitted work drains)
    steps: int = 32
    seed: int = 0
    #: every ``burst_every``-th step is a burst (0 = no bursts)
    burst_every: int = 0
    burst_factor: float = 4.0


def _poisson_draw(rng: random.Random, lam: float) -> int:
    """Knuth's Poisson sampler over the scenario's seeded RNG (the
    reference simulator's ``poisson_burst`` sampler, draw for draw)."""
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


def generate_load(spec: LoadSpec, vocab_size: int) -> List[Tuple[int, Request]]:
    """Deterministic trace for ``spec``: ``(arrival_step, Request)`` pairs in
    arrival order.  All randomness comes from one ``random.Random(spec.seed)``
    consumed step-major in tenant-declaration order, so the same spec always
    yields the same trace (prompts included)."""
    rng = random.Random(spec.seed)
    out: List[Tuple[int, Request]] = []
    counters = {t.name: 0 for t in spec.tenants}
    for step in range(spec.steps):
        burst = spec.burst_every > 0 and step % spec.burst_every == 0
        for t in spec.tenants:
            lam = t.rate * (spec.burst_factor if burst else 1.0)
            for _ in range(_poisson_draw(rng, lam)):
                k = counters[t.name]
                counters[t.name] = k + 1
                plen = rng.randint(*t.prompt_len)
                prompt = np.array(
                    [rng.randrange(vocab_size) for _ in range(plen)], np.int32
                )
                out.append(
                    (
                        step,
                        Request(
                            prompt=prompt,
                            max_new_tokens=rng.randint(*t.max_new_tokens),
                            name=f"{t.name}_{k}",
                            tenant=t.name,
                            priority=t.priority,
                        ),
                    )
                )
    return out


@dataclass
class LoadReport:
    """Result of one :func:`replay_load` run."""

    wall_s: float
    steps: int
    #: every request retired during the replay, in retirement order
    requests: List[Request]
    #: per-tenant SLO rollup (see :func:`slo_report`)
    per_tenant: Dict[str, Dict[str, object]]
    #: completed tokens per wall second, all tenants together
    total_goodput_tok_s: float


def replay_load(
    eng: Engine,
    load: Sequence[Tuple[int, Request]],
    *,
    max_steps: int = 100_000,
) -> LoadReport:
    """Replay a :func:`generate_load` trace against ``eng``: each engine step
    first submits every request whose arrival step has come, then runs one
    ``eng.step()`` — continuous batching under trace-shaped traffic.  Runs
    until the trace and the engine both drain (``max_steps`` is a livelock
    guard), then drains the engine's retired buffer into the report."""
    pending = deque(sorted(load, key=lambda e: e[0]))
    t0 = time.perf_counter()
    step = 0
    while pending or eng.queue or eng._backoff or eng._active():
        if step >= max_steps:
            raise RuntimeError(
                f"replay_load exceeded {max_steps} steps with "
                f"{len(pending)} arrival(s) still pending"
            )
        while pending and pending[0][0] <= step:
            eng.submit(pending.popleft()[1])
        eng.step()
        step += 1
    wall = time.perf_counter() - t0
    retired = eng.drain_retired()
    frame = eng.frame
    total_tokens = int(frame.filter(access_type="SLO", outcome="TOKENS_OUT").sum())
    return LoadReport(
        wall_s=wall,
        steps=step,
        requests=retired,
        per_tenant=slo_report(frame, wall_s=wall),
        total_goodput_tok_s=total_tokens / wall if wall > 0 else 0.0,
    )


def _pct(vals: List[int], q: float) -> float:
    return float(np.percentile(np.asarray(vals, dtype=np.float64), q)) if vals else 0.0


def slo_report(frame, *, wall_s: float = 0.0) -> Dict[str, Dict[str, object]]:
    """Per-tenant SLO rollup, every number a frame query (docs/API.md):

    * ``ttft_us`` / ``latency_us``: p50/p95/p99 over the per-stream ``SLO``
      lane values (each request is a stream, so each stream's lane sum is
      one sample; the engine clamps samples to ≥ 1 µs, so a nonzero cell
      means "sample present"),
    * ``tokens_out`` / ``goodput_tok_s``: completed tokens (and per wall
      second when ``wall_s`` is given),
    * ``shed_rate`` / ``timeout_rate``: terminal sheds (``SHED`` events minus
      the ones that became ``RETRY``) and timeouts per submitted request.
    """
    out: Dict[str, Dict[str, object]] = {}
    for tenant, sub in frame.groupby("tenant").frames().items():
        sids = sub.streams()
        ttft = [
            v
            for sid in sids
            if (v := int(sub.filter(stream=sid, access_type="SLO", outcome="TTFT_US").sum())) > 0
        ]
        lat = [
            v
            for sid in sids
            if (v := int(sub.filter(stream=sid, access_type="SLO", outcome="LATENCY_US").sum())) > 0
        ]
        toks = int(sub.filter(access_type="SLO", outcome="TOKENS_OUT").sum())
        shed = int(sub.filter(access_type="FAULT", outcome="SHED").sum())
        retries = int(sub.filter(access_type="FAULT", outcome="RETRY").sum())
        timeouts = int(sub.filter(access_type="FAULT", outcome="TIMEOUT_EXPIRED").sum())
        n = len(sids)
        out[tenant] = {
            "requests": n,
            "ttft_us": {q: _pct(ttft, p) for q, p in (("p50", 50), ("p95", 95), ("p99", 99))},
            "latency_us": {q: _pct(lat, p) for q, p in (("p50", 50), ("p95", 95), ("p99", 99))},
            "tokens_out": toks,
            "goodput_tok_s": toks / wall_s if wall_s > 0 else 0.0,
            "shed_events": shed,
            "retry_events": retries,
            "timeout_count": timeouts,
            "shed_rate": max(shed - retries, 0) / n if n else 0.0,
            "timeout_rate": timeouts / n if n else 0.0,
        }
    return out
