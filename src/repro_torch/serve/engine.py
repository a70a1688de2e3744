"""Multi-stream serving front-end: continuous batching with per-stream and
per-tenant statistics — the paper's feature where it matters in production.

Every client request is a :class:`repro_torch.core.Stream`.  The engine keeps a
fixed decode batch of ``n_slots``; each slot is bound to (at most) one
request stream.  Scheduling per step (docs/DESIGN.md §5.12):

1. release expired backoffs, expire deadlines, admit queued requests into
   free slots (prefill, cache transplant) — admits happen *between* decode
   steps without draining the batch (continuous batching),
2. one batched ``decode_step`` advances every active slot; when
   ``batch_buckets`` are configured the decode runs at the smallest bucket
   covering the active slots (padding/unpadding is a pure slice/write-back,
   so per-request greedy results are unchanged by the bucket choice),
3. finished slots (EOS / max_tokens) retire → their stream's stats print
   (the paper's print-on-kernel-exit, §3.1) and the slot frees.

Admission control: ``ServeConfig.max_live`` caps admitted work (queue +
active slots) the way saxml caps live batches — overflow sheds the
lowest-priority/latest entry through the same lanes as queue-limit faults —
and ``max_admits_per_step`` bounds prefills per engine step so a burst
cannot starve the decode cadence.

Per-stream / per-tenant attribution (``StreamStats`` + ``StatTable``):
  * prefill / decode wall-time per request stream,
  * tokens in/out per stream,
  * KV-cache bytes written per stream (KV_ACC_W rows),
  * SLO lanes (``AccessType.SLO`` row): TTFT_US at first token, LATENCY_US
    and TOKENS_OUT at retirement — so TTFT, per-token latency, goodput and
    shed/timeout rates are all StatsFrame queries, rolled up per tenant via
    ``frame.groupby("tenant")``,
  * per-step kernel timeline (§3.2 ``gpu_kernel_time`` analog).

Retirement folds the stream's step records into a constant-size aggregate
(:meth:`StreamStats.retire_stream`), so a long-running engine holds O(live)
step state no matter how many requests it has served.

Without the stream dimension these numbers are exactly the conflated
aggregates the paper complains about — see ``benchmarks/serving.py`` for the
side-by-side, and ``serve/loadgen.py`` for the trace-driven multi-tenant
load generator that exercises all of it under saturation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import heapq

import numpy as np
import torch

from ..core.faults import FAULT_LANES, FaultPlan
from ..core import (
    AccessOutcome,
    AccessType,
    ReportSink,
    StatsEngine,
    StatsFrame,
    StreamManager,
    StreamStats,
    render_text,
    stream_report,
)
from ..models.transformer import Transformer
from .cache_utils import transplant

__all__ = ["Request", "ServeConfig", "Engine"]


@dataclass
class Request:
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1  # -1 → run to max_new_tokens
    name: str = ""
    #: tenant owning this request; per-tenant SLO rollups are
    #: ``engine.frame.groupby("tenant")`` queries (docs/DESIGN.md §5.12)
    tenant: str = ""
    #: admission priority under load shedding (higher = keep longer); ties
    #: shed the latest-submitted first (docs/DESIGN.md §5.11)
    priority: int = 0
    #: per-request deadline in engine steps from submission (0 = use the
    #: fault plan's ``deadline_steps`` default; both 0 = no deadline)
    deadline_steps: int = 0
    # filled by the engine
    stream_id: int = -1
    generated: List[int] = field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    submitted_s: float = 0.0
    #: submission → first token (set at prefill; mirrored on the SLO lane)
    ttft_s: float = 0.0
    done: bool = False
    #: retry attempts consumed (shed → backoff → re-enqueue cycles)
    retries: int = 0
    #: terminal disposition: "done", "timeout", "shed", or "cancelled"
    status: str = ""
    #: the stream's exit report as text, rendered when the request retires
    exit_report: str = ""
    _seq: int = field(default=-1, init=False, repr=False)
    _submit_step: int = field(default=0, init=False, repr=False)
    _faulted: bool = field(default=False, init=False, repr=False)


@dataclass(frozen=True)
class ServeConfig:
    n_slots: int = 4
    max_len: int = 256
    #: greedy=True → argmax decoding; False → seeded categorical sampling
    #: at ``temperature`` (deterministic for a fixed ``sample_seed``).
    greedy: bool = True
    temperature: float = 1.0
    sample_seed: int = 0
    #: sorted decode batch-size buckets (each in ``1..n_slots``; ``n_slots``
    #: is always implied).  Each decode runs at the smallest bucket covering
    #: the highest active slot: the cache is sliced to the bucket, decoded,
    #: and written back, so a partially-full batch does not pay for empty
    #: slots.  Greedy per-request results are invariant to the bucket choice
    #: (row-independent decode); categorical sampling draws depend on batch
    #: shape, so sampled runs are reproducible per config but not across
    #: bucket configs.  ``()`` → always decode at ``n_slots`` (the pre-bucket
    #: behavior, bit-for-bit).
    batch_buckets: Tuple[int, ...] = ()
    #: admission control (saxml's ``max_live_batches`` analog): caps admitted
    #: work (queue + active slots); overflow sheds the lowest-priority /
    #: latest entry through the standard SHED lane (terminal without a fault
    #: plan, retry+backoff with one).  0 → uncapped.
    max_live: int = 0
    #: at most this many prefills per engine step, so an arrival burst
    #: cannot starve the decode cadence of already-admitted requests.
    #: 0 → fill every free slot.
    max_admits_per_step: int = 0
    #: request-layer fault injection (docs/DESIGN.md §5.11): admission-queue
    #: overflow → priority-based load shedding with bounded retry +
    #: exponential backoff + seeded jitter, and per-request step deadlines.
    #: ``None`` (or a plan with ``queue_limit=0`` and ``deadline_steps=0``)
    #: disables every request-layer fault path.
    fault_plan: Optional[FaultPlan] = None

    def __post_init__(self) -> None:
        for b in self.batch_buckets:
            if not (1 <= int(b) <= self.n_slots):
                raise ValueError(
                    f"batch bucket {b} outside [1, n_slots={self.n_slots}]"
                )
        if self.max_live < 0:
            raise ValueError("max_live must be >= 0 (0 = uncapped)")
        if self.max_admits_per_step < 0:
            raise ValueError("max_admits_per_step must be >= 0 (0 = uncapped)")


class Engine:
    """Continuous-batching server over ``model``, on the model's device."""

    def __init__(
        self,
        model: Transformer,
        scfg: ServeConfig,
        sinks: Optional[List[ReportSink]] = None,
    ) -> None:
        cfg = model.cfg
        if not any(cfg.layer_is_attn(i) for i in range(cfg.n_layers)):
            raise NotImplementedError(
                f"{cfg.name} has no attention layer, and serving a pure-SSM model is not supported: "
                "the reference engine fails on it too (src/repro/serve/engine.py:228, where "
                "resolved_head_dim divides by n_heads = 0)"
            )
        if cfg.encdec:
            raise NotImplementedError(
                f"{cfg.name} is an encoder-decoder model, and serving one is not supported: the reference engine "
                "prefills with the tokens alone (src/repro/serve/engine.py:383) and fails on the missing frame "
                "embeddings (src/repro/models/transformer.py:335-336, KeyError 'enc_embeds'); the model's own "
                "prefill and decode_step take them"
            )
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.scfg = scfg
        self.streams = StreamManager()
        self.stats = StreamStats()
        # per-stream KV/byte rows; vectorized batch ingestion on the decode path
        self.table = StatsEngine(name="Serve_stats")
        self.sinks: List[ReportSink] = list(sinks) if sinks else []
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * scfg.n_slots
        self.pos = np.zeros((scfg.n_slots,), np.int32)  # next write position
        self.last_token = np.zeros((scfg.n_slots,), np.int32)
        #: the model's stacked cache leaves, slots on axis 1: {"k", "v"} of (L_attn, n_slots,
        #: max_len, Hkv, D) or MLA's {"ckv"} of (L_attn, n_slots, max_len, kv_lora + qk_rope)
        #: over the attention layers, and the SSM leaves (conv windows, fp32 state "h") of
        #: (L_ssm, n_slots, ...) over the Mamba-2 layers; every step handles the leaves
        #: alike, whatever their keys (transplant writes the K/V leaves at offset 0 of the
        #: sequence axis and copies the equal-shaped SSM leaves whole)
        self.cache = model.init_cache(scfg.n_slots, scfg.max_len, dtype=cfg.compute_tdtype())
        #: sorted decode buckets; n_slots always present so a full batch
        #: takes the unsliced fast path
        self._buckets = tuple(sorted(set(map(int, scfg.batch_buckets)) | {scfg.n_slots}))
        self._kv_bytes_per_token = self._estimate_kv_bytes_per_token()
        self._rng = torch.Generator(device=self.device).manual_seed(scfg.sample_seed)
        self._retired: List[Request] = []
        self._frame_cache: Optional[Tuple[int, StatsFrame]] = None
        #: stream id → tenant label (feeds StatsFrame tenant queries)
        self._tenants: Dict[int, str] = {}
        #: engine-lifetime terminal-status ledger; unlike ``_retired`` it is
        #: never drained, so ``fault_summary`` stays consistent with the
        #: cumulative fault lanes (bugfix, docs/DESIGN.md §5.12)
        self._status_counts: Dict[str, int] = {}
        # request-layer fault injection (docs/DESIGN.md §5.11)
        self._step_count = 0
        self._seq = 0  # submission order; deterministic shed tie-break
        #: shed requests awaiting re-enqueue: (eligible_step, seq, request)
        self._backoff: List[Tuple[int, int, Request]] = []

    def _select_tokens(self, logits) -> np.ndarray:
        """Next-token selection for ``(B, V)`` logits — the one place both
        the prefill and decode paths pick tokens.  Greedy → argmax; otherwise
        seeded categorical sampling at ``ServeConfig.temperature`` by the
        Gumbel-max trick over the engine's ``torch.Generator``, so runs are
        reproducible for a fixed ``sample_seed`` (the draws are not the
        reference's ``jax.random`` ones)."""
        if self.scfg.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        temp = max(float(self.scfg.temperature), 1e-6)
        u = torch.rand(logits.shape, generator=self._rng, device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / temp + gumbel, dim=-1).cpu().numpy().astype(np.int32)

    def _estimate_kv_bytes_per_token(self) -> int:
        itemsize = self.cfg.compute_tdtype().itemsize
        if self.cfg.mla is not None:
            per = self.cfg.mla.kv_lora_rank + self.cfg.mla.qk_rope_dim
        else:
            per = 2 * self.cfg.n_kv_heads * self.cfg.resolved_head_dim
        n_attn = sum(1 for i in range(self.cfg.n_layers) if self.cfg.layer_is_attn(i))
        return per * n_attn * itemsize

    # ------------------------------------------------------------------ admission
    def submit(self, req: Request) -> int:
        s = self.streams.create_stream(req.name or f"req_{self._seq}")
        req.stream_id = s.stream_id
        if req.tenant:
            self._tenants[s.stream_id] = req.tenant
        req.submitted_s = time.perf_counter()
        req._seq = self._seq
        self._seq += 1
        req._submit_step = self._step_count
        self.queue.append(req)
        plan = self.scfg.fault_plan
        if plan is not None:
            # Admission control: over capacity, shed the lowest-priority
            # entry (ties: latest submitted) — possibly the new arrival.
            self._enforce_queue_limit(plan)
        self._enforce_max_live()
        return s.stream_id

    def _shed(self, req: Request, plan: Optional[FaultPlan]) -> None:
        """One shed event (lane ``SHED``): into backoff while the retry
        budget lasts, else terminal.  With no fault plan the shed is always
        terminal (there is no retry machinery to re-enqueue through)."""
        self.table.inc_stats(AccessType.FAULT, AccessOutcome.SHED, req.stream_id, 1)
        if plan is not None and req.retries < plan.max_retries:
            req._faulted = True
            eligible = self._step_count + plan.backoff_steps(req.retries, req.stream_id)
            heapq.heappush(self._backoff, (eligible, req._seq, req))
        else:
            self._finish(req, "shed", "request_shed")

    def cancel(self, req: Request) -> bool:
        """Client cancellation: removes ``req`` wherever it lives (queue,
        backoff, or an active slot) and retires it with status
        ``"cancelled"``.  Cancellation is load the engine dropped on request,
        so it lands on the ``SHED`` lane (docs/DESIGN.md §5.11).  Returns
        False when the request is not live in this engine."""
        slot = next((i for i, r in enumerate(self.slots) if r is req), None)
        if any(r is req for r in self.queue):
            self.queue = [r for r in self.queue if r is not req]
        elif any(entry[2] is req for entry in self._backoff):
            self._backoff = [e for e in self._backoff if e[2] is not req]
            heapq.heapify(self._backoff)
        elif slot is not None:
            self.slots[slot] = None
        else:
            return False
        self.table.inc_stats(AccessType.FAULT, AccessOutcome.SHED, req.stream_id, 1)
        self._finish(req, "cancelled", "request_cancelled")
        return True

    def _enforce_queue_limit(self, plan: FaultPlan) -> None:
        if plan.queue_limit <= 0:
            return
        # identity-based removal throughout: Request is a dataclass holding
        # numpy prompts, so == would broadcast instead of comparing requests
        while len(self.queue) > plan.queue_limit:
            victim = min(self.queue, key=lambda r: (r.priority, -r._seq))
            self.queue = [r for r in self.queue if r is not victim]
            self._shed(victim, plan)

    def _enforce_max_live(self) -> None:
        """``max_live`` admission control: while admitted work (queue +
        active slots) exceeds the cap, shed the lowest-priority / latest
        queued entry through the standard SHED machinery.  Active slots are
        never evicted — admission control gates entry, it does not preempt."""
        ml = self.scfg.max_live
        if ml <= 0:
            return
        plan = self.scfg.fault_plan
        while self.queue and len(self.queue) + sum(
            1 for r in self.slots if r is not None
        ) > ml:
            victim = min(self.queue, key=lambda r: (r.priority, -r._seq))
            self.queue = [r for r in self.queue if r is not victim]
            self._shed(victim, plan)

    def _release_backoff(self, plan: FaultPlan) -> None:
        """Re-enqueue shed requests whose backoff expired (lane ``RETRY``
        per attempt), oldest eligibility first; the queue limit re-applies,
        so a still-full queue sheds again (burning another retry)."""
        released = False
        while self._backoff and self._backoff[0][0] <= self._step_count:
            _, _, req = heapq.heappop(self._backoff)
            req.retries += 1
            self.table.inc_stats(AccessType.FAULT, AccessOutcome.RETRY, req.stream_id, 1)
            self.queue.append(req)
            released = True
        if released:
            self._enforce_queue_limit(plan)
            self._enforce_max_live()

    def _deadline_of(self, req: Request, plan: Optional[FaultPlan]) -> int:
        if req.deadline_steps > 0:
            return req.deadline_steps
        return plan.deadline_steps if plan is not None else 0

    def _expire_deadlines(self, plan: Optional[FaultPlan]) -> None:
        """Retire every live request past its step deadline (lane
        ``TIMEOUT_EXPIRED``, status ``"timeout"``) — queued, backing off, or
        holding a slot; an expired slot frees for the next admit."""
        def expired(req: Request) -> bool:
            d = self._deadline_of(req, plan)
            return d > 0 and self._step_count - req._submit_step >= d

        victims: List[Request] = [r for r in self.queue if expired(r)]
        for entry in list(self._backoff):
            if expired(entry[2]):
                victims.append(entry[2])
        for i, req in enumerate(self.slots):
            if req is not None and expired(req):
                victims.append(req)
                self.slots[i] = None
        if not victims:
            return
        dead = {id(r) for r in victims}
        self.queue = [r for r in self.queue if id(r) not in dead]
        self._backoff = [e for e in self._backoff if id(e[2]) not in dead]
        heapq.heapify(self._backoff)
        for req in victims:
            self.table.inc_stats(
                AccessType.FAULT, AccessOutcome.TIMEOUT_EXPIRED, req.stream_id, 1
            )
            self._finish(req, "timeout", "request_timeout")

    def _admit(self) -> None:
        cap = self.scfg.max_admits_per_step
        admitted = 0
        for slot in range(self.scfg.n_slots):
            if self.slots[slot] is not None:
                continue
            # keep prefilling into this slot until something survives its
            # own prefill (a request whose first token terminates it retires
            # immediately and never occupies the slot)
            while self.queue and self.slots[slot] is None:
                if cap > 0 and admitted >= cap:
                    return
                req = self.queue.pop(0)
                admitted += 1
                self._prefill_one(req, slot)

    def _prefill_one(self, req: Request, slot: int) -> None:
        """Prefill one request and bind it to ``slot`` — unless its prefill
        token already terminates it (EOS as first token, or
        ``max_new_tokens == 1``), in which case it retires with exactly the
        tokens it produced and the slot stays free (bugfix: the old path
        unconditionally entered decode, so eos-at-prefill decoded anyway and
        ``max_new_tokens=1`` retired with 2 tokens)."""
        t0 = time.perf_counter()
        uid = self.stats.step_begin("prefill", req.stream_id)
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long, device=self.device)[None]
        logits, small = self.model.prefill(tokens)
        nxt = int(self._select_tokens(logits)[0])
        plen = len(req.prompt)
        req.generated.append(nxt)
        req.prefill_s = time.perf_counter() - t0
        req.ttft_s = time.perf_counter() - req.submitted_s
        self.stats.step_end(uid, tokens=plen)
        self.table.inc_stats(
            AccessType.KV_ACC_W, AccessOutcome.MISS, req.stream_id,
            plen * self._kv_bytes_per_token,
        )
        # SLO lane: submission → first token, µs (clamped to ≥1 so every
        # prefetched request owns a nonzero TTFT cell — queries count samples
        # by nonzero cells)
        self.table.inc_stats(
            AccessType.SLO, AccessOutcome.TTFT_US, req.stream_id,
            max(int(req.ttft_s * 1e6), 1),
        )
        hit_eos = req.eos_id >= 0 and nxt == req.eos_id
        if hit_eos or len(req.generated) >= req.max_new_tokens:
            self._finish(req, "done", "request_done")
            return
        # place this sequence's prompt cache into its slot of the batched
        # buffers: the slot row is zeroed, then the prompt K/V land at 0
        one = {k: v[:, slot:slot + 1] for k, v in self.cache.items()}
        for leaf in one.values():
            leaf.zero_()
        transplant(one, small)
        self.pos[slot] = plen
        self.last_token[slot] = nxt
        self.slots[slot] = req

    # ------------------------------------------------------------------ decode
    def _active(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def _bucket_for(self, need: int) -> int:
        """Smallest configured bucket covering slots ``0..need-1``
        (``n_slots`` is always a member, so this always resolves)."""
        for b in self._buckets:
            if b >= need:
                return b
        return self.scfg.n_slots

    def _decode_active(self, active: List[int]):
        """One decode step over the smallest bucket covering the active
        slots.  ``bucket == n_slots`` is the literal unsliced path (the
        pre-bucket behavior); a smaller bucket decodes a view of the cache's
        first ``bucket`` slots (axis 1), and ``decode_step`` writes the
        advanced rows into it in place, so there is nothing to write back.
        Decode is row-independent, so active rows see identical math either
        way."""
        bucket = self._bucket_for(max(active) + 1)
        tokens = torch.as_tensor(self.last_token[:bucket], dtype=torch.long, device=self.device)
        pos = torch.as_tensor(self.pos[:bucket], dtype=torch.long, device=self.device)
        if bucket == self.scfg.n_slots:
            view = self.cache
        else:
            view = {k: v[:, :bucket] for k, v in self.cache.items()}
        logits, _ = self.model.decode_step(view, tokens, pos)
        return logits

    def step(self) -> int:
        """One engine iteration.  Returns #active slots advanced."""
        self._step_count += 1
        plan = self.scfg.fault_plan
        if self._backoff and plan is not None:
            self._release_backoff(plan)
        if plan is not None or any(
            r is not None and r.deadline_steps > 0
            for r in (*self.queue, *self.slots)
        ):
            self._expire_deadlines(plan)
        self._admit()
        active = self._active()
        if not active:
            return 0
        t0 = time.perf_counter()
        uids = {i: self.stats.step_begin("decode", self.slots[i].stream_id) for i in active}
        nxt = self._select_tokens(self._decode_active(active))
        dt = time.perf_counter() - t0
        # One vectorized ingest for the whole decode batch: every active
        # slot wrote one token's KV bytes on its own stream this step.
        # Cumulative lane only — same stores the seed's inc_stats loop fed.
        sids = np.fromiter((self.slots[i].stream_id for i in active), dtype=np.int64, count=len(active))
        self.table.record_batch(
            np.full(len(active), int(AccessType.KV_ACC_W), dtype=np.int64),
            np.full(len(active), int(AccessOutcome.MISS), dtype=np.int64),
            sids,
            np.full(len(active), self._kv_bytes_per_token, dtype=np.uint64),
            pw=False,
            clean=False,
        )
        for i in active:
            req = self.slots[i]
            req.decode_s += dt / len(active)  # fair-share attribution
            self.stats.step_end(uids[i], tokens=1)
            req.generated.append(int(nxt[i]))
            self.pos[i] += 1
            self.last_token[i] = nxt[i]
            hit_eos = req.eos_id >= 0 and int(nxt[i]) == req.eos_id
            if hit_eos or len(req.generated) >= req.max_new_tokens or self.pos[i] >= self.scfg.max_len - 1:
                self.slots[i] = None
                self._finish(req, "done", "request_done")
        return len(active)

    def _finish(self, req: Request, status: str, event: str) -> None:
        """The one terminal path every disposition funnels through (done /
        timeout / shed / cancelled, whether the request held a slot or not):

        * SLO lanes: LATENCY_US (submission → terminal, µs, clamped ≥1 so
          every terminal owns a nonzero cell) always; TOKENS_OUT and — for
          recovered requests — the RECOVERED lane only on ``"done"``,
        * the engine-lifetime ``_status_counts`` ledger (never drained),
        * paper §3.1: on exit, report only this stream's stats — a
          StatsFrame selection through the same sink code path as the
          simulator's kernel-exit and the trainer's summary,
        * bounded memory: fold this stream's step records into its
          aggregate (:meth:`StreamStats.retire_stream`).
        """
        req.done = True
        req.status = status
        sid = req.stream_id
        self.table.inc_stats(
            AccessType.SLO, AccessOutcome.LATENCY_US, sid,
            max(int((time.perf_counter() - req.submitted_s) * 1e6), 1),
        )
        if status == "done":
            if req.generated:
                self.table.inc_stats(
                    AccessType.SLO, AccessOutcome.TOKENS_OUT, sid, len(req.generated)
                )
            if req._faulted:
                # completed despite shedding/backoff: graceful degradation worked
                self.table.inc_stats(
                    AccessType.FAULT, AccessOutcome.RECOVERED, sid, 1
                )
        self._status_counts[status] = self._status_counts.get(status, 0) + 1
        fields: Dict[str, Any] = {
            "name": req.name,
            "tokens_out": len(req.generated),
            "prefill_s": req.prefill_s,
            "decode_s": req.decode_s,
            "retries": req.retries,
            "status": status,
        }
        if req.tenant:
            fields["tenant"] = req.tenant
        report = stream_report(
            self.frame,
            sid,
            source="serve",
            event=event,
            cache_name="Serve_stats",
            fields=fields,
        )
        req.exit_report = render_text(report)
        self.stats.retire_stream(sid)
        self._retired.append(req)
        for sink in self.sinks:
            sink.emit(report)

    def drain_retired(self) -> List[Request]:
        """Hand over (and forget) every request retired since the last drain.
        Callers driving :meth:`step` directly use this to collect finished
        requests; nothing is retained by the engine afterwards, so
        long-running engines stay bounded."""
        out = self._retired
        self._retired = []
        return out

    def run_until_idle(
        self, max_steps: int = 10_000, deadline_s: Optional[float] = None
    ) -> List[Request]:
        """Step until queue, backoff, and slots drain; returns the requests
        retired during this call (in retirement order) and forgets them,
        leaving any earlier un-drained retirements for :meth:`drain_retired`.

        ``max_steps`` and the optional ``deadline_s`` wall-clock budget are
        livelock guards: a workload that cannot drain (e.g. an EOS-free
        request whose ``max_new_tokens`` exceeds the step budget) raises
        ``RuntimeError`` naming the stuck requests instead of spinning
        forever (docs/DESIGN.md §5.11)."""
        mark = len(self._retired)
        steps = 0
        t0 = time.perf_counter()
        while self.queue or self._backoff or self._active():
            if steps >= max_steps or (
                deadline_s is not None and time.perf_counter() - t0 > deadline_s
            ):
                stuck = (
                    [r.name or f"req_{r._seq}" for r in self.queue]
                    + [e[2].name or f"req_{e[2]._seq}" for e in self._backoff]
                    + [r.name or f"req_{r._seq}" for r in self.slots if r is not None]
                )
                raise RuntimeError(
                    f"run_until_idle exceeded its budget after {steps} steps "
                    f"({time.perf_counter() - t0:.1f}s) with "
                    f"{len(stuck)} request(s) still live: {stuck}"
                )
            self.step()
            steps += 1
        done = self._retired[mark:]
        del self._retired[mark:]
        return done

    def fault_summary(self) -> Dict[str, object]:
        """Snapshot of the fault subsystem.  Both halves are
        **engine-lifetime totals**: ``lanes`` reads the cumulative fault
        rows of the stat table, and ``statuses`` reads the cumulative
        terminal-status ledger — neither is affected by
        :meth:`drain_retired` (bugfix: statuses used to be recomputed from
        the un-drained ``_retired`` buffer, so a drain silently zeroed
        them while the lanes kept counting)."""
        frame = self.frame.filter(access_type=AccessType.FAULT)
        lanes = {
            lane: int(frame.filter(outcome=getattr(AccessOutcome, lane)).sum())
            for lane in FAULT_LANES
        }
        return {
            "lanes": lanes,
            "statuses": dict(self._status_counts),
            "pending_backoff": len(self._backoff),
        }

    # ------------------------------------------------------------------ reports
    @property
    def frame(self) -> StatsFrame:
        """The engine's per-stream byte table as a query frame; request
        streams resolve by their submitted names
        (``eng.frame.filter(stream="req3", access_type="KV_ACC_W").sum()``)
        and tenants by label
        (``eng.frame.filter(tenant="batch").sum()``,
        ``eng.frame.groupby("tenant")``).  Cached until a new stream appears
        — ``_finish`` reads it per finished request, and rebuilding the name
        maps there would make retirement O(total requests)."""
        n = len(self.streams._streams)
        if self._frame_cache is None or self._frame_cache[0] != n:
            names = {
                s.name: sid for sid, s in self.streams._streams.items() if s.name
            }
            self._frame_cache = (
                n,
                StatsFrame(self.table, names=names, tenants=dict(self._tenants)),
            )
        return self._frame_cache[1]

    def per_stream_report(self) -> Dict[int, Dict[str, float]]:
        frame = self.frame.filter(
            access_type=AccessType.KV_ACC_W, outcome=AccessOutcome.MISS
        )
        out = {}
        for sid in self.stats.streams():
            out[sid] = self.stats.summary(sid)
            out[sid]["kv_bytes"] = float(frame.filter(stream=sid).sum())
        return out

