"""Shared-resource models for the TPU timing simulator.

GPGPU-Sim models SMs, an L2, and DRAM channels; the TPU analog we model is

* :class:`VMEMCache` — the HBM→VMEM staging buffer treated as a cache with an
  MSHR-like in-flight merge table.  TPU VMEM is software-managed, but DMA
  engines do merge redundant in-flight HBM fetches, which is what MSHR_HIT
  (``HIT_RESERVED``) captures; residency-HIT models intra-window reuse.
* :class:`Bandwidth` — token-bucket bytes/cycle for HBM and ICI links.
* :class:`Compute` — MXU FLOPs/cycle.

The classification outcomes intentionally mirror Accel-Sim's
``cache_request_status`` so the paper's stat tables translate one-to-one.
"""

from __future__ import annotations

import heapq
import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.stats import AccessOutcome, AccessType, FailOutcome

__all__ = [
    "VMEMCache",
    "Bandwidth",
    "Compute",
    "CacheDecision",
    "HW_V5E",
    "MissPath",
    "MISS_MECHANISMS",
]


@dataclass(frozen=True)
class HWConstants:
    """TPU v5e (the target part) — used by both the simulator and roofline."""

    peak_bf16_flops: float = 197e12  # FLOP/s per chip
    hbm_bw: float = 819e9  # B/s per chip
    ici_bw_per_link: float = 50e9  # B/s per link (~

    clock_hz: float = 0.94e9
    vmem_bytes: int = 128 * 2**20  # total on-chip vector memory
    vmem_core_bytes: int = 16 * 2**20  # per-core staging budget we model

    @property
    def flops_per_cycle(self) -> float:
        return self.peak_bf16_flops / self.clock_hz

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bw / self.clock_hz

    @property
    def ici_bytes_per_cycle(self) -> float:
        return self.ici_bw_per_link / self.clock_hz


HW_V5E = HWConstants()


@dataclass(frozen=True)
class CacheDecision:
    outcome: AccessOutcome
    fail_reason: Optional[FailOutcome] = None
    ready_cycle: int = 0  # cycle at which the line becomes resident (MISS/HIT_RESERVED)


# Outcome-only decisions carry no per-access state, so the hot path returns
# shared singletons instead of allocating a frozen dataclass per access.
_HIT = CacheDecision(AccessOutcome.HIT)
_FAIL_MSHR_MERGE = CacheDecision(AccessOutcome.RESERVATION_FAILURE, FailOutcome.MSHR_MERGE_FAIL)
_FAIL_MSHR_ENTRY = CacheDecision(AccessOutcome.RESERVATION_FAILURE, FailOutcome.MSHR_ENTRY_FAIL)
_FAIL_BANDWIDTH = CacheDecision(AccessOutcome.RESERVATION_FAILURE, FailOutcome.BANDWIDTH_FAIL)


class Bandwidth:
    """Bytes/cycle token bucket with a rolling next-free-cycle pointer.

    HBM is modeled half-duplex: reads and writes drain the same token bucket
    (``next_free_cycle``), but the byte totals are attributed separately so
    read/write mixes stay observable (``total_rd_bytes`` / ``total_wr_bytes``).
    """

    def __init__(self, bytes_per_cycle: float) -> None:
        self.bytes_per_cycle = float(bytes_per_cycle)
        self.next_free_cycle = 0.0
        self.total_bytes = 0
        self.total_rd_bytes = 0
        self.total_wr_bytes = 0

    def occupy(self, n_bytes: int, cycle: int, is_write: bool = False) -> int:
        """Schedule a transfer; returns the cycle it completes."""
        start = max(float(cycle), self.next_free_cycle)
        dur = n_bytes / self.bytes_per_cycle
        self.next_free_cycle = start + dur
        self.total_bytes += n_bytes
        if is_write:
            self.total_wr_bytes += n_bytes
        else:
            self.total_rd_bytes += n_bytes
        return int(self.next_free_cycle) + 1

    def saturated(self, cycle: int, horizon: int) -> bool:
        """True if the queue is already ``horizon`` cycles deep."""
        return self.next_free_cycle > cycle + horizon


class Compute:
    """MXU occupancy: per-kernel FLOP budgets drained at flops/cycle,
    shared fairly among concurrently resident kernels."""

    def __init__(self, flops_per_cycle: float) -> None:
        self.flops_per_cycle = float(flops_per_cycle)

    def cycles_for(self, flops: float, n_sharers: int = 1) -> int:
        if flops <= 0:
            return 0
        eff = self.flops_per_cycle / max(1, n_sharers)
        return max(1, int(flops / eff))


class _Line:
    __slots__ = ("tag", "dirty", "last_use")

    def __init__(self, tag: int, dirty: bool, last_use: int) -> None:
        self.tag = tag
        self.dirty = dirty
        self.last_use = last_use


def _no_record(atype: int, outcome: int, stream_id: int, cycle: int, n: int = 1) -> None:
    """Default stat sink for a standalone :class:`VMEMCache` (no executor)."""


class _VictimCache:
    """Jouppi-style victim cache: a small fully-associative LRU buffer that
    holds lines evicted from the main array.  A hit moves the line (with its
    dirty bit) back into the main array; the victim cache absorbs dirty
    evictions, deferring their writeback until the entry itself overflows."""

    __slots__ = ("entries", "lines")

    def __init__(self, entries: int) -> None:
        self.entries = int(entries)
        self.lines: "OrderedDict[int, bool]" = OrderedDict()  # tag -> dirty, LRU order

    def take(self, tag: int) -> Optional[bool]:
        """Remove and return the dirty bit if ``tag`` is held, else None."""
        if tag in self.lines:
            return self.lines.pop(tag)
        return None

    def insert(self, tag: int, dirty: bool) -> Optional[Tuple[int, bool]]:
        """Absorb an evicted line; returns the (tag, dirty) entry that
        overflows out of the victim cache, if any."""
        self.lines[tag] = dirty
        if len(self.lines) > self.entries:
            return self.lines.popitem(last=False)
        return None

    def state(self) -> Tuple:
        return tuple(self.lines.items())

    def restore(self, state: Tuple) -> None:
        self.lines = OrderedDict((int(t), bool(d)) for t, d in state)


class _MissCache:
    """Jouppi-style miss cache: a small LRU tag store filled with every line
    the main array fully misses on.  A subsequent miss that finds its tag
    here is satisfied at hit latency (the line was fetched recently enough
    that a tiny buffer still holds it); the entry stays, LRU-touched."""

    __slots__ = ("entries", "tags")

    def __init__(self, entries: int) -> None:
        self.entries = int(entries)
        self.tags: "OrderedDict[int, None]" = OrderedDict()

    def hit(self, tag: int) -> bool:
        if tag in self.tags:
            self.tags.move_to_end(tag)
            return True
        return False

    def fill(self, tag: int) -> None:
        self.tags[tag] = None
        self.tags.move_to_end(tag)
        if len(self.tags) > self.entries:
            self.tags.popitem(last=False)

    def state(self) -> Tuple:
        return tuple(self.tags)

    def restore(self, state: Tuple) -> None:
        self.tags = OrderedDict((int(t), None) for t in state)


class _StreamBufferSet:
    """Jouppi-style stream buffers: ``n`` FIFO queues of depth ``depth``,
    each holding ``(tag, ready_cycle)`` prefetches of sequential tags.

    Head-match only: a demand access that equals a buffer's *head* entry is
    a PREFETCH_HIT — the head pops, the line installs into the main array,
    and one refill prefetch extends the buffer's tail.  A full miss
    allocates the least-recently-used buffer and restarts it at ``tag+1``.
    Arrivals are lazy (consulted at access time via the stored ready cycle),
    so the set needs no per-cycle tick.
    """

    __slots__ = ("n", "depth", "entries", "next_tag", "lru")

    def __init__(self, n: int, depth: int) -> None:
        self.n = int(n)
        self.depth = int(depth)
        self.entries: List[List[Tuple[int, int]]] = [[] for _ in range(self.n)]
        self.next_tag: List[int] = [0] * self.n
        self.lru: List[int] = list(range(self.n))  # front = least recently used

    def pop_head(self, tag: int) -> Optional[Tuple[int, int]]:
        """If ``tag`` heads any buffer (fixed index order), pop it and
        return ``(ready_cycle, buffer_index)``."""
        for bi in range(self.n):
            buf = self.entries[bi]
            if buf and buf[0][0] == tag:
                ready = buf.pop(0)[1]
                self.lru.remove(bi)
                self.lru.append(bi)
                return ready, bi
        return None

    def allocate(self, tag: int) -> int:
        """Restart the LRU buffer at ``tag + 1``; returns its index."""
        bi = self.lru.pop(0)
        self.lru.append(bi)
        self.entries[bi] = []
        self.next_tag[bi] = tag + 1
        return bi

    def state(self) -> Tuple:
        return (
            tuple(tuple(buf) for buf in self.entries),
            tuple(self.next_tag),
            tuple(self.lru),
        )

    def restore(self, state: Tuple) -> None:
        entries, next_tag, lru = state
        self.entries = [[(int(t), int(r)) for t, r in buf] for buf in entries]
        self.next_tag = [int(t) for t in next_tag]
        self.lru = [int(b) for b in lru]


#: Legal values for ``SimConfig.miss_mechanism`` / ``VMEMCache(miss_mechanism=)``.
MISS_MECHANISMS = ("none", "victim", "miss_cache", "stream_buffer", "victim+stream")


class MissPath:
    """Pluggable miss-path mechanism layer between a :class:`VMEMCache` miss
    and HBM (docs/DESIGN.md §5.10).

    Lookup order on a main-array + MSHR miss: victim cache, then miss cache,
    then stream buffers — each mechanism hit returns its own
    :class:`CacheDecision` outcome (VICTIM_HIT / MISS_CACHE_HIT /
    PREFETCH_HIT) and installs the line into the main array, so the per-
    stream stat lanes attribute exactly which structure saved the miss.
    Prefetch traffic is recorded through ``self.record`` (the executor wires
    it to its stat path) on the :data:`AccessType.PREFETCH` row, attributed
    to the demand stream that triggered it.
    """

    __slots__ = ("mechanism", "cache", "hit_latency", "victim", "miss_cache",
                 "buffers", "record")

    def __init__(
        self,
        mechanism: str,
        cache: "VMEMCache",
        *,
        victim_entries: int = 8,
        miss_cache_entries: int = 8,
        stream_buffers: int = 4,
        stream_buffer_depth: int = 4,
        hit_latency: int = 8,
    ) -> None:
        if mechanism not in MISS_MECHANISMS or mechanism == "none":
            raise ValueError(
                f"unknown miss_mechanism {mechanism!r}; "
                f"expected one of {MISS_MECHANISMS[1:]}"
            )
        self.mechanism = mechanism
        self.cache = cache
        self.hit_latency = int(hit_latency)
        self.victim = (
            _VictimCache(victim_entries) if mechanism in ("victim", "victim+stream") else None
        )
        self.miss_cache = _MissCache(miss_cache_entries) if mechanism == "miss_cache" else None
        self.buffers = (
            _StreamBufferSet(stream_buffers, stream_buffer_depth)
            if mechanism in ("stream_buffer", "victim+stream")
            else None
        )
        self.record = _no_record

    # -- the lookup pipeline -----------------------------------------------------
    def lookup(self, tag: int, is_write: bool, cycle: int, stream_id: int) -> Optional[CacheDecision]:
        """Try each mechanism in order; a hit installs the line into the
        main array and returns its decision, else None (full miss)."""
        cache = self.cache
        victim = self.victim
        if victim is not None:
            dirty = victim.take(tag)
            if dirty is not None:
                cache._install(tag, dirty or is_write, cycle)
                return CacheDecision(
                    AccessOutcome.VICTIM_HIT, ready_cycle=cycle + self.hit_latency
                )
        mc = self.miss_cache
        if mc is not None and mc.hit(tag):
            cache._install(tag, is_write, cycle)
            return CacheDecision(
                AccessOutcome.MISS_CACHE_HIT, ready_cycle=cycle + self.hit_latency
            )
        sb = self.buffers
        if sb is not None:
            head = sb.pop_head(tag)
            if head is not None:
                ready, bi = head
                cache._install(tag, is_write, cycle)
                self._prefetch(bi, cycle, stream_id)  # refill the popped slot
                floor = cycle + self.hit_latency
                return CacheDecision(
                    AccessOutcome.PREFETCH_HIT,
                    ready_cycle=ready if ready > floor else floor,
                )
        return None

    def on_miss(self, tag: int, cycle: int, stream_id: int) -> None:
        """A full miss went to HBM: fill the miss cache with the missed tag
        and (re)start a stream buffer prefetching the sequential tags."""
        if self.miss_cache is not None:
            self.miss_cache.fill(tag)
        sb = self.buffers
        if sb is not None:
            bi = sb.allocate(tag)
            self._prefetch(bi, cycle, stream_id, n=sb.depth)

    def on_evict(self, tag: int, dirty: bool) -> Tuple[bool, Optional[Tuple[int, bool]]]:
        """Offer a line evicted from the main array to the victim cache.

        Returns ``(absorbed, overflow)``: ``absorbed`` is True when the
        victim cache took the line (the caller suppresses its direct
        writeback); ``overflow`` is the (tag, dirty) entry that fell out of
        the victim cache, whose writeback the caller now owes."""
        if self.victim is None:
            return False, None
        return True, self.victim.insert(tag, dirty)

    def _prefetch(self, bi: int, cycle: int, stream_id: int, n: int = 1) -> None:
        """Issue up to ``n`` sequential prefetches into buffer ``bi``; each
        occupies HBM like a demand fetch and lands on the PREFETCH stat row.
        Prefetches are dropped (not queued) when the HBM queue is already
        past the stall horizon — demand traffic keeps priority."""
        cache = self.cache
        hbm = cache.hbm
        sb = self.buffers
        buf = sb.entries[bi]
        for _ in range(n):
            if len(buf) >= sb.depth:
                break
            if hbm.saturated(cycle, cache.bw_stall_horizon):
                break
            tag = sb.next_tag[bi]
            sb.next_tag[bi] = tag + 1
            done = hbm.occupy(cache.line_size, cycle)
            ready = cycle + cache.hbm_latency
            if done > ready:
                ready = done
            buf.append((tag, ready))
            self.record(AccessType.PREFETCH, AccessOutcome.MISS, stream_id, cycle, 1)

    # -- snapshot (compiled-trace participation) ----------------------------------
    def state(self) -> Tuple:
        """Immutable snapshot of every mechanism structure, in the same
        spirit as the MSHR/lines tuples in ``CompiledTrace.cache_state``."""
        return (
            self.victim.state() if self.victim is not None else None,
            self.miss_cache.state() if self.miss_cache is not None else None,
            self.buffers.state() if self.buffers is not None else None,
        )

    def restore(self, state: Tuple) -> None:
        vic, mc, sb = state
        if self.victim is not None and vic is not None:
            self.victim.restore(vic)
        if self.miss_cache is not None and mc is not None:
            self.miss_cache.restore(mc)
        if self.buffers is not None and sb is not None:
            self.buffers.restore(sb)

    def clear(self) -> None:
        if self.victim is not None:
            self.victim.lines.clear()
        if self.miss_cache is not None:
            self.miss_cache.tags.clear()
        if self.buffers is not None:
            sb = self.buffers
            sb.entries = [[] for _ in range(sb.n)]
            sb.next_tag = [0] * sb.n
            sb.lru = list(range(sb.n))


class VMEMCache:
    """Fully-associative LRU line cache with an MSHR merge table.

    Classification per line (Accel-Sim semantics):

    * resident                      → HIT
    * in MSHR (fetch in flight)     → HIT_RESERVED  (printed MSHR_HIT); the
      requesting stream is merged onto the entry — this is how concurrent
      streams convert each other's HITs into MSHR_HITs (paper §5.1).
    * MSHR full                     → RESERVATION_FAILURE / MSHR_ENTRY_FAIL
    * merge list full               → RESERVATION_FAILURE / MSHR_MERGE_FAIL
    * HBM queue too deep            → RESERVATION_FAILURE / BANDWIDTH_FAIL
    * otherwise                     → MISS, fetch scheduled on HBM

    Event-driven-friendly internals:

    * Residency is an :class:`~collections.OrderedDict` in LRU order
      (move-to-end on touch), so eviction is O(1) instead of a
      ``min()``-over-all-lines scan.  Tie-breaking among lines last touched
      in the same cycle follows touch order rather than the old scan's
      insertion order; the two only diverge when equal ``last_use`` values
      meet an eviction, and both engine paths share this implementation.
    * In-flight fetches additionally sit in a min-heap keyed by
      ``(ready_cycle, allocation_seq)``.  :meth:`tick` pops due entries in
      that order and installs each at **its own** ready cycle, which makes
      the call idempotent and safe to defer: a cycle-skipping caller that
      ticks once at cycle ``c`` performs exactly the installs (and dirty
      writebacks, at the same cycles) that a caller ticking every cycle up
      to ``c`` would have performed.
    """

    def __init__(
        self,
        capacity_bytes: int,
        line_size: int,
        hbm: Bandwidth,
        hbm_latency: int = 100,
        mshr_entries: int = 2048,
        mshr_max_merge: int = 8,
        bw_stall_horizon: int = 4096,
        miss_mechanism: str = "none",
        victim_entries: int = 8,
        miss_cache_entries: int = 8,
        stream_buffers: int = 4,
        stream_buffer_depth: int = 4,
        hit_latency: int = 8,
    ) -> None:
        self.line_size = int(line_size)
        self.n_lines = max(1, int(capacity_bytes // line_size))
        self.hbm = hbm
        self.hbm_latency = int(hbm_latency)
        self.mshr_entries = int(mshr_entries)
        self.mshr_max_merge = int(mshr_max_merge)
        self.bw_stall_horizon = int(bw_stall_horizon)
        if miss_mechanism == "none":
            self.miss_path: Optional[MissPath] = None
        else:
            self.miss_path = MissPath(
                miss_mechanism,
                self,
                victim_entries=victim_entries,
                miss_cache_entries=miss_cache_entries,
                stream_buffers=stream_buffers,
                stream_buffer_depth=stream_buffer_depth,
                hit_latency=hit_latency,
            )
        self._lines: "OrderedDict[int, _Line]" = OrderedDict()  # tag -> line, LRU order
        #: lazily-built sorted array of resident tags, for the vectorized
        #: batched tag probe; None whenever membership may have changed
        #: (install/evict/flush — LRU reordering keeps membership intact).
        self._tag_snapshot = None
        #: tag -> (ready_cycle, merge list in arrival order).  Responses drain
        #: to merged consumers on consecutive cycles (position in the list),
        #: which also desynchronizes previously-merged streams — matching the
        #: paper's §5.1 observation that clean == Σ tip for l2_lat (no
        #: same-cycle stat collisions once streams are staggered).
        self._mshr: Dict[int, Tuple[int, List[int]]] = {}
        #: (ready_cycle, allocation_seq, tag) — lazy-deletion min-heap over
        #: the in-flight fetches; stale entries (flushed, or superseded by a
        #: later re-fetch of the same tag) are skipped on pop.
        self._mshr_heap: List[Tuple[int, int, int]] = []
        self._mshr_seq = itertools.count()
        self._writebacks = 0

    # -- per-cycle maintenance ---------------------------------------------------
    def tick(self, cycle: int) -> None:
        """Promote every fetch due by ``cycle`` to residency.

        Due entries are processed in ``(ready_cycle, allocation order)`` —
        the same order a per-cycle caller would observe — and each install
        happens at the entry's own ready cycle, so deferred calls are
        state-identical to per-cycle calls (see class docstring).
        """
        heap = self._mshr_heap
        mshr = self._mshr
        while heap and heap[0][0] <= cycle:
            rc, _, tag = heapq.heappop(heap)
            ent = mshr.get(tag)
            if ent is None or ent[0] != rc:
                continue  # stale heap entry (flushed or re-fetched)
            del mshr[tag]
            self._install(tag, dirty=False, cycle=rc)

    def earliest_ready(self) -> Optional[int]:
        """Ready cycle of the earliest in-flight fetch, or None."""
        heap = self._mshr_heap
        mshr = self._mshr
        while heap:
            rc, _, tag = heap[0]
            ent = mshr.get(tag)
            if ent is not None and ent[0] == rc:
                return rc
            heapq.heappop(heap)
        return None

    def _install(self, tag: int, dirty: bool, cycle: int) -> None:
        lines = self._lines
        line = lines.get(tag)
        if line is not None:
            line.dirty = line.dirty or dirty
            line.last_use = cycle
            lines.move_to_end(tag)
            return
        if len(lines) >= self.n_lines:
            # LRU evict (front of the ordered dict); dirty lines cost a
            # writeback (VMEM_WRBK row) — unless a victim cache absorbs the
            # line, in which case the writeback is deferred until the entry
            # overflows out of the victim cache in turn.
            vtag, victim = lines.popitem(last=False)
            self._tag_snapshot = None
            mp = self.miss_path
            absorbed, overflow = mp.on_evict(vtag, victim.dirty) if mp is not None else (False, None)
            if absorbed:
                if overflow is not None and overflow[1]:
                    self._writebacks += 1
                    self.hbm.occupy(self.line_size, cycle, is_write=True)
            elif victim.dirty:
                self._writebacks += 1
                self.hbm.occupy(self.line_size, cycle, is_write=True)
        lines[tag] = _Line(tag, dirty, cycle)
        self._tag_snapshot = None

    # -- the access path -----------------------------------------------------------
    def access_line(self, tag: int, is_write: bool, cycle: int, stream_id: int) -> CacheDecision:
        lines = self._lines
        line = lines.get(tag)
        if line is not None:
            line.last_use = cycle
            if is_write:
                line.dirty = True
            lines.move_to_end(tag)
            return _HIT

        inflight = self._mshr.get(tag)
        if inflight is not None:
            ready_cycle, streams = inflight
            if stream_id in streams:
                position = streams.index(stream_id)
            else:
                if len(streams) >= self.mshr_max_merge:
                    return _FAIL_MSHR_MERGE
                streams.append(stream_id)
                position = len(streams) - 1
            return CacheDecision(AccessOutcome.HIT_RESERVED, ready_cycle=ready_cycle + position)

        mp = self.miss_path
        if mp is not None:
            decision = mp.lookup(tag, is_write, cycle, stream_id)
            if decision is not None:
                return decision

        if len(self._mshr) >= self.mshr_entries:
            return _FAIL_MSHR_ENTRY
        if self.hbm.saturated(cycle, self.bw_stall_horizon):
            return _FAIL_BANDWIDTH

        done = self.hbm.occupy(self.line_size, cycle)
        ready_cycle = max(cycle + self.hbm_latency, done)
        self._mshr[tag] = (ready_cycle, [stream_id])  # write-allocate either way
        heapq.heappush(self._mshr_heap, (ready_cycle, next(self._mshr_seq), tag))
        if mp is not None:
            mp.on_miss(tag, cycle, stream_id)
        return CacheDecision(AccessOutcome.MISS, ready_cycle=ready_cycle)

    # -- introspection ----------------------------------------------------------
    @property
    def writebacks(self) -> int:
        return self._writebacks

    def resident(self, tag: int) -> bool:
        return tag in self._lines

    def resident_tags_sorted(self) -> np.ndarray:
        """Sorted array of resident line tags, cached until the next
        membership change (install, evict, or flush)."""
        snap = self._tag_snapshot
        if snap is None:
            snap = np.fromiter(
                self._lines.keys(), dtype=np.int64, count=len(self._lines)
            )
            snap.sort()
            self._tag_snapshot = snap
        return snap

    def resident_mask(self, tags: np.ndarray, ops) -> np.ndarray:
        """Vectorized residency probe: ``tags[i] in self._lines`` for every
        element, through the array-ops backend's sorted-membership kernel."""
        return ops.sorted_membership(tags, self.resident_tags_sorted())

    def in_flight(self, tag: int) -> bool:
        return tag in self._mshr

    def flush(self) -> None:
        self._lines.clear()
        self._tag_snapshot = None
        self._mshr.clear()
        self._mshr_heap.clear()
        if self.miss_path is not None:
            self.miss_path.clear()

    # -- miss-path snapshot hooks (compiled engine) -----------------------------
    def mech_state(self) -> Optional[Tuple]:
        """Miss-path mechanism snapshot for :class:`CompiledTrace`, or None
        when ``miss_mechanism == "none"``."""
        return self.miss_path.state() if self.miss_path is not None else None

    def mech_restore(self, state: Optional[Tuple]) -> None:
        if state is not None and self.miss_path is not None:
            self.miss_path.restore(state)
