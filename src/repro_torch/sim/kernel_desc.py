"""Kernel descriptors for the discrete-event TPU simulator.

A :class:`KernelDesc` is what GPGPU-Sim's ``kernel_info_t`` becomes here: a
unit of stream work with either

* an **explicit access trace** (microbenchmarks — deterministic, exact
  counts, the paper's §5.1/§5.2 validation path), or
* **aggregate costs** (FLOPs + HBM/ICI bytes — the §5.3 "DeepBench" path,
  where descriptors are derived from real compiled HLO via
  :mod:`repro.sim.hlo_costs`), which the executor expands into synthesized
  streaming accesses at line granularity.

Every access event carries the stream id of its kernel — the paper's
``mem_fetch``/``warp_inst_t`` streamID propagation.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.stats import AccessType

__all__ = ["Access", "KernelDesc", "LINE_SIZE"]

#: TPU HBM transaction granularity we model (bytes).  GPU sectors are 32B /
#: lines 128B; TPU DMA bursts are larger — we use 512B lines throughout.
LINE_SIZE = 512


@dataclass(frozen=True)
class Access:
    """One memory access (``mem_fetch`` analog). ``addr`` is a byte address."""

    atype: AccessType
    addr: int
    size: int = 8

    def lines(self, line_size: int = LINE_SIZE) -> range:
        lo = self.addr // line_size
        hi = (self.addr + max(self.size, 1) - 1) // line_size
        return range(lo, hi + 1)


_uid_counter = itertools.count(1)


@dataclass
class KernelDesc:
    """A simulated kernel.

    Exactly one of (``trace``) or (``hbm_rd_bytes``/``hbm_wr_bytes``/
    ``ici_bytes``/``flops``) should describe the kernel's work; both may be
    combined (trace plus compute time).

    ``dependent=True`` models pointer-chasing: at most one outstanding
    access, the next one issues only once the previous line is resident
    (the paper's ``l2_lat`` latency microbenchmark).
    """

    name: str
    flops: float = 0.0
    trace: Optional[List[Access]] = None
    hbm_rd_bytes: int = 0
    hbm_wr_bytes: int = 0
    ici_bytes: int = 0
    addr_base: int = 0  # base address for synthesized streaming accesses
    dependent: bool = False
    issue_width: int = 4  # accesses issued per cycle (independent-access kernels)
    #: owning device in a multi-chip topology (ignored when topology is off).
    device: int = 0
    #: explicit inter-chip route for ``ici_bytes`` — a tuple of device ids
    #: (hop endpoints) starting at ``device``.  Empty = topology-routed to
    #: the neighbour (single-device: the legacy single-link ICI model).
    ici_route: Tuple[int, ...] = ()
    uid: int = field(default_factory=lambda: next(_uid_counter))
    #: derived per-access columns for the event engine's hit-chain batching,
    #: cached here so repeated simulations of one descriptor skip the trace
    #: walk (keyed by line size; invalid if ``trace`` is mutated after use).
    ff_cache: Optional[Tuple] = field(default=None, repr=False, compare=False)
    #: memoized :meth:`structural_key` (invalid if ``trace`` is mutated).
    _skey: Optional[Tuple] = field(default=None, repr=False, compare=False)

    def total_trace_accesses(self) -> int:
        return len(self.trace) if self.trace else 0

    def structural_key(self) -> Tuple:
        """Everything that determines this kernel's simulated behaviour —
        and nothing run-varying (``uid`` is excluded; two descriptors with
        equal keys simulate identically modulo uid digits, which
        ``SimResult.signature()`` already normalizes).  The trace collapses
        to a sha256 digest over its packed ``(atype, addr, size)`` rows:
        Python tuples do not cache their hash, so keeping the raw trace in
        the key would re-hash thousands of rows on every trace-cache lookup.
        Memoized: scenario instances reuse descriptors across runs, so the
        trace walk is paid once."""
        if self._skey is None:
            if self.trace is None:
                trace_digest = None
            else:
                import hashlib

                rows = np.asarray(
                    [(int(a.atype), a.addr, a.size) for a in self.trace],
                    dtype=np.int64,
                ).reshape(len(self.trace), 3)
                trace_digest = (
                    len(self.trace),
                    hashlib.sha256(rows.tobytes()).hexdigest(),
                )
            self._skey = (
                self.name, self.flops, trace_digest, self.hbm_rd_bytes,
                self.hbm_wr_bytes, self.ici_bytes, self.addr_base,
                self.dependent, self.issue_width, self.device,
                tuple(self.ici_route),
            )
        return self._skey

    def synthesized_lines(self, line_size: int = LINE_SIZE) -> Tuple[int, int, int]:
        """(#read lines, #write lines, #ici lines) for aggregate-cost kernels."""
        rd = (self.hbm_rd_bytes + line_size - 1) // line_size
        wr = (self.hbm_wr_bytes + line_size - 1) // line_size
        ici = (self.ici_bytes + line_size - 1) // line_size
        return rd, wr, ici


def pointer_chase_trace(
    base_addr: int, n_loads: int, load_size: int = 8, stride: Optional[int] = None
) -> List[Access]:
    """Dependent-load trace over a pointer-chasing array (``l2_lat`` analog).

    The paper's microbenchmark walks ``posArray`` with ``ld.global.cg``
    (L1-bypassed, L2-cached) dependent loads; here every load is 8 bytes and
    consecutive (stride defaults to ``load_size``), so the number of distinct
    512B lines — and hence MISS/HIT/MSHR_HIT counts — is exact and known.
    """
    stride = load_size if stride is None else stride
    return [
        Access(AccessType.GLOBAL_ACC_R, base_addr + i * stride, load_size)
        for i in range(n_loads)
    ]


def streaming_trace(
    base_addr: int,
    n_bytes: int,
    atype: AccessType,
    access_size: int = LINE_SIZE,
) -> List[Access]:
    """Sequential streaming accesses (saxpy-style) over ``n_bytes``."""
    n = (n_bytes + access_size - 1) // access_size
    return [Access(atype, base_addr + i * access_size, access_size) for i in range(n)]
