"""The paper's validation microbenchmarks as simulator workloads (§5).

* :func:`l2_lat_multistream` — §5.1: one pointer-chasing kernel replicated on
  N streams, all walking the *same* array (the CUDA source passes the same
  ``posArray_g`` to every launch).  Deterministic access counts; cross-stream
  in-flight merges turn would-be HITs into MSHR_HITs under concurrency.
* :func:`mixed_stream_workload` — §5.2: ``saxpy``/``scale``/``add`` kernels
  with the dependency pattern of ``benchmark_1_stream.cu`` /
  ``benchmark_3_stream.cu`` (kernel 2 depends on kernel 1; kernel 3
  independent on its own stream; kernel 4 depends on kernel 2).
* :func:`deepbench_like_workload` — §5.3: large GEMM kernels with DeepBench
  ``inference_half_35_1500_2560`` shapes, optionally replaced by descriptors
  derived from real compiled HLO (see :mod:`repro.sim.hlo_costs`).

Expected-count helpers return closed-form access counts so tests can assert
exact per-stream numbers, as the paper does ("The total read and write access
counts for each of the four streams are consistent and exactly met our
expected counts").

All three workloads are registered in the scenario library
(:mod:`repro.sim.scenarios`) as ``l2_lat`` / ``mixed_stream`` /
``deepbench``.  :func:`l2_lat_multistream` and :func:`mixed_stream_workload`
are thin wrappers over ``build(name, ...).run(...)``;
:func:`deepbench_like_workload` keeps a direct simulator path because its
``kernels=`` kwarg accepts arbitrary (e.g. compiled-HLO-derived)
descriptors the registry builder does not model — only the default GEMM
shapes (``_deepbench_descs``) are shared with the registered scenario.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.stats import AccessType

from .executor import SimConfig, SimResult, TPUSimulator
from .kernel_desc import (
    Access,
    KernelDesc,
    LINE_SIZE,
    pointer_chase_trace,
    streaming_trace,
)
from .scenarios import (
    Launch,
    build,
    mech_invariant_oracle,
    mech_totals_only_oracle,
    register_mech_oracle,
    scenario,
)

__all__ = [
    "l2_lat_multistream",
    "l2_lat_expected_counts",
    "mixed_stream_workload",
    "deepbench_like_workload",
]

#: Float32 element size used by the saxpy-family kernels.
F32 = 4

#: wrappers that already warned this process (one DeprecationWarning each —
#: the legacy entry points are loops' inner calls in old scripts; warn once,
#: not per invocation).  Cleared by tests via ``_reset_deprecations()``.
_DEPRECATION_WARNED: set = set()


def _warn_deprecated(fn_name: str, replacement: str) -> None:
    """Single-shot deprecation notice for a legacy wrapper.  The wrapper
    stays bit-identical to the replacement (asserted by
    ``tests/test_api_surface.py``) until removal at the next major version
    — see the policy in ``repro/api.py`` / ``docs/API.md``."""
    if fn_name in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(fn_name)
    warnings.warn(
        f"repro.sim.microbench.{fn_name} is deprecated; use {replacement} "
        "(bit-identical results) — the wrapper will be removed in the next "
        "major version",
        DeprecationWarning,
        stacklevel=3,
    )


def _reset_deprecations() -> None:
    """Test hook: re-arm the single-shot deprecation warnings."""
    _DEPRECATION_WARNED.clear()


# --------------------------------------------------------------------------- §5.1
@scenario("l2_lat", space={"n_streams": (2, 3, 4, 6), "n_loads": (32, 64, 128, 256),
                           "serialize": (False, True)})
def _l2_lat_scenario(n_streams=4, n_loads=64, serialize=False):
    """§5.1 pointer-chase: N streams walk the *same* array concurrently.

    Oracle (hbm_latency >> the 1-cycle launch stagger, so the streams stay
    staggered by exactly one cycle all the way through the chase):

    * concurrent — the first-launched stream first-touches every line
      (MISS); each trailing stream reaches it while the fetch is in flight
      (MSHR_HIT); all other loads land on resident lines (HIT).
    * serialized — stream 1 faults every line in; later streams run alone
      against a now-resident array (all HIT; capacity far exceeds the walk).
    """
    base = 1 << 20  # posArray_g
    launches = [
        Launch(f"stream_{i+1}",
               KernelDesc(name="l2_lat", trace=pointer_chase_trace(base, n_loads),
                          dependent=True))
        for i in range(n_streams)
    ]
    n_lines = (8 * n_loads + LINE_SIZE - 1) // LINE_SIZE
    expected = {
        "stream_1": {"HIT": n_loads - n_lines, "MSHR_HIT": 0, "MISS": n_lines,
                     "RES_FAIL": 0, "TOTAL": n_loads}
    }
    for i in range(2, n_streams + 1):
        if serialize:
            expected[f"stream_{i}"] = {"HIT": n_loads, "MSHR_HIT": 0, "MISS": 0,
                                       "RES_FAIL": 0, "TOTAL": n_loads}
        else:
            expected[f"stream_{i}"] = {"HIT": n_loads - n_lines, "MSHR_HIT": n_lines,
                                       "MISS": 0, "RES_FAIL": 0, "TOTAL": n_loads}
    config = {"serialize_streams": True} if serialize else {}
    return launches, expected, config


def l2_lat_multistream(
    n_streams: int = 4,
    n_loads: int = 64,
    *,
    serialize: bool = False,
    concurrent: bool = True,
    config: Optional[SimConfig] = None,
    engine: Optional[str] = None,
) -> SimResult:
    """``l2_lat.cu`` modified for N concurrent streams (paper §5.1).

    Every stream runs an identical dependent-load (pointer-chase) kernel over
    the **same** array, exactly like the paper's four ``l2_lat<<<1,1,0,
    stream_k>>>(..., posArray_g, ...)`` launches.  Thin wrapper over the
    registered ``l2_lat`` scenario.

    .. deprecated:: 1.1
       Use ``repro.api.simulate("l2_lat", n_streams=..., n_loads=...,
       serialize=...)`` — bit-identical results, plus the StatsFrame query
       layer on the returned run.
    """
    _warn_deprecated("l2_lat_multistream", 'repro.api.simulate("l2_lat", ...)')
    cfg = config or SimConfig()
    cfg.serialize_streams = serialize
    cfg.concurrent_streams = concurrent
    inst = build("l2_lat", n_streams=n_streams, n_loads=n_loads, serialize=serialize)
    return inst.run(engine=engine, config=cfg)


def l2_lat_expected_counts(n_streams: int, n_loads: int, line_size: int = LINE_SIZE) -> Dict[str, int]:
    """Closed-form expected counts for :func:`l2_lat_multistream`.

    With 8-byte sequential loads, the walk touches ``ceil(8*n_loads/line)``
    distinct lines.  Under concurrency, the first stream to touch each line
    MISSes; the remaining ``n_streams-1`` streams reach it while the fetch is
    still in flight (HBM latency ≫ launch stagger) → MSHR_HIT; every other
    load is a HIT.  Totals (= what the *clean* build should report, and what
    the tip build's per-stream counts must sum to):
    """
    n_lines = (8 * n_loads + line_size - 1) // line_size
    total = n_streams * n_loads
    return {
        "MISS": n_lines,
        "MSHR_HIT": (n_streams - 1) * n_lines,
        "HIT": total - n_lines - (n_streams - 1) * n_lines,
        "TOTAL": total,
    }


# --------------------------------------------------------------------------- §5.2
@dataclass(frozen=True)
class _MixedShapes:
    """Problem size of benchmark_{1,3}_stream.cu: N = 1<<18 floats."""

    n: int = 1 << 18

    @property
    def vec_bytes(self) -> int:
        return self.n * F32


def _saxpy_desc(name: str, shapes: _MixedShapes, x_base: int, y_base: int) -> KernelDesc:
    # y[i] = a*x[i] + y[i]  → read x, read y, write y; 2 flops/elem.
    trace = (
        streaming_trace(x_base, shapes.vec_bytes, AccessType.GLOBAL_ACC_R)
        + streaming_trace(y_base, shapes.vec_bytes, AccessType.GLOBAL_ACC_R)
        + streaming_trace(y_base, shapes.vec_bytes, AccessType.GLOBAL_ACC_W)
    )
    return KernelDesc(name=name, trace=trace, flops=2.0 * shapes.n, issue_width=4)


def _scale_desc(name: str, shapes: _MixedShapes, a_base: int) -> KernelDesc:
    # a[i] = s*a[i] → read a, write a; 1 flop/elem.
    trace = streaming_trace(a_base, shapes.vec_bytes, AccessType.GLOBAL_ACC_R) + streaming_trace(
        a_base, shapes.vec_bytes, AccessType.GLOBAL_ACC_W
    )
    return KernelDesc(name=name, trace=trace, flops=1.0 * shapes.n, issue_width=4)


def _add_desc(name: str, shapes: _MixedShapes, a_base: int, b_base: int) -> KernelDesc:
    # b[i] = (i<n/2) ? a[i]+b[i] : 2*b[i] → reads a (half), b; writes b.
    trace = (
        streaming_trace(a_base, shapes.vec_bytes // 2, AccessType.GLOBAL_ACC_R)
        + streaming_trace(b_base, shapes.vec_bytes, AccessType.GLOBAL_ACC_R)
        + streaming_trace(b_base, shapes.vec_bytes, AccessType.GLOBAL_ACC_W)
    )
    return KernelDesc(name=name, trace=trace, flops=1.0 * shapes.n, issue_width=4)


@scenario("mixed_stream", space={"n_streams": (1, 2, 3), "n": (1 << 12, 1 << 13, 1 << 14),
                                 "serialize": (False, True)})
def _mixed_stream_scenario(n_streams=3, n=1 << 14, serialize=False):
    """§5.2 mixed kernels (benchmark_{1,3}_stream.cu dependency structure).

    Oracle: per-stream TOTALs only — arrays overlap across streams (``x`` is
    read by k1 and every k3), so the HIT/MSHR_HIT/MISS split is
    timing-dependent (golden-pinned in the conformance suite), but every
    trace access eventually lands exactly once per touched line:

    * default stream: k1 (3·L) + k2 (2·L) + k4 (L/2 + 2·L)  [L = vector lines]
    * each side stream: one saxpy, 3·L.

    ``n`` is kept a multiple of 128 so every streaming trace is whole-line.
    No reservation failures are reachable at these sizes (the HBM queue never
    builds past ``bw_stall_horizon``), so RES_FAIL is asserted 0.
    """
    shapes = _MixedShapes(n)
    mb = shapes.vec_bytes + (1 << 12)  # distinct arrays, page-aligned-ish
    d_x, d_y, d_z, d_a = (1 * mb, 2 * mb, 3 * mb, 4 * mb)
    launches = [
        Launch("", _saxpy_desc("saxpy_k1", shapes, d_x, d_y)),
        Launch("", _scale_desc("scale_k2", shapes, d_y)),
    ]
    for i in range(max(1, n_streams)):
        launches.append(
            Launch(f"stream_{i+1}", _saxpy_desc(f"saxpy_k3_{i}", shapes, d_x, d_z + i * mb))
        )
    launches.append(Launch("", _add_desc("add_k4", shapes, d_y, d_a)))
    L = shapes.vec_bytes // LINE_SIZE
    expected = {"": {"TOTAL": 3 * L + 2 * L + (L // 2 + 2 * L), "RES_FAIL": 0}}
    for i in range(max(1, n_streams)):
        expected[f"stream_{i+1}"] = {"TOTAL": 3 * L, "RES_FAIL": 0}
    config = {"serialize_streams": True} if serialize else {}
    return launches, expected, config


def mixed_stream_workload(
    n_streams: int = 3,
    *,
    n: int = 1 << 18,
    serialize: bool = False,
    config: Optional[SimConfig] = None,
    engine: Optional[str] = None,
) -> SimResult:
    """benchmark_1_stream.cu (n_streams=1 extra stream) / benchmark_3_stream.cu
    (n_streams=3) from §5.2.

    Dependency structure from the CUDA source:
      * kernel 1 (saxpy, default stream)
      * kernel 2 (scale, default stream) — depends on kernel 1 (stream FIFO)
      * kernel 3 (saxpy) — independent, on ``stream_1`` (or spread over the
        extra streams when ``n_streams > 1``)
      * kernel 4 (add, default stream) — depends on kernel 2 (stream FIFO)

    Thin wrapper over the registered ``mixed_stream`` scenario.

    .. deprecated:: 1.1
       Use ``repro.api.simulate("mixed_stream", n_streams=..., n=...,
       serialize=...)`` — bit-identical results.
    """
    _warn_deprecated("mixed_stream_workload", 'repro.api.simulate("mixed_stream", ...)')
    cfg = config or SimConfig()
    cfg.serialize_streams = serialize
    inst = build("mixed_stream", n_streams=n_streams, n=n, serialize=serialize)
    return inst.run(engine=engine, config=cfg)


# --------------------------------------------------------------------------- §5.3
def _deepbench_descs(repeats: int) -> List[KernelDesc]:
    m, n, k = 35, 1500, 2560
    bytes_a, bytes_b, bytes_c = 2 * m * k, 2 * k * n, 2 * m * n
    return [
        KernelDesc(
            name=f"gemm_{m}x{n}x{k}",
            flops=2.0 * m * n * k,
            hbm_rd_bytes=bytes_a + bytes_b,
            hbm_wr_bytes=bytes_c,
            addr_base=(i + 1) << 26,
        )
        for i in range(repeats)
    ]


@scenario("deepbench", space={"n_streams": (2, 3), "repeats": (2, 4, 6)})
def _deepbench_scenario(n_streams=2, repeats=4):
    """§5.3 DeepBench ``inference_half_35_1500_2560`` GEMMs, round-robined
    over request streams.

    Oracle: synthesized-cost kernels bypass residency (every beat is a MISS),
    so each request stream's count is the exact line sum of the kernels that
    round-robin onto it — scheduling never changes it.
    """
    launches = []
    totals: Dict[str, int] = {}
    for i, kd in enumerate(_deepbench_descs(repeats)):
        stream = f"req_{i % n_streams}"
        launches.append(Launch(stream, kd))
        rd, wr, ici = kd.synthesized_lines()
        totals[stream] = totals.get(stream, 0) + rd + wr + ici
    expected = {
        s: {"HIT": 0, "MSHR_HIT": 0, "MISS": t, "RES_FAIL": 0, "TOTAL": t}
        for s, t in totals.items()
    }
    return launches, expected


def deepbench_like_workload(
    kernels: Optional[Sequence[KernelDesc]] = None,
    n_streams: int = 2,
    repeats: int = 4,
    *,
    serialize: bool = False,
    config: Optional[SimConfig] = None,
    engine: Optional[str] = None,
) -> SimResult:
    """DeepBench ``inference_half_35_1500_2560`` analog (§5.3).

    Default kernels are half-precision GEMMs with DeepBench's inference
    shape (m=35, n=1500... the trace's K/N/batch family 35×1500×2560) —
    or pass descriptors derived from real compiled HLO
    (:func:`repro.sim.hlo_costs.kernels_from_compiled`).

    .. deprecated:: 1.1
       The default-kernel path is ``repro.api.simulate("deepbench",
       n_streams=..., repeats=...)`` (bit-identical).  Only the explicit
       ``kernels=`` form (arbitrary/compiled-HLO descriptors the registry
       does not model) stays un-deprecated.
    """
    if kernels is None:
        _warn_deprecated("deepbench_like_workload", 'repro.api.simulate("deepbench", ...)')
    cfg = config or SimConfig()
    cfg.serialize_streams = serialize
    if engine is not None:
        cfg.engine = engine
    sim = TPUSimulator(cfg)
    if kernels is None:
        kernels = _deepbench_descs(repeats)
    streams = [sim.create_stream(f"req_{i}") for i in range(n_streams)]
    for i, kd in enumerate(kernels):
        # Round-robin kernels over request streams, fresh uid per launch.
        kd_i = KernelDesc(
            name=kd.name,
            flops=kd.flops,
            trace=list(kd.trace) if kd.trace else None,
            hbm_rd_bytes=kd.hbm_rd_bytes,
            hbm_wr_bytes=kd.hbm_wr_bytes,
            ici_bytes=kd.ici_bytes,
            addr_base=kd.addr_base or ((i + 1) << 26),
            dependent=kd.dependent,
            issue_width=kd.issue_width,
        )
        sim.launch(streams[i % n_streams].stream_id, kd_i)
    return sim.run()


# Mechanism-aware oracles (docs/DESIGN.md §5.10): l2_lat and mixed_stream
# are explicit-trace workloads whose hit/miss split depends on the miss-path
# mechanism (a stream buffer turns sequential-line misses into prefetch
# hits), but their per-stream TOTALs are conserved; deepbench is purely
# synthesized, so every mechanism is provably inert.
register_mech_oracle("l2_lat", mech_totals_only_oracle)
register_mech_oracle("mixed_stream", mech_totals_only_oracle)
register_mech_oracle("deepbench", mech_invariant_oracle)
