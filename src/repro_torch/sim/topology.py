"""Multi-chip device topology: mesh/ring device graphs with per-device
resources and contended inter-chip links (docs/DESIGN.md §5.14).

The paper's complaint — combined stats across concurrent streams mislead —
gets one level worse on multi-accelerator systems, where stats additionally
blend across *devices* (MGSim/MGMark, arXiv 1811.02884).  This module is the
device axis: a :class:`DeviceTopology` gives every chip its own VMEMCache +
HBM :class:`~repro.sim.resources.Bandwidth` ledger and models inter-chip
traffic as hop-by-hop routed transfers over per-link byte-accounted
:class:`~repro.sim.resources.Bandwidth` resources.

Shapes reuse the launch layer's axis vocabulary (``("pod","data","model")``)
through the jax-free :mod:`repro.launch.mesh_shapes` helper — a simulated
``(2, 2)`` topology and a real ``jax.Mesh`` of the same shape name their
axes identically.  Devices are numbered in row-major (C) order over the
shape; links connect devices adjacent along one axis, with optional ring
wraparound per axis (``wrap=True``, sizes > 2).

Routing is deterministic dimension-ordered: a transfer from ``src`` to
``dst`` corrects one axis at a time (outermost first), moving around each
axis ring in the shorter direction (ties break toward increasing
coordinate).  A multi-hop transfer occupies every link on its route
store-and-forward — hop ``i+1`` starts when hop ``i`` completes — so link
contention composes hop by hop, and every hop records an
:data:`~repro.core.stats.AccessType.ICI_HOP` stat event on the sending
stream.  Conservation is exact by construction: the bytes injected at the
route head equal the bytes accounted on every link of the route
(:func:`expected_link_bytes` / :meth:`DeviceTopology.check_conservation`).

Collective-traffic builders (:func:`all_reduce_ring`, :func:`all_reduce_tree`,
:func:`all_to_all`, :func:`pipeline_send`) return plain
:class:`~repro.sim.kernel_desc.KernelDesc` rows — collectives are first-class
simulator kernels, executed by :mod:`repro.sim.executor` like any other work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..launch.mesh_shapes import MESH_AXES, validate_shape

from .kernel_desc import KernelDesc, LINE_SIZE
from .resources import Bandwidth

__all__ = [
    "DeviceTopology",
    "all_reduce_ring",
    "all_reduce_tree",
    "all_to_all",
    "pipeline_send",
    "expected_link_bytes",
]


class DeviceTopology:
    """A mesh/ring of simulated devices with per-link byte ledgers.

    Pure structure + link state: per-device HBM/VMEMCache resources are
    *attached* by the owner (:class:`repro.sim.executor.TPUSimulator`
    attaches its own device-0 resources so a single-device topology shares
    state with the legacy single-chip model bit-for-bit).
    """

    def __init__(
        self,
        shape: Sequence[int],
        *,
        wrap: bool = True,
        link_bytes_per_cycle: float,
    ) -> None:
        self.shape: Tuple[int, ...] = validate_shape(tuple(shape))
        self.axes: Tuple[str, ...] = MESH_AXES[len(self.shape)]
        self.wrap = bool(wrap)
        self.link_bytes_per_cycle = float(link_bytes_per_cycle)
        self.n_devices = 1
        for s in self.shape:
            self.n_devices *= s
        # row-major strides for coords <-> device id
        self._strides: Tuple[int, ...] = tuple(
            self._stride(i) for i in range(len(self.shape))
        )
        #: directed link -> Bandwidth ledger, in sorted (src, dst) order
        self.links: Dict[Tuple[int, int], Bandwidth] = {}
        for src, dst in self._edges():
            self.links[(src, dst)] = Bandwidth(self.link_bytes_per_cycle)
        #: per-device resources; attached by the executor (index = device id)
        self.hbms: List[Bandwidth] = []
        self.caches: List = []

    def _stride(self, i: int) -> int:
        s = 1
        for d in self.shape[i + 1:]:
            s *= d
        return s

    def _edges(self) -> List[Tuple[int, int]]:
        """Every directed link, sorted: axis-adjacent pairs, plus the ring
        wraparound per axis when ``wrap`` and the axis size exceeds 2 (at
        size 2 the wrap link would duplicate the existing pair)."""
        edges = set()
        for d in range(self.n_devices):
            c = self.coords(d)
            for ax, size in enumerate(self.shape):
                if size < 2:
                    continue
                for step in (-1, 1):
                    nc = c[ax] + step
                    if 0 <= nc < size:
                        pass
                    elif self.wrap and size > 2:
                        nc %= size
                    else:
                        continue
                    edges.add((d, self.device_at(c[:ax] + (nc,) + c[ax + 1:])))
        return sorted(edges)

    # -- coordinates ------------------------------------------------------------------
    def coords(self, device: int) -> Tuple[int, ...]:
        if not 0 <= device < self.n_devices:
            raise ValueError(f"device {device} outside topology of {self.n_devices}")
        out = []
        for stride, size in zip(self._strides, self.shape):
            out.append((device // stride) % size)
        return tuple(out)

    def device_at(self, coords: Sequence[int]) -> int:
        return sum(int(c) * s for c, s in zip(coords, self._strides))

    def neighbors(self, device: int) -> Tuple[int, ...]:
        return tuple(dst for (src, dst) in self.links if src == device)

    def next_device(self, device: int) -> int:
        """Ring successor in flattened order — the default destination for
        un-routed ICI traffic (the single-link legacy model's analog)."""
        return (device + 1) % self.n_devices

    # -- routing ----------------------------------------------------------------------
    def route(self, src: int, dst: int) -> Tuple[int, ...]:
        """Dimension-ordered device path from ``src`` to ``dst`` (inclusive).

        Per axis (outermost first) the path walks the axis ring one step at
        a time in the shorter direction (ties toward +1); without ``wrap``
        (or at axis size ≤ 2) it walks monotonically.  Deterministic — the
        same (src, dst) always routes identically, which is what makes the
        per-hop stat lanes and the compiled trace replayable."""
        c = list(self.coords(src))
        target = self.coords(dst)
        path = [src]
        for ax, size in enumerate(self.shape):
            while c[ax] != target[ax]:
                delta = target[ax] - c[ax]
                if self.wrap and size > 2:
                    fwd = delta % size
                    back = (-delta) % size
                    step = 1 if fwd <= back else -1
                else:
                    step = 1 if delta > 0 else -1
                c[ax] = (c[ax] + step) % size
                path.append(self.device_at(c))
        return tuple(path)

    def expand_route(self, waypoints: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
        """Resolve a waypoint sequence (e.g. ``KernelDesc.ici_route``) to
        link hops: consecutive waypoints are connected by :meth:`route`, so
        callers may name just endpoints without knowing mesh adjacency."""
        pts = [int(w) for w in waypoints]
        hops: List[Tuple[int, int]] = []
        for a, b in zip(pts, pts[1:]):
            seg = self.route(a, b)
            hops.extend(zip(seg, seg[1:]))
        return tuple(hops)

    def hops_for(self, desc: KernelDesc) -> Tuple[Tuple[int, int], ...]:
        """The link hops a kernel's ICI traffic traverses: its explicit
        ``ici_route`` when set, else the default ring-successor route from
        its device (empty on a single-device topology)."""
        if desc.ici_route:
            return self.expand_route(desc.ici_route)
        if self.n_devices <= 1:
            return ()
        return self.expand_route((desc.device, self.next_device(desc.device)))

    # -- ledgers ----------------------------------------------------------------------
    def link_bytes(self) -> Dict[Tuple[int, int], int]:
        """Per-link total bytes carried so far (the conservation ledger)."""
        return {lk: bw.total_bytes for lk, bw in self.links.items()}

    def check_conservation(
        self, descs: Sequence[KernelDesc], line_size: int = LINE_SIZE
    ) -> Dict[str, object]:
        """Bytes-injected == bytes-delivered per link: compare every link's
        carried bytes against the analytic expectation for ``descs``
        (each kernel's on-wire bytes — ICI lines × line size — land on every
        hop of its route exactly once)."""
        want = expected_link_bytes(self, descs, line_size)
        mismatches = []
        for lk, bw in self.links.items():
            w = want.get(lk, 0)
            if bw.total_bytes != w:
                mismatches.append({"link": lk, "want": w, "got": bw.total_bytes})
        return {"ok": not mismatches, "mismatches": mismatches}

    # -- compiled-replay snapshot -----------------------------------------------------
    def resource_snapshot(self) -> Tuple[float, ...]:
        """Flat float columns appended to the compiled engine's per-segment
        resource rows (``repro.sim.compiled``): per device ≥ 1 its HBM
        ``(next_free, total, rd, wr)`` and writeback count (device 0 shares
        the legacy base columns), then per link (sorted order)
        ``(next_free, total_bytes)`` — links carry reads only."""
        cols: List[float] = []
        for hbm in self.hbms[1:]:
            cols += [hbm.next_free_cycle, float(hbm.total_bytes),
                     float(hbm.total_rd_bytes), float(hbm.total_wr_bytes)]
        for cache in self.caches[1:]:
            cols.append(float(cache.writebacks))
        for bw in self.links.values():
            cols += [bw.next_free_cycle, float(bw.total_bytes)]
        return tuple(cols)

    def restore_resource_snapshot(self, cols: Sequence[float]) -> None:
        """Inverse of :meth:`resource_snapshot` (compiled-trace replay)."""
        it = iter(cols)
        for hbm in self.hbms[1:]:
            hbm.next_free_cycle = float(next(it))
            hbm.total_bytes = int(next(it))
            hbm.total_rd_bytes = int(next(it))
            hbm.total_wr_bytes = int(next(it))
        for cache in self.caches[1:]:
            cache._writebacks = int(next(it))
        for bw in self.links.values():
            bw.next_free_cycle = float(next(it))
            bw.total_bytes = int(next(it))
            bw.total_rd_bytes = bw.total_bytes
            bw.total_wr_bytes = 0


# ------------------------------------------------------------------------- collectives
def _lines(n_bytes: int, line_size: int) -> int:
    return (n_bytes + line_size - 1) // line_size


def all_reduce_ring(
    topo: DeviceTopology,
    n_bytes: int,
    *,
    name: str = "ar_ring",
    flops: float = 0.0,
) -> List[KernelDesc]:
    """Ring all-reduce: every device sends ``2·(N-1)·ceil(bytes/N)`` to its
    ring successor (reduce-scatter + all-gather), one kernel per device."""
    n = topo.n_devices
    chunk = (n_bytes + n - 1) // n
    per_dev = 2 * (n - 1) * chunk
    return [
        KernelDesc(
            name=f"{name}_d{d}",
            flops=flops,
            ici_bytes=per_dev,
            addr_base=(d + 1) << 28,
            device=d,
            ici_route=(d, topo.next_device(d)),
        )
        for d in range(n)
    ]


def all_reduce_tree(
    topo: DeviceTopology,
    n_bytes: int,
    *,
    name: str = "ar_tree",
    flops: float = 0.0,
) -> List[KernelDesc]:
    """Binary-tree all-reduce rooted at device 0: each non-root device sends
    ``n_bytes`` up to its tree parent (reduce), and each parent sends
    ``n_bytes`` back down per child (broadcast) — two kernels per edge,
    attributed to the sending device's stream."""
    out: List[KernelDesc] = []
    for d in range(1, topo.n_devices):
        parent = (d - 1) // 2
        out.append(KernelDesc(
            name=f"{name}_up_d{d}", flops=flops, ici_bytes=n_bytes,
            addr_base=(d + 1) << 28, device=d, ici_route=(d, parent),
        ))
        out.append(KernelDesc(
            name=f"{name}_down_d{parent}_to{d}", flops=flops, ici_bytes=n_bytes,
            addr_base=(parent + 1) << 28 | (d << 20), device=parent,
            ici_route=(parent, d),
        ))
    return out


def all_to_all(
    topo: DeviceTopology,
    n_bytes_per_pair: int,
    *,
    name: str = "a2a",
    flops: float = 0.0,
) -> List[KernelDesc]:
    """All-to-all (the expert-parallel shuffle): every device sends
    ``n_bytes_per_pair`` to every other device, one kernel per (src, dst)."""
    out: List[KernelDesc] = []
    for src in range(topo.n_devices):
        for dst in range(topo.n_devices):
            if dst == src:
                continue
            out.append(KernelDesc(
                name=f"{name}_d{src}_to{dst}", flops=flops,
                ici_bytes=n_bytes_per_pair,
                addr_base=(src + 1) << 28 | (dst << 20),
                device=src, ici_route=(src, dst),
            ))
    return out


def pipeline_send(
    topo: DeviceTopology,
    n_bytes: int,
    *,
    microbatches: int = 1,
    name: str = "pp_send",
    flops: float = 0.0,
) -> List[KernelDesc]:
    """Pipeline-parallel activation sends: stages are devices in flattened
    order; every stage except the last sends ``n_bytes`` per microbatch to
    the next stage."""
    out: List[KernelDesc] = []
    for d in range(topo.n_devices - 1):
        for m in range(microbatches):
            out.append(KernelDesc(
                name=f"{name}_s{d}_m{m}", flops=flops, ici_bytes=n_bytes,
                addr_base=(d + 1) << 28 | (m << 20),
                device=d, ici_route=(d, d + 1),
            ))
    return out


def expected_link_bytes(
    topo: DeviceTopology,
    descs: Sequence[KernelDesc],
    line_size: int = LINE_SIZE,
) -> Dict[Tuple[int, int], int]:
    """Analytic per-link byte expectation for a set of kernels: each
    kernel's on-wire bytes (``ceil(ici_bytes / line_size) × line_size`` —
    the executor transfers whole lines) land once on every hop of its
    resolved route."""
    want: Dict[Tuple[int, int], int] = {}
    for desc in descs:
        wire = _lines(desc.ici_bytes, line_size) * line_size
        if desc.ici_bytes <= 0:
            continue
        for hop in topo.hops_for(desc):
            want[hop] = want.get(hop, 0) + wire
    return want
