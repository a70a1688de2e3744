"""Pluggable array-ops backend for the hottest landing paths.

The simulator's inner loops funnel through a handful of array primitives:
the ``np.add.at`` stat scatter in :meth:`StatsEngine.flush`, the
strictly-sequential ``np.add.accumulate`` bandwidth-pointer fold, the
sorted-membership probes, and the batched backend's segment-scatter landing
kernel.  This copy holds only the NumPy reference backend, which is
bit-defining for every op; the stats core's flush scatter runs on it.  A
device backend (the segment-scatter kernel) belongs to the simulator's slice
of the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["ArrayOps", "NumpyOps", "get_backend", "BACKENDS"]

#: S2 threshold: route the flush scatter through ``np.bincount`` on the
#: linearized cell index once a landing exceeds this many events —
#: ``np.add.at`` is notoriously slow for large batches (it dispatches per
#: element), while ``bincount`` is a single C pass.
_BINCOUNT_MIN_EVENTS = 2048

#: ``np.bincount`` accumulates float64 weights; integer sums are exact only
#: below 2**53.  The guard is on the *total* count of the landing, which
#: bounds every per-cell sum.
_FLOAT64_EXACT_MAX = 1 << 53


class ArrayOps:
    """Backend interface — see :class:`NumpyOps` for reference semantics."""

    name: str = "abstract"

    def scatter_add_u64(self, dense_flat: np.ndarray, lin: np.ndarray,
                        cnt: np.ndarray) -> None:
        raise NotImplementedError

    def running_sum(self, values: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def sorted_membership(self, values: np.ndarray, table: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def segment_scatter(self, seg: np.ndarray, lin: np.ndarray, cnt: np.ndarray,
                        n_segs: int, row_size: int) -> np.ndarray:
        raise NotImplementedError


class NumpyOps(ArrayOps):
    """Reference backend: plain NumPy, bit-defining for every op."""

    name = "numpy"

    def __init__(self, bincount_min_events: int = _BINCOUNT_MIN_EVENTS) -> None:
        self.bincount_min_events = int(bincount_min_events)

    def scatter_add_u64(self, dense_flat: np.ndarray, lin: np.ndarray,
                        cnt: np.ndarray) -> None:
        """In-place ``dense_flat[lin] += cnt`` with duplicate indices summed.

        Large landings route through ``np.bincount`` on the linearized index
        when the dense store is not vastly larger than the event batch (the
        ``minlength`` allocation would dominate).  Unit-count landings — the
        dominant per-access trace case — histogram in one unweighted C pass;
        weighted landings use float64-weighted bincount only while provably
        exact (total count below 2**53 bounds every per-cell partial sum).
        All branches produce the same uint64 values, including on
        wraparound, since the scatter sums are exact before the modular
        add."""
        n = lin.shape[0]
        if 0 < n >= self.bincount_min_events and dense_flat.size <= 8 * n + (1 << 16):
            if int(cnt.max()) == 1:
                dense_flat += np.bincount(lin, minlength=dense_flat.size).astype(
                    np.uint64
                )
                return
            if int(cnt.sum()) < _FLOAT64_EXACT_MAX:
                binned = np.bincount(lin, weights=cnt, minlength=dense_flat.size)
                dense_flat += binned.astype(np.uint64)
                return
        np.add.at(dense_flat, lin, cnt)

    def running_sum(self, values: np.ndarray) -> np.ndarray:
        """Strictly-sequential prefix sum along axis 0 (``ufunc.accumulate``
        is a left fold, so float64 rounding is order-defined)."""
        return np.add.accumulate(values, axis=0)

    def sorted_membership(self, values: np.ndarray, table: np.ndarray) -> np.ndarray:
        """Boolean mask: ``values[i] in table`` for a **sorted** table."""
        if table.size == 0:
            return np.zeros(values.shape, dtype=bool)
        idx = np.searchsorted(table, values)
        np.clip(idx, 0, table.size - 1, out=idx)
        return table[idx] == values

    def segment_scatter(self, seg: np.ndarray, lin: np.ndarray, cnt: np.ndarray,
                        n_segs: int, row_size: int) -> np.ndarray:
        """The batched landing kernel: scatter event counts into a
        ``(n_segs, row_size)`` uint64 table at ``[seg[i], lin[i]]``.  Events
        with ``seg >= n_segs`` (after the final report boundary) are dropped.
        """
        table = np.zeros(n_segs * row_size, dtype=np.uint64)
        keep = seg < n_segs
        if not keep.all():
            seg, lin, cnt = seg[keep], lin[keep], cnt[keep]
        if seg.size:
            self.scatter_add_u64(table, seg * row_size + lin, cnt)
        return table.reshape(n_segs, row_size)


#: materialized backends by name (the numpy reference is always present)
BACKENDS: Dict[str, ArrayOps] = {"numpy": NumpyOps()}


def get_backend(name: str = "numpy") -> ArrayOps:
    """The array-ops backend for ``name``; only ``"numpy"`` exists so far
    (the device backend with the segment-scatter kernel comes with the
    simulator's slice of the port)."""
    ops = BACKENDS.get(name)
    if ops is not None:
        return ops
    raise ValueError(f"unknown array backend {name!r} (want 'numpy')")
