"""Pluggable array-ops backend for the hottest landing paths.

The simulator's inner loops funnel through a handful of array primitives:
the ``np.add.at`` stat scatter in :meth:`StatsEngine.flush`, the
strictly-sequential ``np.add.accumulate`` bandwidth-pointer fold, the
sorted-membership probes, and the batched backend's segment-scatter landing
kernel.  The NumPy backend is the reference, bit-defining for every op.
:class:`TorchOps` runs the same ops through torch: on the card its
segment scatter, flush scatter and running sum are the hand-written CUDA
kernels of :mod:`repro_torch.kernels.segment_scatter`; on the CPU they are
those kernels' plain versions.  Selected by ``SimConfig.array_backend =
"torch" | "torch:cpu" | "numpy"``.

The contract is **element identity**: numpy arrays in, numpy arrays out,
equal to :class:`NumpyOps` bit for bit.  uint64 scatters are exact in any
order mod 2^64, and the running sum is a strict left fold (``torch.cumsum``
is a parallel scan on the card and may round float64 differently).

Importing this module builds no kernel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..kernels import segment_scatter as kernels

__all__ = ["ArrayOps", "NumpyOps", "TorchOps", "get_backend", "BACKENDS", "BACKEND_NAMES"]

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


class TorchOps(ArrayOps):
    """torch backend, element-identical to :class:`NumpyOps`.

    On ``cuda`` (``"torch"``) each op copies its numpy inputs to the card,
    runs there and copies the result back: ``segment_scatter`` is the
    segment-scatter kernel, ``scatter_add_u64`` the same kernel in
    accumulate mode into the caller's dense store, ``running_sum`` the
    sequential-fold kernel, and ``sorted_membership`` is
    ``torch.searchsorted`` (the reference's ``jnp.searchsorted`` sits
    outside any Pallas kernel too).  On the CPU (``"torch:cpu"``) the same
    wrappers take the kernels' plain versions.  uint64 crosses as int64
    storage (``view(np.int64)`` in, ``view(np.uint64)`` out)."""

    def __init__(self, device: str) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "array_backend='torch' runs on the card and this host has no CUDA device; "
                "use 'torch:cpu' or 'numpy' for the host"
            )
        self.name = "torch" if self.device.type == "cuda" else "torch:cpu"

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _events(self, lin, cnt):
        lin = np.asarray(lin, dtype=np.int64)
        cnt = np.asarray(cnt, dtype=np.uint64).view(np.int64)
        return self._dev(lin), self._dev(cnt)

    @staticmethod
    def _raise_bad(bad: torch.Tensor, size: int) -> None:
        n = int(bad.item())
        if n:
            raise IndexError(f"{n} event(s) index outside the {size}-cell table")

    def scatter_add_u64(self, dense_flat: np.ndarray, lin: np.ndarray,
                        cnt: np.ndarray) -> None:
        """In place ``dense_flat[lin] += cnt`` (uint64, duplicates summed)."""
        if np.asarray(lin).size == 0:
            return
        host = torch.from_numpy(dense_flat.view(np.int64))  # shares dense_flat's memory
        dense = host.to(self.device)
        bad = kernels.scatter_add(dense, *self._events(lin, cnt))
        if dense.data_ptr() != host.data_ptr():
            host.copy_(dense)
        self._raise_bad(bad, dense_flat.size)

    def running_sum(self, values: np.ndarray) -> np.ndarray:
        """Strictly-sequential prefix sum along axis 0 (float64 or int64)."""
        values = np.asarray(values)
        if values.shape[0] == 0:
            return values.copy()
        return kernels.running_sum(self._dev(values)).cpu().numpy()

    def sorted_membership(self, values: np.ndarray, table: np.ndarray) -> np.ndarray:
        """Boolean mask: ``values[i] in table`` for a **sorted** table."""
        values = np.asarray(values)
        if table.size == 0:
            return np.zeros(values.shape, dtype=bool)
        v, t = self._dev(values), self._dev(table)
        idx = torch.searchsorted(t, v).clamp_(0, t.numel() - 1)
        return (t[idx] == v).cpu().numpy()

    def segment_scatter(self, seg: np.ndarray, lin: np.ndarray, cnt: np.ndarray,
                        n_segs: int, row_size: int) -> np.ndarray:
        """The batched landing: the segment-scatter kernel into a zeroed
        ``(n_segs, row_size)`` uint64 table; ``seg >= n_segs`` drops."""
        seg = np.asarray(seg, dtype=np.int64)
        if seg.size == 0 or n_segs == 0:
            return np.zeros((n_segs, row_size), dtype=np.uint64)
        table, bad = kernels.segment_scatter(self._dev(seg), *self._events(lin, cnt), n_segs, row_size)
        out = table.cpu().numpy().view(np.uint64)
        self._raise_bad(bad, n_segs * row_size)
        return out


#: the names :func:`get_backend` accepts
BACKEND_NAMES = ("numpy", "torch", "torch:cpu")

#: materialized backends by name (the numpy reference is always present)
BACKENDS: Dict[str, ArrayOps] = {"numpy": NumpyOps()}


def get_backend(name: str = "numpy") -> ArrayOps:
    """The array-ops backend for ``name``, cached: ``"numpy"`` (the
    reference), ``"torch"`` (:class:`TorchOps` on the card, whose ops launch
    the CUDA kernels; raises on a host without CUDA, never falls back) or
    ``"torch:cpu"`` (:class:`TorchOps` on the host, the plain versions)."""
    ops = BACKENDS.get(name)
    if ops is not None:
        return ops
    if name not in BACKEND_NAMES:
        raise ValueError(f"unknown array backend {name!r} (want one of {', '.join(map(repr, BACKEND_NAMES))})")
    ops = TorchOps("cuda" if name == "torch" else "cpu")
    BACKENDS[name] = ops
    return ops
