"""The simulator's stat landing: the segment-scatter kernel, its accumulate entry, the sequential fold.

:func:`segment_scatter` replaces ``repro/core/array_ops.py::JaxOps._segment_kernel``
(the Pallas TPU kernel): it lands every event count of a batched sweep into
a ``(n_segs, row_size)`` table, one row per (run, report segment).
:func:`scatter_add` is the same kernel in accumulate mode, adding into a
caller's buffer (the stats engine's flush scatter), and :func:`running_sum`
the strict left fold that the reference computes with ``lax.scan``.  All
three are ``csrc/array_ops.cu``, built for ``sm_90a`` by :mod:`.build` at
the first launch and called through ``ctypes``.

uint64 counts cross as int64 storage (the same bits; torch's uint64 support
is partial); the kernels read and write ``unsigned long long`` and no torch
op that depends on sign touches them.  uint64 addition is exact mod 2^64 in
any order, so the kernels' atomics give the plain versions' bits exactly.

What bounds the scatter on an H100: bytes (24 per event, 8 per table cell,
the zero fill included); each event lands with its own atomic, so events
that share a cell serialise on it.  ``PERF.md`` holds its measured time
beside its bound.

Each wrapper takes tensors on one device.  A CUDA tensor launches the kernel
(and adds one to the wrapper's ``launches``) or raises; only a CPU tensor
takes the plain version in :mod:`.ref`.  An event whose flat index lies
outside the table is skipped by both and counted in the ``bad`` tensor each
scatter returns, so that the caller can raise without a sync here.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .ref import running_sum_ref, scatter_add_ref, segment_scatter_ref

__all__ = ["segment_scatter", "scatter_add", "running_sum", "SOURCE", "REPLACES"]

#: where the kernels live, and which TPU kernel the segment scatter replaces
SOURCE = "src/repro_torch/kernels/csrc/array_ops.cu"
REPLACES = "src/repro/core/array_ops.py:229 (JaxOps._segment_kernel)"

_FOLD_DTYPES = {torch.float64: 0, torch.int64: 1}


def _lib():
    lib = build.load("array_ops")
    if lib.repro_segment_scatter.argtypes is None:  # first use of this library handle
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        lib.repro_segment_scatter.argtypes = [p, p, p, ll, ll, ll, p, p, p]
        lib.repro_scatter_add.argtypes = [p, p, ll, ll, p, p, p]
        lib.repro_running_sum.argtypes = [p, p, ll, ll, i, p]
        for fn in (lib.repro_segment_scatter, lib.repro_scatter_add, lib.repro_running_sum):
            fn.restype = ctypes.c_int
        lib.repro_array_ops_error_string.argtypes = [i]
        lib.repro_array_ops_error_string.restype = ctypes.c_char_p
    return lib


def _raise_if(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.repro_array_ops_error_string(err).decode()}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_events(*cols: torch.Tensor) -> torch.device:
    n = cols[0].shape[0] if cols[0].ndim == 1 else -1
    for c in cols:
        if c.ndim != 1 or c.shape[0] != n:
            raise ValueError(f"event columns must be 1-D of one length, got {[tuple(c.shape) for c in cols]}")
        if c.dtype != torch.int64:
            raise ValueError(f"event columns are int64 (uint64 counts as int64 storage), got {c.dtype}")
    devices = {c.device for c in cols}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    device = cols[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on cuda or cpu, not {device}")
    return device


def segment_scatter(
    seg: torch.Tensor, lin: torch.Tensor, cnt: torch.Tensor, n_segs: int, row_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Land event ``i``'s count ``cnt[i]`` at ``[seg[i], lin[i]]`` of a zeroed
    ``(n_segs, row_size)`` int64 table (flat index ``seg * row_size + lin``);
    events with ``seg >= n_segs`` are dropped.  Returns the table and a
    ``(1,)`` int64 count of kept events whose flat index lies outside it.

    seg, lin, cnt: 1-D int64 of one length, on one device.  Empty input or
    ``n_segs == 0`` returns zeros and launches nothing; otherwise a CUDA
    tensor launches the kernel and counts it in ``segment_scatter.launches``."""
    device = _check_events(seg, lin, cnt)
    n_segs, row_size = int(n_segs), int(row_size)
    if n_segs < 0 or row_size < 0:
        raise ValueError(f"table shape ({n_segs}, {row_size}) is negative")
    if device.type == "cpu":
        return segment_scatter_ref(seg, lin, cnt, n_segs, row_size)
    if seg.numel() == 0 or n_segs == 0:
        return (torch.zeros((n_segs, row_size), dtype=torch.int64, device=device),
                torch.zeros(1, dtype=torch.int64, device=device))
    seg, lin, cnt = seg.contiguous(), lin.contiguous(), cnt.contiguous()
    table = torch.empty((n_segs, row_size), dtype=torch.int64, device=device)
    bad = torch.empty(1, dtype=torch.int64, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.repro_segment_scatter(seg.data_ptr(), lin.data_ptr(), cnt.data_ptr(), seg.numel(),
                                        n_segs, row_size, table.data_ptr(), bad.data_ptr(), _stream(device))
    _raise_if(lib, err, "segment_scatter")
    segment_scatter.launches += 1
    return table, bad


def scatter_add(dense: torch.Tensor, lin: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """In place ``dense[lin[i]] += cnt[i]``, duplicates summed, into the
    caller's 1-D contiguous int64 ``dense``, which is not zeroed.  Returns a
    ``(1,)`` int64 count of indices outside ``dense`` (skipped).

    Empty input launches nothing; otherwise a CUDA tensor launches the
    kernel in accumulate mode and counts it in ``scatter_add.launches``."""
    device = _check_events(lin, cnt)
    if dense.ndim != 1 or dense.dtype != torch.int64 or not dense.is_contiguous() or dense.device != device:
        raise ValueError(f"dense must be a contiguous 1-D int64 tensor on {device}, got "
                         f"{dense.dtype} {tuple(dense.shape)} on {dense.device}")
    if device.type == "cpu":
        return scatter_add_ref(dense, lin, cnt)
    if lin.numel() == 0:
        return torch.zeros(1, dtype=torch.int64, device=device)
    lin, cnt = lin.contiguous(), cnt.contiguous()
    bad = torch.empty(1, dtype=torch.int64, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.repro_scatter_add(lin.data_ptr(), cnt.data_ptr(), lin.numel(), dense.numel(),
                                    dense.data_ptr(), bad.data_ptr(), _stream(device))
    _raise_if(lib, err, "scatter_add")
    scatter_add.launches += 1
    return bad


def running_sum(values: torch.Tensor) -> torch.Tensor:
    """Prefix sum along axis 0 as a strict left fold (bit-identical to
    ``np.add.accumulate(values, axis=0)``), for float64 or int64 of any
    shape with at least one axis.  An empty array launches nothing; otherwise a
    CUDA tensor launches the fold kernel, counted in ``running_sum.launches``."""
    if values.ndim == 0:
        raise ValueError("running_sum needs at least one axis")
    if values.dtype not in _FOLD_DTYPES:
        raise ValueError(f"running_sum takes float64 or int64, got {values.dtype}")
    if values.device.type == "cpu":
        return running_sum_ref(values)
    if values.device.type != "cuda":
        raise ValueError(f"running_sum runs on cuda or cpu, not {values.device}")
    if values.numel() == 0:
        return torch.empty_like(values)
    src = values.contiguous()
    out = torch.empty_like(src)
    rows = src.shape[0]
    lib = _lib()
    with torch.cuda.device(src.device):
        err = lib.repro_running_sum(src.data_ptr(), out.data_ptr(), rows, src.numel() // rows,
                                    _FOLD_DTYPES[src.dtype], _stream(src.device))
    _raise_if(lib, err, "running_sum")
    running_sum.launches += 1
    return out


#: launches of each CUDA kernel since its count was last set to 0
segment_scatter.launches = 0
scatter_add.launches = 0
running_sum.launches = 0
