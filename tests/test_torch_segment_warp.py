"""The segment kernel's warp-aggregated landing, on the CPU, through its plain form.

``segment_scatter_warp_ref`` lands events as the CUDA kernel does: windows
of 64 consecutive events, two per lane, a lane's two equal keys added, then
per round the lanes of equal key summed into their lowest lane, which lands
the sum.  Held bit for bit against the reference's ``NumpyOps``, whose
segment scatter and accumulate entry it calls bit-defining, on shuffled,
sorted and all-equal keys, uint64 wraparound, dropped and out-of-table
events and the empty input.  Tolerance: none (uint64 addition is exact mod
2^64 in any grouping).  The kernel itself is held against the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from repro.core.array_ops import NumpyOps as RefNumpyOps
from repro_torch.kernels.ref import segment_scatter_ref, segment_scatter_warp_ref

U64 = np.uint64
NEAR_2_64 = (1 << 64) - 1000  # counts that wrap when summed


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == U64 else a.astype(np.int64))


def _warp(seg, lin, cnt, n_segs, row_size):
    table, bad, landings = segment_scatter_warp_ref(_t(seg), _t(lin), _t(cnt), n_segs, row_size)
    return table.numpy().view(U64), int(bad.item()), landings


def _events(order, n, n_segs, row_size, seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_segs + 2, size=n)  # two rows past the table: dropped
    lin = rng.integers(0, row_size, size=n)
    cnt = rng.integers(1, 50, size=n).astype(U64)
    if order == "sorted":  # run-major then segment, as the sweep's landing hands them over
        idx = np.argsort(seg, kind="stable")
        seg, lin, cnt = seg[idx], lin[idx], cnt[idx]
    elif order == "hot":  # sorted segments, few cells a row: the sweep's ~74 events a cell
        seg = np.sort(seg)
        lin = rng.integers(0, 3, size=n)
    return seg, lin, cnt


@pytest.mark.parametrize("order", ["shuffled", "sorted", "hot"])
@pytest.mark.parametrize("n,n_segs,row_size", [(2000, 1, 8), (2000, 5, 64), (2001, 16, 300), (63, 3, 5)])
def test_warp_landing_equals_numpy(order, n, n_segs, row_size):
    seg, lin, cnt = _events(order, n, n_segs, row_size, seed=n_segs * row_size)
    got, bad, landings = _warp(seg, lin, cnt, n_segs, row_size)
    assert bad == 0 and np.array_equal(got, RefNumpyOps().segment_scatter(seg, lin, cnt, n_segs, row_size))
    kept = seg < n_segs
    assert landings <= kept.sum()  # never more landings than kept events
    if order == "hot" and n >= 2000:  # equal keys close together: far fewer atomics than events
        assert landings < kept.sum() / 4


def test_all_equal_keys_land_once_per_window():
    n = 64 * 10 + 7
    seg, lin = np.full(n, 2), np.full(n, 4)
    cnt = np.arange(1, n + 1).astype(U64)
    got, bad, landings = _warp(seg, lin, cnt, 3, 8)
    assert np.array_equal(got, RefNumpyOps().segment_scatter(seg, lin, cnt, 3, 8))
    assert bad == 0 and landings == 11 and int(got[2, 4]) == n * (n + 1) // 2


def test_warp_landing_wraps_mod_2_64():
    rng = np.random.default_rng(11)
    seg = rng.integers(0, 4, size=700)
    lin = rng.integers(0, 6, size=700)
    cnt = np.where(rng.random(700) < 0.5, NEAR_2_64, (1 << 63) - 10).astype(U64)
    got, bad, _ = _warp(seg, lin, cnt, 3, 6)
    assert bad == 0 and np.array_equal(got, RefNumpyOps().segment_scatter(seg, lin, cnt, 3, 6))


def test_dropped_and_out_of_table_events_land_nothing():
    """seg >= n_segs drops; a kept event outside the table is skipped and
    counted (NumPy raises there); the rest land as NumPy lands them."""
    seg = np.array([0, 9, 1, 1, 0, 7, 1], dtype=np.int64)
    lin = np.array([1, 0, 3, 9, -20, 2, 3], dtype=np.int64)
    cnt = np.array([5, 6, 7, 8, 9, 10, 11], dtype=U64)
    got, bad, _ = _warp(seg, lin, cnt, 2, 4)
    ok = np.array([True, False, True, False, False, False, True])
    assert bad == 2 and np.array_equal(got, RefNumpyOps().segment_scatter(seg[ok], lin[ok], cnt[ok], 2, 4))
    with pytest.raises(IndexError):
        RefNumpyOps().segment_scatter(seg, lin, cnt, 2, 4)
    table, plain_bad = segment_scatter_ref(_t(seg), _t(lin), _t(cnt), 2, 4)
    assert plain_bad.item() == 2 and np.array_equal(table.numpy().view(U64), got)


@pytest.mark.parametrize("n_segs", [3, 0])
def test_empty_input_lands_nothing(n_segs):
    e = np.empty(0, dtype=np.int64)
    got, bad, landings = _warp(e, e, e.astype(U64), n_segs, 5)
    assert got.shape == (n_segs, 5) and got.sum() == 0 and bad == 0 and landings == 0


def test_accumulate_entry_equals_numpy():
    """Without the seg column (the stats engine's flush scatter) the key is
    the index itself; summed into a caller's buffer as NumPy's scatter_add_u64."""
    rng = np.random.default_rng(5)
    lin = np.sort(rng.integers(0, 300, size=5000))
    cnt = np.where(rng.random(5000) < 0.3, NEAR_2_64, rng.integers(1, 9, size=5000)).astype(U64)
    table, bad, _ = segment_scatter_warp_ref(_t(lin), _t(lin), _t(cnt), 1, 300, seg_col=False)
    base = rng.integers(0, 1 << 62, size=300).astype(U64)
    want = base.copy()
    RefNumpyOps().scatter_add_u64(want, lin, cnt)
    assert bad.item() == 0 and np.array_equal(base + table.numpy().view(U64).reshape(-1), want)
