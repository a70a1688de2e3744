"""The port's simulator and array-ops backend against the reference's, on the CPU.

Both packages run in one process from the same plain-data jobs: a job is
``(scenario, params, engine, config)``, built by each package's
``BatchJob.make`` from one ``divergent_draws`` list, so nothing needs
converting.  The port's sweeps run on ``array_backend="torch:cpu"`` (the
kernels' plain versions) and on ``"numpy"``; the reference runs its serial
pool path (``parallel=False``: its pooled path differs from its serial one,
a reference-side fault).  Tolerance: none, everything is compared for
equality, bit for bit.

The array ops are held against the reference's ``NumpyOps``, which it calls
bit-defining.  Its ``JaxOps()`` cannot be built on the installed jax (its
``jax.experimental.enable_x64`` import fails), so the segment scatter is
also held against the reference's Pallas kernel itself
(``JaxOps._segment_kernel``, in interpret mode as the reference runs it),
with the method's x64 scope bound to ``jax.enable_x64``.
"""

import multiprocessing as mp
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core.array_ops import JaxOps as RefJaxOps
from repro.core.array_ops import NumpyOps as RefNumpyOps
from repro.sim.batch import BatchJob as RefJob
from repro.sim.batch import BatchRunner as RefRunner
from repro.sim.scenarios import build as ref_build
from repro.sim.scenarios import divergent_draws as ref_draws
from repro_torch.core import array_ops
from repro_torch.core.array_ops import TorchOps, get_backend
from repro_torch.kernels import segment_scatter as ss
from repro_torch.sim import SimConfig, TPUSimulator
from repro_torch.sim import batch as batch_mod
from repro_torch.sim.batch import BatchJob, BatchRunner
from repro_torch.sim.scenarios import build, divergent_draws, list_scenarios

U64 = np.uint64
NEAR_2_64 = (1 << 64) - 1000  # counts that wrap when summed
NEAR_2_63 = (1 << 63) - 10  # counts whose sums cross int64's sign bit


@pytest.fixture(scope="module")
def ops():
    return get_backend("torch:cpu")


@pytest.fixture(scope="module")
def ref():
    return RefNumpyOps()


@pytest.fixture(scope="module")
def pallas():
    """The reference's ``JaxOps`` with only what its Pallas segment scatter uses."""
    o = RefJaxOps.__new__(RefJaxOps)
    o._jax, o._jnp, o._x64, o._seg_kernels = jax, jnp, jax.enable_x64, {}
    return o


def _rand_events(rng, n, n_cells):
    lin = rng.integers(0, n_cells, size=n).astype(np.int64)
    cnt = rng.integers(1, 1000, size=n).astype(U64)
    return lin, cnt


# --------------------------------------------------------------------------- array ops
@pytest.mark.parametrize("n,n_cells", [(0, 64), (17, 64), (5000, 64), (5000, 100_000)])
def test_scatter_add_u64(ops, ref, n, n_cells):
    rng = np.random.default_rng(n + n_cells)
    lin, cnt = _rand_events(rng, n, n_cells)
    base = rng.integers(0, 1 << 40, size=n_cells).astype(U64)
    a, b = base.copy(), base.copy()
    ref.scatter_add_u64(a, lin, cnt)
    ops.scatter_add_u64(b, lin, cnt)
    assert b.dtype == U64 and np.array_equal(a, b)


@pytest.mark.parametrize("unit_counts", [True, False])
@pytest.mark.parametrize("bincount_min_events", [1, 1 << 60])
def test_scatter_add_u64_against_both_reference_branches(ops, unit_counts, bincount_min_events):
    rng = np.random.default_rng(int(unit_counts))
    lin, cnt = _rand_events(rng, 4096, 256)
    if unit_counts:
        cnt = np.ones_like(cnt)
    want, got = np.zeros(256, dtype=U64), np.zeros(256, dtype=U64)
    RefNumpyOps(bincount_min_events=bincount_min_events).scatter_add_u64(want, lin, cnt)
    ops.scatter_add_u64(got, lin, cnt)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("count", [NEAR_2_64, NEAR_2_63])
def test_scatter_add_u64_wraps_mod_2_64(ops, ref, count):
    rng = np.random.default_rng(7)
    lin = rng.integers(0, 8, size=300).astype(np.int64)
    cnt = np.full(300, count, dtype=U64)
    base = np.full(8, (1 << 64) - 5, dtype=U64)
    a, b = base.copy(), base.copy()
    ref.scatter_add_u64(a, lin, cnt)
    ops.scatter_add_u64(b, lin, cnt)
    assert np.array_equal(a, b)
    want = [(int(base[i]) + count * int((lin == i).sum())) % (1 << 64) for i in range(8)]
    assert b.tolist() == want


@pytest.mark.parametrize("shape", [(0,), (1,), (257,), (64, 3)])
def test_running_sum_float64(ops, ref, shape):
    rng = np.random.default_rng(sum(shape) + len(shape))
    # adversarial magnitudes so any reassociation changes the rounding
    vals = rng.uniform(-1.0, 1.0, size=shape) * (10.0 ** rng.integers(-8, 8, size=shape))
    a, b = ref.running_sum(vals), ops.running_sum(vals)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_running_sum_int64(ops, ref):
    vals = np.arange(100, dtype=np.int64) * 3
    assert np.array_equal(ref.running_sum(vals), ops.running_sum(vals))
    wrap = np.array([(1 << 63) - 1, 5, -7, 1 << 62], dtype=np.int64)
    assert np.array_equal(ref.running_sum(wrap), ops.running_sum(wrap))


@pytest.mark.parametrize("table_size", [0, 1, 7, 500])
def test_sorted_membership(ops, ref, table_size):
    rng = np.random.default_rng(table_size)
    table = np.unique(rng.integers(0, 1000, size=table_size).astype(np.int64))
    values = rng.integers(-5, 1005, size=300).astype(np.int64)
    a, b = ref.sorted_membership(values, table), ops.sorted_membership(values, table)
    assert b.dtype == bool and np.array_equal(a, b) and np.array_equal(b, np.isin(values, table))


@pytest.mark.parametrize("n_segs,row_size", [(1, 8), (5, 64), (16, 300)])
def test_segment_scatter(ops, ref, pallas, n_segs, row_size):
    rng = np.random.default_rng(n_segs * row_size)
    n = 2000
    # deliberately include seg == n_segs + slack: overflow must drop
    seg = rng.integers(0, n_segs + 2, size=n).astype(np.int64)
    lin = rng.integers(0, row_size, size=n).astype(np.int64)
    cnt = rng.integers(1, 50, size=n).astype(U64)
    got = ops.segment_scatter(seg, lin, cnt, n_segs, row_size)
    assert got.dtype == U64 and got.shape == (n_segs, row_size)
    assert np.array_equal(got, ref.segment_scatter(seg, lin, cnt, n_segs, row_size))
    assert np.array_equal(got, pallas.segment_scatter(seg, lin, cnt, n_segs, row_size))


def test_segment_scatter_wraps_mod_2_64(ops, ref, pallas):
    rng = np.random.default_rng(11)
    seg = rng.integers(0, 4, size=500).astype(np.int64)
    lin = rng.integers(0, 6, size=500).astype(np.int64)
    cnt = np.where(rng.random(500) < 0.5, NEAR_2_64, NEAR_2_63).astype(U64)
    got = ops.segment_scatter(seg, lin, cnt, 3, 6)
    assert np.array_equal(got, ref.segment_scatter(seg, lin, cnt, 3, 6))
    assert np.array_equal(got, pallas.segment_scatter(seg, lin, cnt, 3, 6))


def test_segment_scatter_all_events_overflow(ops, ref):
    seg = np.full(64, 9, dtype=np.int64)
    lin = np.zeros(64, dtype=np.int64)
    cnt = np.ones(64, dtype=U64)
    for o in (ref, ops):
        out = o.segment_scatter(seg, lin, cnt, 4, 16)
        assert out.shape == (4, 16) and out.dtype == U64 and out.sum() == 0


@pytest.mark.parametrize("n_segs", [3, 0])
def test_segment_scatter_empty(ops, ref, n_segs):
    e = np.empty(0, dtype=np.int64)
    for o in (ref, ops):
        out = o.segment_scatter(e, e, e.astype(U64), n_segs, 5)
        assert out.shape == (n_segs, 5) and out.dtype == U64 and out.sum() == 0


def test_out_of_table_indices_raise_as_numpy_does(ops, ref):
    lin, cnt = np.array([0, 9], dtype=np.int64), np.ones(2, dtype=U64)
    for o in (ref, ops):
        with pytest.raises(IndexError):
            o.scatter_add_u64(np.zeros(4, dtype=U64), lin, cnt)
        with pytest.raises(IndexError):
            o.segment_scatter(np.array([0, 1], dtype=np.int64), lin, cnt, 2, 4)


def test_plain_wrappers_take_int64_storage_and_count_no_launch():
    before = (ss.segment_scatter.launches, ss.scatter_add.launches, ss.running_sum.launches)
    seg = torch.tensor([0, 1, 2, 1])
    lin = torch.tensor([1, 0, 0, 1])
    cnt = torch.tensor([-1, 2, 5, 3])  # uint64 2**64 - 1 as int64 storage
    table, bad = ss.segment_scatter(seg, lin, cnt, 2, 2)
    assert table.tolist() == [[0, -1], [2, 3]] and bad.item() == 0
    dense = torch.zeros(2, dtype=torch.int64)
    assert ss.scatter_add(dense, lin, cnt).item() == 0 and dense.tolist() == [7, 2]
    assert ss.running_sum(torch.tensor([[1, 2], [3, 4]])).tolist() == [[1, 2], [4, 6]]
    assert (ss.segment_scatter.launches, ss.scatter_add.launches, ss.running_sum.launches) == before
    with pytest.raises(ValueError, match="int64"):
        ss.segment_scatter(seg.int(), lin, cnt, 2, 2)
    with pytest.raises(ValueError, match="one length"):
        ss.scatter_add(dense, lin[:3], cnt)
    with pytest.raises(ValueError, match="float64 or int64"):
        ss.running_sum(torch.ones(3, dtype=torch.float32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss.segment_scatter(seg.to("meta"), lin.to("meta"), cnt.to("meta"), 2, 2)


def test_get_backend_names():
    assert get_backend("numpy").name == "numpy"
    assert isinstance(get_backend("torch:cpu"), TorchOps) and get_backend("torch:cpu").device.type == "cpu"
    for bad in ("jax", "cuda", "torch:cuda", ""):
        with pytest.raises(ValueError, match="'numpy', 'torch', 'torch:cpu'"):
            get_backend(bad)


def test_torch_backend_never_runs_on_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delitem(array_ops.BACKENDS, "torch", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("torch")
    assert "torch" not in array_ops.BACKENDS
    assert SimConfig().array_backend == "torch"  # the port's entry points default to the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPUSimulator()


# --------------------------------------------------------------------------- sweeps
def _ref_serial(draws, engine):
    jobs = [RefJob.make(d["scenario"], d["params"], engine=engine) for d in draws]
    return RefRunner(jobs, backend="pool").run(parallel=False)


def _port_batched(draws, engine, backend="torch:cpu"):
    jobs = [BatchJob.make(d["scenario"], d["params"], engine=engine, config=dict(array_backend=backend))
            for d in draws]
    return BatchRunner(jobs, backend="batched").run()


def test_draws_are_the_reference_draws():
    assert divergent_draws(2, seed=0) == ref_draws(2, seed=0)


def test_full_registry_divergent_sweep_matches_reference():
    draws = divergent_draws(2, seed=0)
    assert len(draws) == 2 * len(list_scenarios())
    got = _port_batched(draws, "event")
    assert got.failures() == [] and got.oracle_failures() == []
    assert got.signature() == _ref_serial(draws, "event").signature()


def test_pooled_sweep_equals_serial_sweep(monkeypatch):
    """The port's pooled sweep over the full registry equals its serial sweep
    with 2 workers, and no job fails (the reference's pooled sweep fails its
    first job here: its chunks of 3 jobs make ``imap`` return a generator
    with no ``next(timeout=...)``).  The workers are spawned: this process
    has loaded jax, whose threads make a fork unsafe (the reference's own
    rule; the port forks unless CUDA is initialised)."""
    monkeypatch.setattr(batch_mod, "_pool_context", lambda: mp.get_context("spawn"))
    jobs = [BatchJob.make(name, engine="event", config=dict(array_backend="numpy")) for name in list_scenarios()]
    runner = BatchRunner(jobs, workers=2)
    pooled, serial = runner.run(parallel=True), runner.run(parallel=False)
    assert pooled.failures() == [] and serial.failures() == []
    assert pooled.signature() == serial.signature()


@pytest.mark.parametrize("engine,backend", [("cycle", "torch:cpu"), ("compiled", "torch:cpu"),
                                            ("event", "numpy")])
def test_other_engines_and_backends_match_reference(engine, backend):
    draws = divergent_draws(1, seed=3)
    got = _port_batched(draws, engine, backend)
    assert got.failures() == []
    assert got.signature() == _ref_serial(draws, engine).signature()


@settings(max_examples=4, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_mixed_batches_match_reference(data):
    names = data.draw(st.lists(st.sampled_from(list_scenarios()), min_size=1, max_size=4, unique=True))
    seed = data.draw(st.integers(0, 1000))
    engines = data.draw(st.lists(st.sampled_from(["cycle", "event", "compiled"]), min_size=len(names),
                                 max_size=len(names)))
    draws = [d for d in divergent_draws(1, seed=seed) if d["scenario"] in names]
    ref_jobs = [RefJob.make(d["scenario"], d["params"], engine=e) for d, e in zip(draws, engines)]
    port_jobs = [BatchJob.make(d["scenario"], d["params"], engine=e, config=dict(array_backend="torch:cpu"))
                 for d, e in zip(draws, engines)]
    want = RefRunner(ref_jobs, backend="pool").run(parallel=False).signature()
    assert BatchRunner(port_jobs, backend="batched").run().signature() == want


def test_kernel_exit_log_text_is_the_reference_text():
    """Character for character, once the kernel uids (each package counts its
    own, process-wide) are renumbered in order of appearance."""

    def text(res):  # the log names a uid three ways: "uid: 5", "uid 0", "kernel_launch_uid = 5"
        uids = {}
        return re.sub(r"(uid:? |uid = )(\d+)", lambda m: f"{m.group(1)}{uids.setdefault(m.group(2), len(uids))}",
                      "\n".join(res.log))

    want = text(ref_build("l2_lat").make_sim(engine="event").run())
    got = text(build("l2_lat").make_sim(engine="event", config=SimConfig(array_backend="torch:cpu")).run())
    assert "finished on stream" in got and "Total_core_cache_stats" in got
    assert got == want
