"""The CUDA kernels (flash attention, the SSD scan, the simulator's landing) against their plain versions, on the card.

Imports torch and the port only (the card's machine has no JAX).  Every
test needs an NVIDIA GPU and skips without one.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import segment_scatter as ss
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels.ref import (
    attention_ref, running_sum_ref, scatter_add_ref, segment_scatter_ref, ssd_ref,
)

pytestmark = pytest.mark.cuda

SHAPES = [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 192, 6, 1, 64), (2, 64, 2, 2, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0, Sk=None):
    B, S, Hq, Hkv, D = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    Sk = S if Sk is None else Sk
    mk = lambda *s: torch.randn(*s, generator=g).to(device=device, dtype=dtype)
    return mk(B, S, Hq, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_fp32_matches_plain(cuda, shape, causal):
    q, k, v = _qkv(shape, torch.float32, cuda, seed=shape[1])
    before = fa.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, impl="plain")
    torch.testing.assert_close(out, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("S", [1, 17, 128, 500])
def test_kernel_bf16_matches_plain(cuda, S):
    q, k, v = _qkv((1, S, 32, 32, 128), torch.bfloat16, cuda, seed=S)
    out = ops.flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=1e-2)


def test_kernel_reads_strided_inputs_and_empty_kv(cuda):
    # q/k/v as slices of one packed projection: batch-major, head dim contiguous
    qkv = torch.randn(2, 96, 3, 4, 64, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True),
        attention_ref(q, k, v, causal=True), atol=2e-5, rtol=1e-4,
    )
    q0, k0, v0 = _qkv((1, 5, 2, 2, 32), torch.float32, cuda, Sk=0)
    assert torch.count_nonzero(ops.flash_attention(q0, k0, v0, causal=False)) == 0


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 16, 2, 2, 48), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv((1, 16, 2, 2, 32), torch.float16, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv((1, 16, 2, 2, 32), torch.float32, cuda)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, v, prefix_len=4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


# --------------------------------------------------------------------------- SSD scan
SSD_SHAPES = [(1, 64, 2, 16, 8, 1), (2, 128, 4, 8, 16, 2), (2, 96, 6, 8, 16, 3), (1, 100, 2, 48, 8, 1)]


def _ssd(shape, dtype, device, seed=0, h0=False):
    B, S, H, P, N, G = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)
    x = mk(B, S, H, P)
    dt = torch.nn.functional.softplus(mk(B, S, H)) * 0.1
    A = -torch.exp(mk(H))
    Bm, Cm = mk(B, S, G, N) * 0.3, mk(B, S, G, N) * 0.3
    D = mk(H) * 0.2
    h = mk(B, H, P, N) * 0.1 if h0 else None
    out = [x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), D, h]
    return [t.to(device) if t is not None else None for t in out]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_fp32_matches_sequential_ref(cuda, shape, h0):
    x, dt, A, Bm, Cm, D, h = _ssd(shape, torch.float32, cuda, seed=shape[1], h0=h0)
    before = sk.ssd_scan.launches
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, h, chunk=32)
    torch.cuda.synchronize()
    assert sk.ssd_scan.launches == before + 1
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h, return_state=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=1e-3)
    torch.testing.assert_close(hf, want_h, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("S", [1, 37, 256])
def test_ssd_kernel_bf16_full_width_matches_ref(cuda, S):
    x, dt, A, Bm, Cm, D, _ = _ssd((1, S, 24, 64, 128, 1), torch.bfloat16, cuda, seed=S)
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, return_state=True)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(hf, want_h, atol=2e-2, rtol=2e-2)


def test_ssd_kernel_reads_strided_inputs_and_its_gradient_is_the_plain_one(cuda):
    # x, B, C and dt as strided slices of one packed projection
    B, S, H, P, N = 2, 80, 4, 16, 8
    packed = torch.randn(B, S, H * P + 2 * N + H, device=cuda)
    packed[..., H * P :] *= 0.3
    packed[..., -H:] = torch.nn.functional.softplus(packed[..., -H:]) * 0.1
    x = packed[..., : H * P].unflatten(-1, (H, P))
    Bm = packed[..., H * P : H * P + N].unflatten(-1, (1, N))
    Cm = packed[..., H * P + N : H * P + 2 * N].unflatten(-1, (1, N))
    dt = packed[..., -H:]
    A = -torch.rand(H, device=cuda) - 0.5
    assert not any(t.is_contiguous() for t in (x, dt, Bm, Cm))
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, hf = ops.ssd_scan(*leaves, chunk=16)
    want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, return_state=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=1e-3)
    (y.square().sum() + hf.sum()).backward()
    plain = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    py, ph = ops.ssd_scan(*plain, chunk=16, impl="plain")
    (py.square().sum() + ph.sum()).backward()
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-3)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm, D, _ = _ssd((1, 16, 2, 8, 8, 1), torch.float16, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=16)
    x, dt, A, Bm, Cm, D, _ = _ssd((1, 16, 2, 8, 8, 1), torch.float32, cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_scan(x, dt.double(), A, Bm, Cm, D, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm, D, chunk=16)
    big = torch.zeros((1, 16, 1, 512), device=cuda)
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_scan(x, dt, A, big, big, D, chunk=16)


# --------------------------------------------------------------------------- the simulator's landing
def _events(n, n_segs, row_size, seed, big=False):
    """seg (with overflow rows past n_segs), lin, cnt as int64 storage on the CPU."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_segs + 2, size=n)
    lin = rng.integers(0, row_size, size=n)
    cnt = rng.integers(1, 50, size=n).astype(np.uint64)
    if big:  # counts near 2**64 and 2**63, so the sums wrap
        cnt = np.where(rng.random(n) < 0.5, np.uint64((1 << 64) - 1000), np.uint64((1 << 63) - 10))
    return torch.from_numpy(seg), torch.from_numpy(lin), torch.from_numpy(cnt.view(np.int64))


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("n,n_segs,row_size", [(2000, 1, 8), (2000, 5, 64), (2000, 16, 300), (100_000, 40, 1152)])
def test_segment_kernel_matches_plain_bit_for_bit(cuda, n, n_segs, row_size, big):
    seg, lin, cnt = _events(n, n_segs, row_size, seed=n_segs * row_size, big=big)
    want, want_bad = segment_scatter_ref(seg, lin, cnt, n_segs, row_size)
    before = ss.segment_scatter.launches
    table, bad = ss.segment_scatter(seg.to(cuda), lin.to(cuda), cnt.to(cuda), n_segs, row_size)
    torch.cuda.synchronize()
    assert ss.segment_scatter.launches == before + 1
    assert torch.equal(table.cpu(), want) and bad.item() == want_bad.item() == 0


def test_segment_kernel_edges(cuda):
    before = ss.segment_scatter.launches
    e = torch.empty(0, dtype=torch.int64, device=cuda)
    table, bad = ss.segment_scatter(e, e, e, 3, 5)
    assert table.shape == (3, 5) and table.count_nonzero() == 0 and bad.item() == 0
    seg = torch.full((64,), 9, dtype=torch.int64, device=cuda)
    zero = torch.zeros(64, dtype=torch.int64, device=cuda)
    assert ss.segment_scatter(seg, zero, zero + 1, 0, 16)[0].shape == (0, 16)
    assert ss.segment_scatter.launches == before  # empty input and no rows launch nothing
    table, bad = ss.segment_scatter(seg, zero, zero + 1, 4, 16)  # every event past the last row
    assert table.count_nonzero() == 0 and bad.item() == 0
    out_of_table = torch.tensor([0, 3], device=cuda)
    table, bad = ss.segment_scatter(torch.tensor([0, 1], device=cuda), out_of_table, out_of_table, 2, 2)
    assert bad.item() == 1 and table.tolist() == [[0, 0], [0, 0]]
    assert ss.segment_scatter.launches == before + 2


@pytest.mark.parametrize("big", [False, True])
def test_accumulate_entry_matches_plain(cuda, big):
    _, lin, cnt = _events(50_000, 0, 4096, seed=3, big=big)
    base = torch.from_numpy(np.random.default_rng(4).integers(0, 1 << 40, size=4096))
    want = base.clone()
    assert scatter_add_ref(want, lin, cnt).item() == 0
    dense = base.to(cuda)
    before = ss.scatter_add.launches
    assert ss.scatter_add(dense, lin.to(cuda), cnt.to(cuda)).item() == 0
    assert ss.scatter_add.launches == before + 1
    assert torch.equal(dense.cpu(), want)


@pytest.mark.parametrize("shape", [(1,), (257,), (7367,), (64, 3), (300, 9)])
def test_fold_kernel_matches_plain_bit_for_bit(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    # adversarial magnitudes so any reassociation changes the rounding
    vals = rng.uniform(-1.0, 1.0, size=shape) * (10.0 ** rng.integers(-8, 8, size=shape))
    before = ss.running_sum.launches
    got = ss.running_sum(torch.from_numpy(vals).to(cuda)).cpu()
    assert ss.running_sum.launches == before + 1
    assert torch.equal(got, running_sum_ref(torch.from_numpy(vals)))
    assert np.array_equal(got.numpy(), np.add.accumulate(vals, axis=0))
    ints = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, size=shape))
    assert torch.equal(ss.running_sum(ints.to(cuda)).cpu(), running_sum_ref(ints))


def test_batched_sweep_on_the_card_equals_numpy(cuda):
    from repro_torch.core.array_ops import get_backend
    from repro_torch.sim.batch import BatchJob, BatchRunner
    from repro_torch.sim.scenarios import divergent_draws

    ops = get_backend("torch")
    calls = {"segment_scatter": 0, "scatter_add_u64": 0}
    seg_op, add_op = ops.segment_scatter, ops.scatter_add_u64

    def seg_counted(seg, lin, cnt, n_segs, row_size):
        calls["segment_scatter"] += int(len(seg) > 0 and n_segs > 0)
        return seg_op(seg, lin, cnt, n_segs, row_size)

    def add_counted(dense, lin, cnt):
        calls["scatter_add_u64"] += int(len(lin) > 0)
        return add_op(dense, lin, cnt)

    draws = divergent_draws(4, seed=0)
    runs = {}
    for backend in ("torch", "numpy"):
        jobs = [BatchJob.make(d["scenario"], d["params"], config=dict(array_backend=backend)) for d in draws]
        before = (ss.segment_scatter.launches, ss.scatter_add.launches)
        ops.segment_scatter, ops.scatter_add_u64 = seg_counted, add_counted
        try:
            runs[backend] = BatchRunner(jobs, backend="batched").run()
        finally:
            del ops.segment_scatter, ops.scatter_add_u64
        launched = (ss.segment_scatter.launches - before[0], ss.scatter_add.launches - before[1])
        if backend == "torch":
            assert launched == (calls["segment_scatter"], calls["scatter_add_u64"])
            assert launched[0] >= 1 and launched[1] >= len(jobs) // 2
        else:
            assert launched == (0, 0)
    assert runs["torch"].failures() == [] and runs["torch"].oracle_failures() == []
    assert runs["torch"].signature() == runs["numpy"].signature()
