"""The bf16 tensor-core SSD kernel's arithmetic, on the CPU, through its plain form.

``ssd_tiled_ref`` computes the tensor-core kernel's three phases (per-tile
``C Bᵀ`` and chunk states, the pass across chunks, the per-tile outputs) and
rounds to bf16 where the kernel does: M, the state entering each tile's
``C hᵀ`` and ``x·w`` before the state product, each as one term or as
hi + lo.  It is held here against the reference's Pallas kernel in interpret
mode (``impl="pallas"``, as ``tests/test_torch_ssm.py`` runs it) and its
sequential oracle ``ssd_ref``, and against the port's ``ssd_ref``.  The
kernel itself cannot run here: on the card it is held against ``ssd_ref`` by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  Tolerances:

* fp32 (no rounding): atol 5e-5 / rtol 1e-3 (``tests/test_kernels.py``'s).
* bf16: y within atol 2e-2 / rtol 2e-2 (``SSD_BF16_TOL``), the final state
  within 1e-3 relative L2 (``SSD_H_REL``), as ``chip_smoke.py`` holds the
  kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels.ref import ssd_ref, ssd_tiled_ref

SSD_SHAPES = [  # tests/test_kernels.py's set (B, S, H, P, N, G, chunk), and a ragged S with P = 48
    (1, 64, 2, 16, 8, 1, 64),
    (2, 128, 4, 8, 16, 2, 32),
    (2, 96, 6, 8, 16, 3, 32),
    (1, 100, 2, 48, 8, 1, 4),
]
FP32 = dict(atol=5e-5, rtol=1e-3)
BF16 = dict(atol=2e-2, rtol=2e-2)
H_REL = 1e-3
KERNEL = dict(m_terms=2, h_terms=2, xw_terms=2, cum64=True)  # the rounding the tensor-core kernel does


def _inputs(B, S, H, P, N, G, seed=0, dt_shift=-1.0, dt_scale=1.0, x_scale=1.0, h0=False):
    """x, B, C rounded to bf16 (as numpy fp32 holding bf16 values), the rest fp32."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()  # noqa: E731
    x = bf(rng.standard_normal((B, S, H, P)) * x_scale)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)) + dt_shift)) * dt_scale).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm, Cm = bf(rng.standard_normal((B, S, G, N)) * 0.3), bf(rng.standard_normal((B, S, G, N)) * 0.3)
    D = (rng.standard_normal(H) * 0.2).astype(np.float32)
    hs = (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32) if h0 else None
    return x, dt, A, Bm, Cm, D, hs


def _torch(arrays, dtype=torch.float32):
    x, dt, A, Bm, Cm, D, h0 = (torch.from_numpy(a) if a is not None else None for a in arrays)
    return [x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), D, h0]


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk", SSD_SHAPES)
def test_tiled_fp32_matches_pallas_and_ref(B, S, H, P, N, G, chunk, with_h0):
    arrays = _inputs(B, S, H, P, N, G, seed=S + N, h0=with_h0)
    j = [jnp.asarray(a) if a is not None else None for a in arrays]
    py, ph = ref_ops.ssd_scan(*j[:6], h0=j[6], chunk=chunk, impl="pallas")
    ry, rh = jax_ssd_ref(*j[:6], h0=j[6], return_state=True)
    t = _torch(arrays)
    sy, sh = ssd_ref(*t, return_state=True)
    for q in (1, 2, 3, 6):  # chunk lengths the kernel takes, even and ragged
        y, h = ssd_tiled_ref(*t, tiles_per_chunk=q)
        assert y.dtype == torch.float32 and y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
        for got, want in ((y, py), (y, ry), (y, sy), (h, ph), (h, rh), (h, sh)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("S", [37, 256])
def test_tiled_bf16_at_full_width_matches_pallas_and_ref(S):
    """mamba2-130m's SSD width (H=24, P=64, N=128, G=1) in bf16, with the
    kernel's rounding: within the bf16 tolerance of the reference's Pallas
    kernel and of the sequential scan, the final state within SSD_H_REL."""
    arrays = _inputs(1, S, 24, 64, 128, 1, seed=S)
    x, dt, A, Bm, Cm, D, _ = arrays
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    py, ph = ref_ops.ssd_scan(jb(x), jnp.asarray(dt), jnp.asarray(A), jb(Bm), jb(Cm), jnp.asarray(D),
                              chunk=256, impl="pallas")
    t = _torch(arrays, torch.bfloat16)
    sy, sh = ssd_ref(*t, return_state=True)
    y, h = ssd_tiled_ref(*t, tiles_per_chunk=sk.tiles_per_chunk(1, 24, S, 132), **KERNEL)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    for want in (np.asarray(py, np.float32), sy.float().numpy()):
        np.testing.assert_allclose(y.float().numpy(), want, **BF16)
    assert _rel(h, torch.from_numpy(np.array(ph))) <= H_REL and _rel(h, sh) <= H_REL


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [37, 200])
def test_tiled_at_head_dim_128_matches_pallas_and_ref(S, with_h0):
    """jamba's SSD head dim and d_state (P = 128, N = 128, G = 1; 8 heads
    here) at ragged lengths: without rounding, within FP32 of the
    reference's Pallas kernel and its sequential scan; in bf16 with the
    kernel's rounding and the chunk length it picks at P = 128, within the
    bf16 tolerance of both and the final state within SSD_H_REL.  (At P =
    128 the kernel gives each warpgroup 64 of the state's rows and y's
    columns, which changes no sum, so the model is the P = 64 one.)"""
    arrays = _inputs(1, S, 8, 128, 128, 1, seed=S + 128, h0=with_h0)
    x, dt, A, Bm, Cm, D, h0 = arrays
    j = [jnp.asarray(a) if a is not None else None for a in arrays]
    py, ph = ref_ops.ssd_scan(*j[:6], h0=j[6], chunk=256, impl="pallas")
    ry, rh = jax_ssd_ref(*j[:6], h0=j[6], return_state=True)
    y, h = ssd_tiled_ref(*_torch(arrays), tiles_per_chunk=2)
    for got, want in ((y, py), (y, ry), (h, ph), (h, rh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    t = _torch(arrays, torch.bfloat16)
    sy, sh = ssd_ref(*t, return_state=True)
    y, h = ssd_tiled_ref(*t, tiles_per_chunk=sk.tiles_per_chunk(1, 8, S, 132, 128), **KERNEL)
    assert y.dtype == torch.bfloat16 and y.shape == (1, S, 8, 128) and h.shape == (1, 8, 128, 128)
    for want in (np.asarray(py, np.float32), sy.float().numpy()):
        np.testing.assert_allclose(y.float().numpy(), want, **BF16)
    assert _rel(h, torch.from_numpy(np.array(ph))) <= H_REL and _rel(h, sh) <= H_REL


@pytest.mark.parametrize("point", ["xw", "m", "h"])
def test_one_bf16_term_misses_where_two_do_not(point):
    """Large dt and |x| ~ 30 (outputs up to ~1300): one bf16 term of x·w
    puts the final state past SSD_H_REL, one term of M or of the entering
    state puts outputs past the bf16 tolerance (large terms cancel); the
    kernel's two terms keep both within."""
    arrays = _inputs(1, 256, 24, 64, 128, 1, seed=3, dt_shift=2.0, x_scale=30.0)
    t = _torch(arrays, torch.bfloat16)
    sy, sh = ssd_ref(*t, return_state=True)

    def misses(**terms):
        y, h = ssd_tiled_ref(*t, **terms)
        outside = int((~torch.isclose(y.float(), sy.float(), **BF16)).sum())
        return outside > 0 or _rel(h, sh) > H_REL

    assert not misses(**KERNEL)
    assert misses(**{**KERNEL, f"{point}_terms": 1})


def test_an_fp32_prefix_misses_where_the_kernels_fp64_prefix_does_not():
    """Decays as trained gates make them (|A| ~ 150, dt mixing ~2 and ~0.003):
    the prefix cum of A·dt reaches thousands inside a 64-row tile, where two
    fp32 prefixes differ with an error of their spacing, and outputs where
    large terms cancel fall outside the bf16 tolerance of the sequential
    scan; the kernel's fp64 prefix keeps every output within it, as close to
    the fp64 scan as the sequential fp32 one (ROADMAP queue 3, item 12)."""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 1, 256, 24, 64, 128
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    x = bf(rng.standard_normal((B, S, H, P)) * 30)
    dt = np.where(rng.random((B, S, H)) < 0.5, rng.exponential(2.0, (B, S, H)), rng.exponential(0.003, (B, S, H)))
    A = -np.exp(rng.standard_normal(H) * 0.5 + 5)
    Bm, Cm = bf(rng.standard_normal((B, S, 1, N)) * 0.3), bf(rng.standard_normal((B, S, 1, N)) * 0.3)
    t = [x, torch.from_numpy(dt.astype(np.float32)), torch.from_numpy(A.astype(np.float32)), Bm, Cm, torch.ones(H)]
    sy, dy = ssd_ref(*t), ssd_ref(*[a.double() for a in t])

    def outside(y, want):
        return int((~torch.isclose(y.double(), want.double(), **BF16)).sum())

    assert outside(sy, dy) == 0
    for cum64, missed in ((False, True), (True, False)):
        y, _ = ssd_tiled_ref(*t, tiles_per_chunk=2, **{**KERNEL, "cum64": cum64})
        assert (outside(y, sy) > 0) == missed and (outside(y, dy) > 0) == missed, cum64


def test_tiled_chunks_and_ragged_tiles_agree():
    """The chunk length changes only where the state passes between
    kernels: y and h agree across 1 to 8 tiles per chunk at a ragged S
    with h0, to fp32 rounding."""
    t = _torch(_inputs(2, 300, 3, 16, 8, 1, seed=9, h0=True))
    outs = [ssd_tiled_ref(*t, tiles_per_chunk=q) for q in range(1, sk.MAX_CHUNK_TILES + 1)]
    for y, h in outs[1:]:
        torch.testing.assert_close(y, outs[0][0], **FP32)
        torch.testing.assert_close(h, outs[0][1], **FP32)


def test_routes_and_chunk_lengths():
    """bf16 runs the tensor-core kernel, fp32 the SIMT one.  The chunk
    length fills the output kernel's waves (two blocks per SM on 132 SMs
    at P = 64, one at P = 128) against the states it passes: the training
    microbatch B=4, S=256 takes 2 tiles per chunk (192 blocks), train_4k's
    B=1, S=4096 takes 6 (264 blocks: one full wave); jamba's 128 heads of
    128 take the whole prompt as one chunk at S=132 (3 tiles) and S=404 (7
    tiles), 128 blocks, one wave, where shorter chunks would add waves and
    states of twice the bytes."""
    assert sk.select_route(torch.bfloat16) == "wgmma" and sk.select_route(torch.float32) == "simt"
    with pytest.raises(ValueError, match="bfloat16"):
        sk.select_route(torch.float16)
    assert sk.SOURCE.endswith("ssd_scan_wgmma.cu") and sk.SIMT_SOURCE.endswith("ssd_scan.cu")
    picks = {(B, S): sk.tiles_per_chunk(B, 24, S, 132) for B, S in ((4, 256), (1, 4096), (1, 1000), (1, 1), (4, 4096))}
    assert picks == {(4, 256): 2, (1, 4096): 6, (1, 1000): 2, (1, 1): 1, (4, 4096): 8}
    assert {S: sk.tiles_per_chunk(1, 128, S, 132, 128) for S in (132, 404)} == {132: 3, 404: 7}
    assert sk.WGMMA_HEAD_DIMS == (64, 128) and sk.WGMMA_STATES == (64, 128)
