"""The fp32 SIMT kernels' orders of work, on the CPU, through their plain forms.

The fp32 SSD kernels (``csrc/ssd_scan.cu``) run the chunked-parallel form
one 64-row tile a chunk: ``C Bᵀ`` per (batch, group, tile), each tile's own
state, the states passed across tiles from h0, then the outputs.
``ssd_tiled_ref`` with no rounding terms and ``tiles_per_chunk=1`` is that
order, held here against the reference's Pallas kernel in interpret mode
(``impl="pallas"``) and its sequential ``ssd_ref`` at the fp32 tolerance
(atol 5e-5 / rtol 1e-3, ``tests/test_kernels.py``'s).  The fp32 flash
forward (``csrc/flash_attention.cu``) walks kv tiles of 64 columns (32 at
head dim 256) with an online softmax: ``flash_blocked_ref`` at those blocks
is held against the reference's ``_xla_flash`` and the full softmax at
the fp32 tolerance (atol 2e-5 / rtol 1e-4).  The kernels themselves are
held against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Also here: the routes that send fp32 to these kernels,
the SSD's FLOP count (the function's least work) and its scratch shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels.ref import attention_ref, flash_blocked_ref, ssd_ref, ssd_tiled_ref

SSD_FP32 = dict(atol=5e-5, rtol=1e-3)
FLASH_FP32 = dict(atol=2e-5, rtol=1e-4)
#: (B, S, H, P, N, G, chunk of the Pallas kernel): P = 48, G = 3, lengths off the 64-row tile
SSD_CASES = [
    (1, 100, 2, 48, 8, 1, 4),
    (2, 96, 6, 8, 16, 3, 32),
    (2, 130, 6, 48, 16, 3, 10),
]


def _ssd_inputs(B, S, H, P, N, G, seed, h0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    D = (rng.standard_normal(H) * 0.2).astype(np.float32)
    hs = (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32) if h0 else None
    return x, dt, A, Bm, Cm, D, hs


def _torch(arrays):
    return [torch.from_numpy(a) if a is not None else None for a in arrays]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk", SSD_CASES)
def test_one_tile_a_chunk_matches_pallas_and_sequential_ref(B, S, H, P, N, G, chunk, with_h0):
    """The fp32 kernels' order (one tile a chunk, no rounding) against the
    reference's Pallas kernel, its ``ssd_ref`` and the port's ``ssd_ref``."""
    arrays = _ssd_inputs(B, S, H, P, N, G, seed=S + P + G, h0=with_h0)
    j = [jnp.asarray(a) if a is not None else None for a in arrays]
    py, ph = ref_ops.ssd_scan(*j[:6], h0=j[6], chunk=chunk, impl="pallas")
    ry, rh = jax_ssd_ref(*j[:6], h0=j[6], return_state=True)
    t = _torch(arrays)
    sy, sh = ssd_ref(*t, return_state=True)
    y, h = ssd_tiled_ref(*t, tiles_per_chunk=1)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N) and y.dtype == h.dtype == torch.float32
    for got, want in ((y, py), (y, ry), (y, sy), (h, ph), (h, rh), (h, sh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_FP32)


@pytest.mark.parametrize("with_h0", [False, True])
def test_one_tile_a_chunk_at_full_width_matches_sequential_ref(with_h0):
    """mamba2-130m's SSD width (H=24, P=64, N=128, G=1) in fp32 over five
    tiles, the last ragged: within the fp32 tolerance of the reference."""
    arrays = _ssd_inputs(1, 300, 24, 64, 128, 1, seed=7, h0=with_h0)
    j = [jnp.asarray(a) if a is not None else None for a in arrays]
    ry, rh = jax_ssd_ref(*j[:6], h0=j[6], return_state=True)
    y, h = ssd_tiled_ref(*_torch(arrays), tiles_per_chunk=1)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **SSD_FP32)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **SSD_FP32)


def test_empty_sequence_passes_h0_through():
    """S = 0: no tile, so y is empty and the final state is h0 exactly, as
    the reference's scan gives for a sequence whose every dt is 0 (each step
    then keeps the state)."""
    x, _, A, Bm, Cm, D, h0 = _torch(_ssd_inputs(2, 0, 4, 16, 8, 2, seed=1, h0=True))
    y, h = ssd_tiled_ref(x, torch.zeros(2, 0, 4), A, Bm, Cm, D, h0, tiles_per_chunk=1)
    assert y.shape == (2, 0, 4, 16) and torch.equal(h, h0)
    arrays = _ssd_inputs(2, 37, 4, 16, 8, 2, seed=2, h0=False)
    _, rh = jax_ssd_ref(*(jnp.asarray(a) for a in arrays[:1]), jnp.zeros((2, 37, 4)),
                        *(jnp.asarray(a) for a in arrays[2:6]), h0=jnp.asarray(h0.numpy()), return_state=True)
    np.testing.assert_allclose(np.asarray(rh), h0.numpy(), rtol=0, atol=0)


def _flops_by_hand(B, S, H, P, N, G):
    """Per tile of r rows: C Bᵀ's lower triangle (with its diagonal) per
    group, M X's per head, then C h_inᵀ and the state product per head."""
    total = 0
    for t0 in range(0, S, 64):
        r = min(64, S - t0)
        tri = r * (r + 1) // 2
        total += G * tri * 2 * N + H * (tri * 2 * P + 2 * r * N * P + 2 * r * N * P)
    return B * total


@pytest.mark.parametrize("B,S,H,P,N,G", [(4, 256, 24, 64, 128, 1), (1, 4096, 24, 64, 128, 1), (2, 130, 6, 48, 16, 3),
                                         (1, 1, 2, 8, 8, 2), (3, 0, 4, 16, 8, 1)])
def test_ssd_flops_counts_the_least_work(B, S, H, P, N, G):
    assert sk.ssd_flops(B, S, H, P, N, G) == _flops_by_hand(B, S, H, P, N, G)


def test_ssd_bound_at_the_training_microbatch():
    """B=4, S=256 at mamba2-130m's width: 916,062,208 FLOPs, 0.01367 ms at
    67 TFLOP/s (fp32, operations-bound); in bf16 the bytes still bound it
    (0.003003 ms at 3.35 TB/s against 0.000926 ms of operations at 989)."""
    flops = sk.ssd_flops(4, 256, 24, 64, 128, 1)
    assert flops == 916_062_208
    assert round(flops / 67e12 * 1e3, 5) == 0.01367
    assert round(sk.ssd_bytes(4, 256, 24, 64, 128, 1, 4) / 3.35e12 * 1e3, 5) < 0.01367
    bf16_bytes_ms = sk.ssd_bytes(4, 256, 24, 64, 128, 1, 2) / 3.35e12 * 1e3
    assert round(bf16_bytes_ms, 6) == 0.003003 and flops / 989e12 * 1e3 < bf16_bytes_ms


def test_simt_scratch_shapes():
    """C Bᵀ per (batch, group, tile); tile states per (batch, tile, head,
    64-row slice of P) with d_state padded to 64, 128 or 256; a decay per
    (batch, tile, head)."""
    assert sk.simt_scratch(1, 4096, 24, 1, 64, 128) == ((1, 1, 64, 64, 64), (1, 64, 24, 1, 128, 64), (1, 64, 24))
    assert sk.simt_scratch(2, 130, 6, 3, 72, 200) == ((2, 3, 3, 64, 64), (2, 3, 6, 2, 256, 64), (2, 3, 6))
    assert sk.simt_scratch(1, 0, 4, 1, 8, 5) == ((1, 1, 0, 64, 64), (1, 0, 4, 1, 64, 64), (1, 0, 4))


def test_fp32_routes_and_sources():
    """fp32 takes the SIMT kernels: the flash forward and backward at every
    head dim, the SSD scan; each SSD or backward call launches three CUDA
    kernels."""
    for D in fa.SUPPORTED_HEAD_DIMS:
        assert fa.select_route(torch.float32, D) == "simt" and fa.select_bwd_route(torch.float32, D) == "simt"
    assert sk.select_route(torch.float32) == "simt"
    assert fa.SIMT_SOURCE.endswith("csrc/flash_attention.cu") and sk.SIMT_SOURCE.endswith("csrc/ssd_scan.cu")
    assert sk.KERNELS_PER_CALL == fa.BWD_LAUNCHES == 3


def _qkv(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(1, 70, 2, 1, 32), (2, 130, 4, 2, 64), (1, 200, 8, 2, 128),
                                          (1, 97, 4, 4, 256), (1, 75, 4, 1, 256)])
def test_flash_at_the_simt_forward_tiles_matches_reference(B, S, Hq, Hkv, D, causal):
    """The online softmax over kv tiles of 64 columns (32 at D = 256), as the
    fp32 forward walks them, against the reference's blocked form at the
    same blocks and the full softmax, at every head dim, GQA and MQA."""
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=S + D)
    blk = 32 if D == 256 else 64
    want = ref_ops._xla_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=D ** -0.5, causal=causal,
                              prefix_len=0, q_block=blk, kv_block=blk)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_blocked_ref(tq, tk, tv, causal=causal, q_block=blk, kv_block=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_FP32)
    np.testing.assert_allclose(got.numpy(), attention_ref(tq, tk, tv, causal=causal).numpy(), **FLASH_FP32)
