"""The CUDA flash-attention kernel against its plain version, on the card.

Imports torch and the port only (the card's machine has no JAX).  Every
test needs an NVIDIA GPU and skips without one.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref

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
