"""phi3-medium-14b [dense] — RoPE SwiGLU GQA (kv=10). [arXiv:2404.14219; unverified]

40 heads / 10 kv heads are not divisible by the 16-wide model axis; the
sharding policy auto-falls-back to FSDP-only attention params (DESIGN.md §4).
"""

from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    remat="full",
)

SMOKE = replace(
    CONFIG,
    n_layers=4,
    d_model=160,
    n_heads=5,
    n_kv_heads=5,
    d_ff=480,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
    remat="none",
    max_seq_len=256,
)
