"""qwen2-72b [dense] — GQA (kv=8) with QKV bias. [arXiv:2407.10671; hf]"""

from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    remat="full",
)

SMOKE = replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=448,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
    opt_state_dtype="float32",
    remat="none",
    max_seq_len=256,
)
