"""deepseek-7b [dense] — llama-arch GQA decoder. [arXiv:2401.02954; hf]"""

from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    remat="full",
)

SMOKE = replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=352,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
    remat="none",
    max_seq_len=256,
)
