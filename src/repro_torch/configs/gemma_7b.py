"""gemma-7b [dense] — GeGLU, head_dim=256, tied embeddings, scaled embed.
[arXiv:2403.08295; hf]"""

from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    hidden_act="gelu",
    tie_embeddings=True,
    scale_embedding=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    remat="full",
)

SMOKE = replace(
    CONFIG,
    n_layers=3,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
    remat="none",
    max_seq_len=256,
)
