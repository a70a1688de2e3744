"""paligemma-3b [vlm] — gemma-2b backbone + SigLIP frontend STUB (256
precomputed patch embeddings), prefix-LM masking. [arXiv:2407.07726; hf]"""

from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,          # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    hidden_act="gelu",
    tie_embeddings=True,
    scale_embedding=True,
    vision_tokens=256,
    prefix_lm=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    remat="full",
)

SMOKE = replace(
    CONFIG,
    n_layers=3,
    d_model=96,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    vision_tokens=16,
    param_dtype="float32",
    compute_dtype="float32",
    remat="none",
    max_seq_len=256,
)
