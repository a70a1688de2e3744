"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, GQA kv=8.
Text backbone only (early-fusion frontend out of scope for the LM family).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from dataclasses import replace

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,             # dense-path width (shared expert)
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(
        n_experts=16, top_k=1, expert_d_ff=8192,
        n_shared=1, shared_d_ff=8192,
        moe_every=1, first_k_dense=0, capacity_factor=1.25,
    ),
    param_dtype="bfloat16",
    remat="full",
)

SMOKE = replace(
    CONFIG,
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    moe=MoEConfig(
        n_experts=4, top_k=1, expert_d_ff=256,
        n_shared=1, shared_d_ff=256,
        moe_every=1, first_k_dense=0, capacity_factor=2.0,
    ),
    param_dtype="float32",
    compute_dtype="float32",
    remat="none",
    max_seq_len=256,
)
