"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64 routed experts top-6
+ 2 shared experts; first layer dense. [arXiv:2405.04434; hf]"""

from dataclasses import replace

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MLA replaces GQA; kept for bookkeeping
    d_ff=10944,            # dense FFN width of the first (non-MoE) layer
    vocab_size=102400,
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(
        n_experts=64, top_k=6, expert_d_ff=1408,
        n_shared=2, shared_d_ff=1408,
        moe_every=1, first_k_dense=1, capacity_factor=1.25,
    ),
    param_dtype="bfloat16",
    remat="full",
)

SMOKE = replace(
    CONFIG,
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=320,
    vocab_size=512,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(
        n_experts=8, top_k=2, expert_d_ff=64,
        n_shared=1, shared_d_ff=64,
        moe_every=1, first_k_dense=1, capacity_factor=2.0,
    ),
    param_dtype="float32",
    compute_dtype="float32",
    remat="none",
    max_seq_len=256,
)
