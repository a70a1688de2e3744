"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave (attention
at position 4 of each 8-layer block), MoE every 2 layers, 16 experts top-2.
[arXiv:2403.19887; hf]

SSM layers use the Mamba-2 SSD form (kernel reuse across the pool; noted in
DESIGN.md §5) with d_inner = 2·d_model, head_dim 128 → 128 SSD heads.
"""

from dataclasses import replace

from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    use_rope=False,        # Jamba uses no positional embeddings
    attn_every=8,
    attn_offset=4,
    moe=MoEConfig(
        n_experts=16, top_k=2, expert_d_ff=24576,
        n_shared=0, shared_d_ff=0,
        moe_every=2, first_k_dense=0, capacity_factor=1.25,
    ),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=128, n_groups=1, conv_width=4, chunk=256),
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    remat="full",
)

SMOKE = replace(
    CONFIG,
    n_layers=8,            # one full superblock
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    moe=MoEConfig(
        n_experts=4, top_k=2, expert_d_ff=256,
        n_shared=0, shared_d_ff=0,
        moe_every=2, first_k_dense=0, capacity_factor=2.0,
    ),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=32, n_groups=1, conv_width=4, chunk=32),
    param_dtype="float32",
    compute_dtype="float32",
    opt_state_dtype="float32",
    remat="none",
    max_seq_len=256,
)
