"""mamba2-130m [ssm] — attention-free SSD. [arXiv:2405.21060; unverified]"""

from dataclasses import replace

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                # no FFN: the block is the SSD mixer alone
    vocab_size=50280,      # padded to 50304 for TP
    tie_embeddings=True,
    use_rope=False,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1, conv_width=4, chunk=256),
    param_dtype="float32",
    compute_dtype="bfloat16",
    remat="full",
)

SMOKE = replace(
    CONFIG,
    n_layers=3,
    d_model=128,
    vocab_size=512,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=32, n_groups=1, conv_width=4, chunk=32),
    compute_dtype="float32",
    max_seq_len=256,
)
