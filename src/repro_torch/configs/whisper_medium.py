"""whisper-medium [audio] — encoder-decoder; conv frontend STUBBED:
input_specs() provides precomputed frame embeddings. [arXiv:2212.04356]"""

from dataclasses import replace

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,          # decoder depth
    n_enc_layers=24,
    encdec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,     # padded to 51968 for TP
    use_rope=False,       # whisper uses absolute positions (sinusoidal stub)
    param_dtype="bfloat16",
    remat="dots",
)

SMOKE = replace(
    CONFIG,
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=384,
    param_dtype="float32",
    compute_dtype="float32",
    remat="none",
    max_seq_len=256,
)
