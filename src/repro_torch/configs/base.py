"""Model/run configuration dataclasses + the architecture registry.

Every assigned architecture is a module in this package exporting ``CONFIG``
(the exact published shape) and ``SMOKE`` (a reduced same-family config for
CPU tests).  ``get_config(arch_id)`` / ``list_archs()`` are the public API;
``--arch <id>`` everywhere resolves through them.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import torch

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "ARCH_IDS",
    "torch_dtype",
]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype name ("float32", "bfloat16", ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared: int = 0
    shared_d_ff: int = 0
    moe_every: int = 1  # a layer is MoE iff (i % moe_every == moe_every-1) and i >= first_k_dense
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax"  # softmax | sigmoid (deepseek-v2 uses softmax)
    router_scale: bool = True  # normalize top-k weights to sum to 1


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 = no q compression (v2-lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_channels(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.n_groups * self.d_state


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    hidden_act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    rms_eps: float = 1e-6
    scale_embedding: bool = False  # gemma: embeddings × sqrt(d_model)
    # hybrid attention placement: layer i is attention iff
    # i % attn_every == attn_offset; all other layers are SSM.
    attn_every: int = 1
    attn_offset: int = 0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper): n_layers is the decoder depth
    encdec: bool = False
    n_enc_layers: int = 0
    # VLM (paligemma): stubbed frontend supplies this many prefix embeddings
    vision_tokens: int = 0
    prefix_lm: bool = False
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: str = "none"  # none | dots | full
    # logits softcap (gemma-style), 0 = off
    logit_softcap: float = 0.0
    max_seq_len: int = 8192
    # decode-step layer loop: "inplace" = fori_loop with in-place cache
    # updates (single cache buffer — the serving default); "scan" = lax.scan
    # xs/ys (double-buffers the cache; kept for §Perf before/after evidence)
    decode_loop: str = "inplace"
    # KV-cache storage dtype ("bfloat16" default; "float8_e4m3fn" halves the
    # decode memory term — attention math stays fp32 either way)
    kv_cache_dtype: str = ""  # "" → compute_dtype

    # ---- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a TP-friendly multiple of 128 (MaxText-style)."""
        m = 128
        return ((self.vocab_size + m - 1) // m) * m

    def layer_is_attn(self, i: int) -> bool:
        if self.ssm is None:
            return True
        if self.family == "ssm":
            return False
        return i % self.attn_every == self.attn_offset

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_k_dense:
            return False
        return (i % self.moe.moe_every) == (self.moe.moe_every - 1)

    @property
    def superblock_period(self) -> int:
        """Smallest repeating layer pattern (bounded by n_layers)."""
        import math

        p = 1
        if self.ssm is not None and self.family != "ssm":
            p = math.lcm(p, self.attn_every)
        if self.moe is not None:
            p = math.lcm(p, self.moe.moe_every)
        body = self.n_layers - (self.moe.first_k_dense if self.moe else 0)
        if body % p != 0:
            # fall back to treating the whole body as one block (no repeat)
            p = body
        return p

    def param_tdtype(self) -> torch.dtype:
        """``param_dtype`` as a torch dtype (the reference's ``param_jdtype``)."""
        return torch_dtype(self.param_dtype)

    def compute_tdtype(self) -> torch.dtype:
        """``compute_dtype`` as a torch dtype (the reference's ``compute_jdtype``)."""
        return torch_dtype(self.compute_dtype)

    # rough parameter counts for roofline MODEL_FLOPS -------------------------
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        if self.mla is not None:
            m = self.mla
            q = self.d_model * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            kv_down = self.d_model * (m.kv_lora_rank + m.qk_rope_dim)
            kv_up = m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            o = self.n_heads * m.v_head_dim * self.d_model
            return q + kv_down + kv_up + o
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        return q + kv + o

    def _ffn_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # gate, up, down

    def _ssm_params(self) -> int:
        s = self.ssm
        d_in = s.d_inner(self.d_model)
        nh = s.n_heads(self.d_model)
        in_proj = self.d_model * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
        conv = s.conv_width * s.conv_channels(self.d_model)
        out = d_in * self.d_model
        return in_proj + conv + out + 2 * nh  # + A, D

    def param_count(self, active_only: bool = False) -> int:
        total = self.padded_vocab * self.d_model  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * self.d_model
        layers = range(self.n_layers)
        for i in layers:
            total += 2 * self.d_model  # norms
            if self.layer_is_attn(i):
                total += self._attn_params()
            else:
                total += self._ssm_params()
            if self.layer_is_moe(i):
                m = self.moe
                n_e = m.top_k if active_only else m.n_experts
                total += n_e * self._ffn_params(m.expert_d_ff)
                if m.n_shared:
                    total += self._ffn_params(m.shared_d_ff * m.n_shared)
                total += self.d_model * m.n_experts  # router
            elif self.d_ff > 0:
                total += self._ffn_params(self.d_ff)
        if self.encdec:
            for _ in range(self.n_enc_layers):
                total += 2 * self.d_model + self._attn_params() + self._ffn_params(self.d_ff)
            # decoder cross-attention
            total += self.n_layers * (self._attn_params() + self.d_model)
        return total


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS: Tuple[str, ...] = (
    "jamba-1.5-large-398b",
    "deepseek-7b",
    "qwen2-72b",
    "phi3-medium-14b",
    "gemma-7b",
    "whisper-medium",
    "paligemma-3b",
    "deepseek-v2-lite-16b",
    "llama4-scout-17b-a16e",
    "mamba2-130m",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _load(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(f"{__package__}.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _load(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _load(arch_id).SMOKE


def list_archs() -> List[str]:
    return list(ARCH_IDS)


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    """Which of the four assigned shapes run for this architecture.

    ``long_500k`` needs sub-quadratic attention → SSM/hybrid only (the
    assignment's rule); every arch here has a decoder, so decode_32k always
    applies.
    """
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        out.append("long_500k")
    return out
