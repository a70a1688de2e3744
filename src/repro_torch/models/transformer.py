"""The dense decoder LM (deepseek-7b and the other dense GQA configs).

``Transformer`` holds the embedding, an ``nn.ModuleList`` of decoder layers,
the final norm and the LM head, with the reference's parameter shapes leaf
for leaf (the reference stacks the layers on a leading axis; here each layer
is its own module, and :mod:`.convert` moves weights across).

Entry points, batch-major as in the reference:

    model.init_cache(batch, max_len)              → {"k", "v"}, (L, B, max_len, Hkv, D)
    model.prefill(tokens)                         → (last-position logits, prompt cache)
    model.decode_step(cache, tokens, pos)         → (logits, cache), cache written in place

The stacked cache leaf ``(L, B, S, Hkv, D)`` is the reference's, so serving
writes slots and slices buckets on axis 1 as the reference engine does.
MoE, MLA, SSM, encoder-decoder and VLM configs raise at construction: they
come with later slices of the port.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig, torch_dtype
from .attention import gqa_apply, gqa_decode, gqa_defs
from .layers import (
    embed_apply,
    embed_defs,
    ffn_apply,
    ffn_defs,
    lm_head_defs,
    logits_apply,
    rmsnorm,
    rmsnorm_defs,
)
from .params import ParamTree, init_params

__all__ = ["Transformer", "model_defs", "check_supported"]

Cache = Dict[str, torch.Tensor]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config this slice cannot run,
    naming the slice of the port that brings it."""
    later = [
        (cfg.moe is not None, "MoE", "the MoE/MLA slice"),
        (cfg.mla is not None, "MLA attention", "the MoE/MLA slice"),
        (cfg.ssm is not None, "SSM layers", "the SSM slice"),
        (cfg.encdec, "an encoder-decoder stack", "the enc-dec/prefix-LM slice"),
        (cfg.vision_tokens > 0, "vision prefix tokens", "the enc-dec/prefix-LM slice"),
    ]
    for present, what, where in later:
        if present:
            raise NotImplementedError(f"{cfg.name} uses {what}, which the port brings in {where}")


def _layer_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d: Dict[str, Any] = {"ln1": rmsnorm_defs(cfg.d_model), "attn": gqa_defs(cfg)}
    if cfg.d_ff > 0:
        d["ln2"] = rmsnorm_defs(cfg.d_model)
        d["ffn"] = ffn_defs(cfg.d_model, cfg.d_ff)
    # The reference initialises the layer stack as one (n_layers, ...) leaf
    # per parameter, so a normal init reads n_layers as its fan-in; each
    # layer's leaf here keeps that std.
    std = cfg.n_layers ** -0.5
    return {
        k: {n: replace(p, scale=std) if p.init == "normal" else p for n, p in sub.items()}
        for k, sub in d.items()
    }


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """ParamDef tree: ``embed``, ``final_norm``, ``lm_head`` (untied) and
    ``layers/<i>/{ln1, attn, ln2, ffn}``."""
    check_supported(cfg)
    d: Dict[str, Any] = {"embed": embed_defs(cfg), "final_norm": rmsnorm_defs(cfg.d_model)}
    if not cfg.tie_embeddings:
        d["lm_head"] = lm_head_defs(cfg)
    d["layers"] = {str(i): _layer_defs(cfg) for i in range(cfg.n_layers)}
    return d


class Transformer(nn.Module):
    """Dense GQA decoder with seeded random weights on ``device``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        device = torch.device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        tree = init_params(model_defs(cfg), generator, cfg.param_tdtype(), device)
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.lm_head = ParamTree(tree["lm_head"]) if "lm_head" in tree else None
        self.layers = nn.ModuleList(ParamTree(tree["layers"][str(i)]) for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def init_cache(self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None) -> Cache:
        """Zeroed decode cache ``{"k", "v"}`` of ``(L, batch, max_len, Hkv, D)``."""
        cfg = self.cfg
        if dtype is None:
            dtype = torch_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype else cfg.compute_tdtype()
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device),
        }

    def _ffn(self, lp, x: torch.Tensor) -> torch.Tensor:
        if "ffn" not in lp:
            return x
        return x + ffn_apply(lp["ffn"], rmsnorm(lp["ln2"], x, self.cfg.rms_eps), self.cfg.hidden_act)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, attn_impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
        """Full causal forward over ``tokens`` ``(B, S)``.  Returns the
        last-position fp32 logits ``(B, V_padded)`` and the prompt cache
        ``{"k", "v"}`` of ``(L, B, S, Hkv, D)``; the serving layer copies it
        into its slot buffers."""
        cfg = self.cfg
        x = embed_apply(self.embed, tokens, cfg)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        ks, vs = [], []
        for lp in self.layers:
            h = rmsnorm(lp["ln1"], x, cfg.rms_eps)
            out, kv = gqa_apply(lp["attn"], h, cfg, positions, attn_impl=attn_impl)
            x = self._ffn(lp, x + out)
            ks.append(kv["k"])
            vs.append(kv["v"])
        x = rmsnorm(self.final_norm, x, cfg.rms_eps)
        logits = logits_apply(self.embed, self.lm_head, x[:, -1:], cfg)[:, 0]
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}

    @torch.no_grad()
    def decode_step(
        self,
        cache: Cache,
        tokens: torch.Tensor,  # (B,) next input token ids
        pos: torch.Tensor,  # (B,) their positions (0-based)
    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step for every sequence in the batch → ``(logits, cache)``.

        The new K/V are written **in place** into ``cache`` (which may be a
        view, such as a bucket's slice of the engine's cache): the reference
        donates its cache buffer to the same step, so callers hold no other
        copy either way.  The returned cache is ``cache`` itself."""
        cfg = self.cfg
        x = embed_apply(self.embed, tokens[:, None], cfg)[:, 0]
        for i, lp in enumerate(self.layers):
            h = rmsnorm(lp["ln1"], x, cfg.rms_eps)
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            x = self._ffn(lp, x + gqa_decode(lp["attn"], h, cfg, layer_cache, pos))
        x = rmsnorm(self.final_norm, x, cfg.rms_eps)
        logits = logits_apply(self.embed, self.lm_head, x[:, None], cfg)[:, 0]
        return logits, cache
