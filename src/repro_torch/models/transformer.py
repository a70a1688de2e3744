"""The decoder LM: the dense GQA family (deepseek-7b and the other dense
configs), the MoE family with GQA (llama4-scout) or MLA attention
(deepseek-v2-lite), and the pure-SSM family (mamba2-130m).

``Transformer`` holds the embedding, an ``nn.ModuleList`` of decoder layers,
the final norm and the LM head, with the reference's parameter shapes leaf
for leaf (the reference stacks the layers after its ``first_k_dense``
prefix on a leading axis; here each layer is its own module, and
:mod:`.convert` moves weights across).  A layer is ``ln1`` + ``attn`` (GQA
or MLA) + ``ln2`` + ``ffn`` or ``moe`` (``cfg.layer_is_moe``), or ``ln1`` +
``ssm``.

Entry points, batch-major as in the reference:

    model.forward(tokens)                         → (logits (B, S, V_padded), aux)   training
    model.init_cache(batch, max_len)              → stacked decode cache
    model.prefill(tokens)                         → (last-position logits, prompt cache)
    model.decode_step(cache, tokens, pos)         → (logits, cache), cache written in place

The cache is the reference's stacked leaves with the layer axis first:
``{"k", "v"}`` of ``(L, B, S, Hkv, D)`` for GQA, ``{"ckv"}`` of ``(L, B,
S, kv_lora_rank + qk_rope_dim)`` for MLA, ``{"conv_x", "conv_B",
"conv_C"}`` of ``(L, B, W-1, ...)`` and ``"h"`` of ``(L, B, H, P, N)`` fp32
for SSM.  ``forward`` applies ``cfg.remat`` as ``torch.utils.checkpoint``
per layer (the reference's ``_remat_wrap``; ``"dots"`` recomputes
everything too, the same math) and returns the MoE layers' summed
load-balance loss.  Hybrid attention+SSM (jamba), encoder-decoder and VLM
configs raise at construction: they come with later slices of the port.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, torch_dtype
from .attention import gqa_apply, gqa_decode, gqa_defs, mla_apply, mla_decode, mla_defs
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
from .mamba import init_mamba_cache, mamba_apply, mamba_decode, mamba_defs
from .moe import moe_apply, moe_defs
from .params import ParamTree, init_params

__all__ = ["Transformer", "model_defs", "check_supported"]

Cache = Dict[str, torch.Tensor]
#: the SSM cache leaves, each stacked on a leading layer axis
SSM_CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "h")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config this slice cannot run,
    naming the slice of the port that brings it."""
    later = [
        (cfg.ssm is not None and cfg.family != "ssm", "hybrid attention+SSM layers", "the hybrid slice"),
        (cfg.encdec, "an encoder-decoder stack", "the enc-dec/prefix-LM slice"),
        (cfg.vision_tokens > 0, "vision prefix tokens", "the enc-dec/prefix-LM slice"),
    ]
    for present, what, where in later:
        if present:
            raise NotImplementedError(f"{cfg.name} uses {what}, which the port brings in {where}")


def _n_prefix(cfg: ModelConfig) -> int:
    """Layers before the reference's stack (deepseek-v2's dense first layer)."""
    return cfg.moe.first_k_dense if cfg.moe else 0


def _layer_defs(cfg: ModelConfig, layer: int) -> Dict[str, Any]:
    d: Dict[str, Any] = {"ln1": rmsnorm_defs(cfg.d_model)}
    if cfg.layer_is_attn(layer):
        d["attn"] = mla_defs(cfg) if cfg.mla is not None else gqa_defs(cfg)
    else:
        d["ssm"] = mamba_defs(cfg)
    if cfg.layer_is_moe(layer):
        d["ln2"] = rmsnorm_defs(cfg.d_model)
        d["moe"] = moe_defs(cfg, cfg.moe)
    elif cfg.d_ff > 0:
        d["ln2"] = rmsnorm_defs(cfg.d_model)
        d["ffn"] = ffn_defs(cfg.d_model, cfg.d_ff)
    n_prefix = _n_prefix(cfg)
    if layer < n_prefix:
        return d  # the reference's prefix layers are unstacked: a normal init reads its true fan-in
    # The reference initialises the layers after the prefix as one (repeats,
    # ...) leaf per parameter, so a normal init without its own scale reads
    # the repeat count as its fan-in; each layer's leaf here keeps that std.
    # A def with an explicit scale (the router's 0.02, the conv taps' 0.5)
    # keeps it, as in the reference.
    std = ((cfg.n_layers - n_prefix) // cfg.superblock_period) ** -0.5

    def stacked(p):
        if isinstance(p, dict):
            return {n: stacked(q) for n, q in p.items()}
        return replace(p, scale=std) if p.init == "normal" and p.scale is None else p

    return stacked(d)


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """ParamDef tree: ``embed``, ``final_norm``, ``lm_head`` (untied) and
    ``layers/<i>/{ln1, attn, ln2, ffn or moe}`` or ``layers/<i>/{ln1, ssm}``."""
    check_supported(cfg)
    d: Dict[str, Any] = {"embed": embed_defs(cfg), "final_norm": rmsnorm_defs(cfg.d_model)}
    if not cfg.tie_embeddings:
        d["lm_head"] = lm_head_defs(cfg)
    d["layers"] = {str(i): _layer_defs(cfg, i) for i in range(cfg.n_layers)}
    return d


class Transformer(nn.Module):
    """Dense or MoE (GQA or MLA) or pure-SSM decoder with seeded random weights on ``device``."""

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
        """Zeroed decode cache: ``{"k", "v"}`` of ``(L, batch, max_len, Hkv,
        D)``, for MLA ``{"ckv"}`` of ``(L, batch, max_len, kv_lora_rank +
        qk_rope_dim)``, or for SSM the conv windows and the fp32 state
        (``max_len`` unused)."""
        cfg = self.cfg
        if dtype is None:
            dtype = torch_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype else cfg.compute_tdtype()
        if cfg.family == "ssm":
            one = init_mamba_cache(cfg, batch, dtype, self.device)
            return {k: v.expand(cfg.n_layers, *v.shape).clone() for k, v in one.items()}
        if cfg.mla is not None:
            m = cfg.mla
            shape = (cfg.n_layers, batch, max_len, m.kv_lora_rank + m.qk_rope_dim)
            return {"ckv": torch.zeros(shape, dtype=dtype, device=self.device)}
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device),
        }

    def _ffn(self, lp, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The post-mixer sublayer → ``(x, the MoE aux loss in fp32, or None)``."""
        cfg = self.cfg
        if "moe" in lp:
            out, aux = moe_apply(lp["moe"], rmsnorm(lp["ln2"], x, cfg.rms_eps), cfg, cfg.moe)
            return x + out, aux.float()
        if "ffn" in lp:
            return x + ffn_apply(lp["ffn"], rmsnorm(lp["ln2"], x, cfg.rms_eps), cfg.hidden_act), None
        return x, None

    def _layer(self, lp, x, positions, attn_impl: str = "auto", return_cache: bool = False):
        """One full layer on a full sequence → ``(x, mixer cache or None, aux or None)``."""
        cfg = self.cfg
        h = rmsnorm(lp["ln1"], x, cfg.rms_eps)
        if "attn" in lp:
            attend = mla_apply if cfg.mla is not None else gqa_apply
            out, cache = attend(lp["attn"], h, cfg, positions, attn_impl=attn_impl)
        elif return_cache:
            out, cache = mamba_apply(lp["ssm"], h, cfg, return_cache=True)
        else:
            out, cache = mamba_apply(lp["ssm"], h, cfg), None
        x, aux = self._ffn(lp, x + out)
        return x, cache, aux

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward over ``tokens`` ``(B, S)`` → ``(logits, aux)``:
        fp32 logits ``(B, S, V_padded)`` and the MoE layers' summed
        load-balance loss in fp32 (0 without MoE).  With grad enabled and
        ``cfg.remat != "none"``, each layer runs under
        ``torch.utils.checkpoint`` and is recomputed in backward."""
        cfg = self.cfg
        x = embed_apply(self.embed, tokens, cfg)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        remat = cfg.remat != "none" and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in self.layers:
            if remat:
                x, _, aux = checkpoint(self._layer, lp, x, positions, use_reentrant=False)
            else:
                x, _, aux = self._layer(lp, x, positions)
            if aux is not None:
                aux_total = aux_total + aux
        x = rmsnorm(self.final_norm, x, cfg.rms_eps)
        logits = logits_apply(self.embed, self.lm_head, x, cfg)
        return logits, aux_total

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, attn_impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
        """Full causal forward over ``tokens`` ``(B, S)``.  Returns the
        last-position fp32 logits ``(B, V_padded)`` and the prompt cache,
        stacked on the layer axis: ``{"k", "v"}`` of ``(L, B, S, Hkv, D)``,
        MLA's ``{"ckv"}`` (the serving layer copies either into its slot
        buffers), or the SSM leaves (pre-conv windows of the last ``W-1``
        positions, final state)."""
        cfg = self.cfg
        x = embed_apply(self.embed, tokens, cfg)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        caches = []
        for lp in self.layers:
            x, c, _ = self._layer(lp, x, positions, attn_impl, return_cache=True)
            caches.append(c)
        x = rmsnorm(self.final_norm, x, cfg.rms_eps)
        logits = logits_apply(self.embed, self.lm_head, x[:, -1:], cfg)[:, 0]
        return logits, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}

    @torch.no_grad()
    def decode_step(
        self,
        cache: Cache,
        tokens: torch.Tensor,  # (B,) next input token ids
        pos: torch.Tensor,  # (B,) their positions (0-based)
    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step for every sequence in the batch → ``(logits, cache)``.

        The new K/V (MLA's latent, or the slid conv windows and the new SSM
        state) are written **in place** into ``cache`` (which may be a view, such as a
        bucket's slice of the engine's cache): the reference donates its
        cache buffer to the same step, so callers hold no other copy either
        way.  The returned cache is ``cache`` itself.  An MoE layer routes
        each sequence as its own group of one token, as the reference does,
        so a batch's other rows never move a row's experts."""
        cfg = self.cfg
        x = embed_apply(self.embed, tokens[:, None], cfg)[:, 0]
        for i, lp in enumerate(self.layers):
            h = rmsnorm(lp["ln1"], x, cfg.rms_eps)
            if "attn" in lp:
                layer_cache = {k: v[i] for k, v in cache.items()}
                attend = mla_decode if cfg.mla is not None else gqa_decode
                out = attend(lp["attn"], h, cfg, layer_cache, pos)
            else:
                out, new = mamba_decode(lp["ssm"], h, cfg, {k: cache[k][i] for k in SSM_CACHE_KEYS})
                for k in SSM_CACHE_KEYS:
                    cache[k][i].copy_(new[k])
            if "moe" in lp:
                x = self._ffn(lp, (x + out)[:, None])[0][:, 0]
            else:
                x = self._ffn(lp, x + out)[0]
        x = rmsnorm(self.final_norm, x, cfg.rms_eps)
        logits = logits_apply(self.embed, self.lm_head, x[:, None], cfg)[:, 0]
        return logits, cache
