"""The decoder LM: the dense GQA family (deepseek-7b and the other dense
configs), the MoE family with GQA (llama4-scout) or MLA attention
(deepseek-v2-lite), the pure-SSM family (mamba2-130m) and the hybrid of
attention and Mamba-2 layers with MoE (jamba).

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

The cache is one stack per kind of layer, the layer axis first:
``{"k", "v"}`` of ``(L_attn, B, S, Hkv, D)`` for GQA or ``{"ckv"}`` of
``(L_attn, B, S, kv_lora_rank + qk_rope_dim)`` for MLA over the attention
layers, and ``{"conv_x", "conv_B", "conv_C"}`` of ``(L_ssm, B, W-1, ...)``
and ``"h"`` of ``(L_ssm, B, H, P, N)`` fp32 over the Mamba-2 layers.  Layer
``i`` reads and writes row :func:`cache_rows` ``(cfg)[i]`` of its kind's
stack: the count of earlier layers of its kind.  A model of one kind of
layer (dense, MoE, MLA, pure SSM) thus has ``L_attn`` or ``L_ssm`` equal to
``L`` and row ``i`` for layer ``i``, the reference's stacked leaves; jamba's
attention layers share one stack and its SSM layers the other.
``forward`` applies ``cfg.remat`` as ``torch.utils.checkpoint`` per layer
(the reference's ``_remat_wrap``; ``"dots"`` recomputes everything too, the
same math) and returns the MoE layers' summed load-balance loss.
Encoder-decoder and VLM configs raise at construction: they come with a
later slice of the port.
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

__all__ = ["Transformer", "model_defs", "check_supported", "cache_rows"]

Cache = Dict[str, torch.Tensor]
#: the SSM cache leaves, each stacked on a leading axis over the SSM layers
SSM_CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "h")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config this slice cannot run,
    naming the slice of the port that brings it."""
    later = [
        (cfg.encdec, "an encoder-decoder stack", "the enc-dec/prefix-LM slice"),
        (cfg.vision_tokens > 0, "vision prefix tokens", "the enc-dec/prefix-LM slice"),
    ]
    for present, what, where in later:
        if present:
            raise NotImplementedError(f"{cfg.name} uses {what}, which the port brings in {where}")


def cache_rows(cfg: ModelConfig) -> Tuple[int, ...]:
    """Per layer, its row in its kind's cache stack (attention or SSM): the
    number of earlier layers of the same kind."""
    seen = {True: 0, False: 0}
    rows = []
    for i in range(cfg.n_layers):
        kind = cfg.layer_is_attn(i)
        rows.append(seen[kind])
        seen[kind] += 1
    return tuple(rows)


def _attn_cache_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    return ("ckv",) if cfg.mla is not None else ("k", "v")


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
    """Dense, MoE (GQA or MLA), pure-SSM or hybrid decoder with seeded random weights on ``device``."""

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
        self.cache_rows = cache_rows(cfg)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def init_cache(self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None) -> Cache:
        """Zeroed decode cache, one stack per kind of layer: over the
        attention layers ``{"k", "v"}`` of ``(L_attn, batch, max_len, Hkv,
        D)`` or MLA's ``{"ckv"}`` of ``(L_attn, batch, max_len, kv_lora_rank
        + qk_rope_dim)``; over the SSM layers the conv windows and the fp32
        state (``max_len`` unused)."""
        cfg = self.cfg
        if dtype is None:
            dtype = torch_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype else cfg.compute_tdtype()
        n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
        n_ssm = cfg.n_layers - n_attn
        cache: Cache = {}
        if n_attn:
            if cfg.mla is not None:
                widths = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim,)
            else:
                widths = (cfg.n_kv_heads, cfg.resolved_head_dim)
            for key in _attn_cache_keys(cfg):
                cache[key] = torch.zeros((n_attn, batch, max_len, *widths), dtype=dtype, device=self.device)
        if n_ssm:
            one = init_mamba_cache(cfg, batch, dtype, self.device)
            cache.update({k: v.expand(n_ssm, *v.shape).clone() for k, v in one.items()})
        return cache

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
        last-position fp32 logits ``(B, V_padded)`` and the prompt cache in
        :meth:`init_cache`'s layout at length S: ``{"k", "v"}`` of ``(L_attn,
        B, S, Hkv, D)`` or MLA's ``{"ckv"}`` (the serving layer copies either
        into its slot buffers), and the SSM leaves (pre-conv windows of the
        last ``W-1`` positions, final state)."""
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
        keys = dict.fromkeys(k for c in caches for k in c)  # each kind's keys, as the layers first give them
        return logits, {k: torch.stack([c[k] for c in caches if k in c]) for k in keys}

    @torch.no_grad()
    def decode_step(
        self,
        cache: Cache,
        tokens: torch.Tensor,  # (B,) next input token ids
        pos: torch.Tensor,  # (B,) their positions (0-based)
    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step for every sequence in the batch → ``(logits, cache)``.

        The new K/V (MLA's latent, or the slid conv windows and the new SSM
        state) are written **in place** into ``cache`` (which may be a view,
        such as a bucket's slice of the engine's cache), each layer at its
        :func:`cache_rows` row of its kind's stack: the reference donates its
        cache buffer to the same step, so callers hold no other copy either
        way.  The returned cache is ``cache`` itself.  An MoE layer routes
        each sequence as its own group of one token, as the reference does,
        so a batch's other rows never move a row's experts."""
        cfg = self.cfg
        x = embed_apply(self.embed, tokens[:, None], cfg)[:, 0]
        attn_keys = _attn_cache_keys(cfg)
        for lp, row in zip(self.layers, self.cache_rows):
            h = rmsnorm(lp["ln1"], x, cfg.rms_eps)
            if "attn" in lp:
                attend = mla_decode if cfg.mla is not None else gqa_decode
                out = attend(lp["attn"], h, cfg, {k: cache[k][row] for k in attn_keys}, pos)
            else:
                out, new = mamba_decode(lp["ssm"], h, cfg, {k: cache[k][row] for k in SSM_CACHE_KEYS})
                for k in SSM_CACHE_KEYS:
                    cache[k][row].copy_(new[k])
            if "moe" in lp:
                x = self._ffn(lp, (x + out)[:, None])[0][:, 0]
            else:
                x = self._ffn(lp, x + out)[0]
        x = rmsnorm(self.final_norm, x, cfg.rms_eps)
        logits = logits_apply(self.embed, self.lm_head, x[:, None], cfg)[:, 0]
        return logits, cache
