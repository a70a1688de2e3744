"""The LM of every family: the dense GQA family (deepseek-7b and the other
dense configs), the MoE family with GQA (llama4-scout) or MLA attention
(deepseek-v2-lite), the pure-SSM family (mamba2-130m), the hybrid of
attention and Mamba-2 layers with MoE (jamba), the encoder-decoder with
cross-attention (whisper-medium; its conv front end stubbed to frame
embeddings) and the prefix-LM VLM (paligemma-3b; SigLIP stubbed to patch
embeddings).

``Transformer`` holds the embedding, an ``nn.ModuleList`` of decoder layers,
the final norm and the LM head, with the reference's parameter shapes leaf
for leaf (the reference stacks the layers after its ``first_k_dense``
prefix on a leading axis; here each layer is its own module, and
:mod:`.convert` moves weights across).  A layer is ``ln1`` + ``attn`` (GQA
or MLA) + ``ln2`` + ``ffn`` or ``moe`` (``cfg.layer_is_moe``), or ``ln1`` +
``ssm``; an enc-dec decoder layer also holds ``ln_x`` + ``cross`` between
its mixer and its FFN.  An enc-dec config adds an :class:`Encoder`
(``encoder.layers.<i>`` of ``ln1`` + ``attn`` + ``ln2`` + ``ffn``, and
``encoder.final_norm``): sinusoidal positions on the frame embeddings, then
non-causal self-attention layers.  A VLM's vision embeddings are
concatenated before the text's (:meth:`Transformer._assemble_input`); with
``cfg.prefix_lm`` every text row also sees them (the flash kernels'
``prefix_len``), and the logits cover the text positions only.

Entry points, batch-major as in the reference:

    model.forward(tokens, enc_embeds=, vision_embeds=)   → (logits (B, S, V_padded), aux)   training
    model.init_cache(batch, max_len, enc_len=)           → stacked decode cache
    model.prefill(tokens, enc_embeds=, vision_embeds=)   → (last-position logits, prompt cache)
    model.decode_step(cache, tokens, pos)                → (logits, cache), cache written in place

The cache is one stack per kind of layer, the layer axis first:
``{"k", "v"}`` of ``(L_attn, B, S, Hkv, D)`` for GQA or ``{"ckv"}`` of
``(L_attn, B, S, kv_lora_rank + qk_rope_dim)`` for MLA over the attention
layers, and ``{"conv_x", "conv_B", "conv_C"}`` of ``(L_ssm, B, W-1, ...)``
and ``"h"`` of ``(L_ssm, B, H, P, N)`` fp32 over the Mamba-2 layers.  Layer
``i`` reads and writes row :func:`cache_rows` ``(cfg)[i]`` of its kind's
stack: the count of earlier layers of its kind.  A model of one kind of
layer (dense, MoE, MLA, pure SSM) thus has ``L_attn`` or ``L_ssm`` equal to
``L`` and row ``i`` for layer ``i``, the reference's stacked leaves; jamba's
attention layers share one stack and its SSM layers the other.  An enc-dec
model adds the cross stack ``cross_k`` / ``cross_v`` of ``(L, B, S_enc, Hkv,
D)``: each decoder layer's K and V of the encoder's output, written by
prefill and read whole by every decode step.  ``forward`` applies
``cfg.remat`` as ``torch.utils.checkpoint`` per layer, encoder and decoder
(the reference's ``_remat_wrap``; ``"dots"`` recomputes everything too, the
same math) and returns the MoE layers' summed load-balance loss.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, torch_dtype
from .act_sharding import constrain
from .attention import (
    cross_attn_apply,
    cross_attn_defs,
    cross_attn_kv,
    gqa_apply,
    gqa_decode,
    gqa_defs,
    mla_apply,
    mla_decode,
    mla_defs,
)
from .layers import (
    embed_apply,
    embed_defs,
    ffn_apply,
    ffn_defs,
    lm_head_defs,
    logits_apply,
    rmsnorm,
    rmsnorm_defs,
    sinusoidal_positions,
)
from .mamba import init_mamba_cache, mamba_apply, mamba_decode, mamba_defs
from .moe import moe_apply, moe_defs
from .params import ParamTree, init_params

__all__ = ["Transformer", "Encoder", "model_defs", "init_cache", "cache_rows", "param_tree"]

Cache = Dict[str, torch.Tensor]
#: the SSM cache leaves, each stacked on a leading axis over the SSM layers
SSM_CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "h")
#: an enc-dec model's cross cache leaves (K and V of the encoder's output), each stacked over the decoder layers
CROSS_CACHE_KEYS = ("cross_k", "cross_v")


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


def _stacked_std(d: Dict[str, Any], repeats: int) -> Dict[str, Any]:
    """``d`` with the std of the reference's stacked init.  The reference
    initialises a stack of ``repeats`` layers as one (repeats, ...) leaf per
    parameter, so a normal init without its own scale reads the repeat count
    as its fan-in; each layer's leaf here keeps that std.  A def with an
    explicit scale (the router's 0.02, the conv taps' 0.5) keeps it, as in
    the reference."""
    std = repeats ** -0.5

    def stacked(p):
        if isinstance(p, dict):
            return {n: stacked(q) for n, q in p.items()}
        return replace(p, scale=std) if p.init == "normal" and p.scale is None else p

    return stacked(d)


def _layer_defs(cfg: ModelConfig, layer: int) -> Dict[str, Any]:
    d: Dict[str, Any] = {"ln1": rmsnorm_defs(cfg.d_model)}
    if cfg.layer_is_attn(layer):
        d["attn"] = mla_defs(cfg) if cfg.mla is not None else gqa_defs(cfg)
    else:
        d["ssm"] = mamba_defs(cfg)
    if cfg.encdec:
        d["ln_x"] = rmsnorm_defs(cfg.d_model)
        d["cross"] = cross_attn_defs(cfg)
    if cfg.layer_is_moe(layer):
        d["ln2"] = rmsnorm_defs(cfg.d_model)
        d["moe"] = moe_defs(cfg, cfg.moe)
    elif cfg.d_ff > 0:
        d["ln2"] = rmsnorm_defs(cfg.d_model)
        d["ffn"] = ffn_defs(cfg.d_model, cfg.d_ff)
    n_prefix = _n_prefix(cfg)
    if layer < n_prefix:
        return d  # the reference's prefix layers are unstacked: a normal init reads its true fan-in
    return _stacked_std(d, (cfg.n_layers - n_prefix) // cfg.superblock_period)


def _encoder_layer_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """An encoder layer at the decoder's widths.  The reference stacks its
    ``n_enc_layers`` layers (``encoder/blocks``), so a normal init reads that
    count as its fan-in."""
    d = {"ln1": rmsnorm_defs(cfg.d_model), "attn": gqa_defs(cfg), "ln2": rmsnorm_defs(cfg.d_model),
         "ffn": ffn_defs(cfg.d_model, cfg.d_ff)}
    return _stacked_std(d, cfg.n_enc_layers)


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """ParamDef tree: ``embed``, ``final_norm``, ``lm_head`` (untied) and
    ``layers/<i>/{ln1, attn, ln2, ffn or moe}`` or ``layers/<i>/{ln1, ssm}``
    (enc-dec: also ``ln_x`` and ``cross``); an enc-dec config adds
    ``encoder/{layers/<i>/{ln1, attn, ln2, ffn}, final_norm}``."""
    d: Dict[str, Any] = {"embed": embed_defs(cfg), "final_norm": rmsnorm_defs(cfg.d_model)}
    if not cfg.tie_embeddings:
        d["lm_head"] = lm_head_defs(cfg)
    d["layers"] = {str(i): _layer_defs(cfg, i) for i in range(cfg.n_layers)}
    if cfg.encdec:
        d["encoder"] = {"layers": {str(i): _encoder_layer_defs(cfg) for i in range(cfg.n_enc_layers)},
                        "final_norm": rmsnorm_defs(cfg.d_model)}
    return d


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: Optional[torch.dtype] = None, *,
               enc_len: int = 0, device="cuda") -> Cache:
    """Zeroed decode cache on ``device``, one stack per kind of layer: over
    the attention layers ``{"k", "v"}`` of ``(L_attn, batch, max_len, Hkv,
    D)`` or MLA's ``{"ckv"}`` of ``(L_attn, batch, max_len, kv_lora_rank +
    qk_rope_dim)``; over the SSM layers the conv windows and the fp32 state
    (``max_len`` unused); for an enc-dec model the cross stack
    ``{"cross_k", "cross_v"}`` of ``(L, batch, enc_len, Hkv, D)``.  On the
    ``meta`` device it allocates nothing (a production shape's cache for
    ``make_plan``'s ``cache_specs_fn``)."""
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
            cache[key] = torch.zeros((n_attn, batch, max_len, *widths), dtype=dtype, device=device)
    if n_ssm:
        one = init_mamba_cache(cfg, batch, dtype, device)
        cache.update({k: v.expand(n_ssm, *v.shape).clone() for k, v in one.items()})
    if cfg.encdec:
        shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache.update({k: torch.zeros(shape, dtype=dtype, device=device) for k in CROSS_CACHE_KEYS})
    return cache


def param_tree(model: nn.Module) -> Dict[str, Any]:
    """``model``'s parameters as the nested dict :meth:`Transformer.from_params`
    takes (keyed as :func:`model_defs`), the tensors themselves."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


class Encoder(nn.Module):
    """An enc-dec config's encoder weights: ``layers`` (non-causal
    self-attention and FFN) and ``final_norm``; :meth:`Transformer._encode`
    applies them."""

    def __init__(self, tree: Dict[str, Any], n_layers: int) -> None:
        super().__init__()
        self.layers = nn.ModuleList(ParamTree(tree["layers"][str(i)]) for i in range(n_layers))
        self.final_norm = ParamTree(tree["final_norm"])


class Transformer(nn.Module):
    """Dense, MoE (GQA or MLA), pure-SSM, hybrid, enc-dec or prefix-LM model
    with seeded random weights on ``device``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0) -> None:
        super().__init__()
        device = torch.device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        self._build(cfg, init_params(model_defs(cfg), generator, cfg.param_tdtype(), device))

    @classmethod
    def from_params(cls, cfg: ModelConfig, tree: Dict[str, Any]) -> "Transformer":
        """A model over the parameter tree ``tree`` (nested dicts keyed as
        :func:`model_defs`), sharing its tensors: a step built on it updates
        them in place (a cell's step over its inputs, a count on fake
        copies)."""
        model = cls.__new__(cls)
        nn.Module.__init__(model)
        model._build(cfg, tree)
        return model

    def _build(self, cfg: ModelConfig, tree: Dict[str, Any]) -> None:
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.lm_head = ParamTree(tree["lm_head"]) if "lm_head" in tree else None
        self.layers = nn.ModuleList(ParamTree(tree["layers"][str(i)]) for i in range(cfg.n_layers))
        self.encoder = Encoder(tree["encoder"], cfg.n_enc_layers) if cfg.encdec else None
        self.cache_rows = cache_rows(cfg)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def init_cache(self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None, *,
                   enc_len: int = 0) -> Cache:
        """:func:`init_cache` of this model's config on its device."""
        return init_cache(self.cfg, batch, max_len, dtype, enc_len=enc_len, device=self.device)

    def _ffn(self, lp, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The post-mixer sublayer → ``(x, the MoE aux loss in fp32, or None)``."""
        cfg = self.cfg
        if "moe" in lp:
            out, aux = moe_apply(lp["moe"], rmsnorm(lp["ln2"], x, cfg.rms_eps), cfg, cfg.moe)
            return x + out, aux.float()
        if "ffn" in lp:
            return x + ffn_apply(lp["ffn"], rmsnorm(lp["ln2"], x, cfg.rms_eps), cfg.hidden_act), None
        return x, None

    def _layer(self, lp, x, positions, attn_impl: str = "auto", return_cache: bool = False, *,
               causal: bool = True, prefix_len: int = 0, enc_out: Optional[torch.Tensor] = None):
        """One full layer on a full sequence → ``(x, its cache or None, aux or
        None)``: the mixer (self-attention ``causal``, with ``prefix_len``
        prefix keys every row sees, or the SSM), the cross-attention over
        ``enc_out`` where the layer has one (its K and V join the cache as
        ``cross_k`` and ``cross_v``), then the FFN or MoE."""
        cfg = self.cfg
        h = rmsnorm(lp["ln1"], x, cfg.rms_eps)
        if "attn" in lp:
            if cfg.mla is not None:
                out, cache = mla_apply(lp["attn"], h, cfg, positions, causal=causal, attn_impl=attn_impl)
            else:
                out, cache = gqa_apply(lp["attn"], h, cfg, positions, causal=causal, prefix_len=prefix_len,
                                       attn_impl=attn_impl)
        elif return_cache:
            out, cache = mamba_apply(lp["ssm"], h, cfg, return_cache=True)
        else:
            out, cache = mamba_apply(lp["ssm"], h, cfg), None
        x = x + out
        if "cross" in lp and enc_out is not None:
            kv = cross_attn_kv(lp["cross"], enc_out, cfg)
            x = x + cross_attn_apply(lp["cross"], rmsnorm(lp["ln_x"], x, cfg.rms_eps), cfg, kv, attn_impl=attn_impl)
            if return_cache:
                cache = {**cache, "cross_k": kv["k"], "cross_v": kv["v"]}
        x, aux = self._ffn(lp, x)
        x = constrain(x, "batch", "seq", "act_embed")
        return x, cache, aux

    def _run_layer(self, lp, x, positions, **kw):
        """:meth:`_layer` for training and inference: with grad enabled and
        ``cfg.remat != "none"`` under ``torch.utils.checkpoint``, recomputed
        in backward."""
        if self.cfg.remat != "none" and torch.is_grad_enabled():
            return checkpoint(self._layer, lp, x, positions, use_reentrant=False, **kw)
        return self._layer(lp, x, positions, **kw)

    def _encode(self, enc_embeds: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """The encoder over the (stub) frame embeddings ``(B, S_enc,
        d_model)``: cast to the compute dtype, sinusoidal positions added,
        non-causal layers, the final norm."""
        cfg = self.cfg
        x = enc_embeds.to(cfg.compute_tdtype())
        B, S = x.shape[:2]
        x = x + sinusoidal_positions(S, cfg.d_model, x.dtype, x.device)[None]
        positions = torch.arange(S, device=x.device).expand(B, S)
        for lp in self.encoder.layers:
            x = self._run_layer(lp, x, positions, attn_impl=attn_impl, causal=False)[0]
        return rmsnorm(self.encoder.final_norm, x, cfg.rms_eps)

    def _assemble_input(self, tokens: torch.Tensor, vision_embeds: Optional[torch.Tensor]):
        """Token embeddings, after a VLM's vision embeddings where given →
        ``(x, prefix_len)``: ``cfg.vision_tokens`` with ``cfg.prefix_lm``,
        else 0."""
        cfg = self.cfg
        x = embed_apply(self.embed, tokens, cfg)
        if cfg.vision_tokens > 0 and vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
            return x, cfg.vision_tokens if cfg.prefix_lm else 0
        return x, 0

    def _inputs(self, tokens, enc_embeds, vision_embeds, attn_impl: str = "auto"):
        """``(x, positions, prefix_len, enc_out)`` for the decoder stack."""
        cfg = self.cfg
        enc_out = None
        if cfg.encdec:
            if enc_embeds is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder model: pass enc_embeds (B, S_enc, d_model)")
            enc_out = self._encode(enc_embeds, attn_impl)
        x, prefix_len = self._assemble_input(tokens, vision_embeds)
        B, S = x.shape[:2]
        return x, torch.arange(S, device=x.device).expand(B, S), prefix_len, enc_out

    def forward(self, tokens: torch.Tensor, *, enc_embeds: Optional[torch.Tensor] = None,
                vision_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward over ``tokens`` ``(B, S)`` → ``(logits, aux)``:
        fp32 logits ``(B, S, V_padded)`` over the text positions and the MoE
        layers' summed load-balance loss in fp32 (0 without MoE).  An enc-dec
        model takes its frame embeddings ``enc_embeds`` ``(B, S_enc,
        d_model)``; a VLM its ``vision_embeds`` ``(B, vision_tokens,
        d_model)``, placed before the tokens.  With grad enabled and
        ``cfg.remat != "none"``, each layer runs under
        ``torch.utils.checkpoint`` and is recomputed in backward."""
        cfg = self.cfg
        x, positions, prefix_len, enc_out = self._inputs(tokens, enc_embeds, vision_embeds)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in self.layers:
            x, _, aux = self._run_layer(lp, x, positions, prefix_len=prefix_len, enc_out=enc_out)
            if aux is not None:
                aux_total = aux_total + aux
        x = rmsnorm(self.final_norm, x, cfg.rms_eps)
        if cfg.vision_tokens > 0 and vision_embeds is not None:
            x = x[:, cfg.vision_tokens:]  # logits over the text positions only
        logits = logits_apply(self.embed, self.lm_head, x, cfg)
        return logits, aux_total

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, enc_embeds: Optional[torch.Tensor] = None,
                vision_embeds: Optional[torch.Tensor] = None, attn_impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
        """Full forward over ``tokens`` ``(B, S)`` (and ``enc_embeds`` or
        ``vision_embeds``, as :meth:`forward` takes them).  Returns the
        last-position fp32 logits ``(B, V_padded)`` and the prompt cache in
        :meth:`init_cache`'s layout at the prompt's length: ``{"k", "v"}`` of
        ``(L_attn, B, S, Hkv, D)`` (a VLM's S counts its vision tokens) or
        MLA's ``{"ckv"}`` (the serving layer copies either into its slot
        buffers), the SSM leaves (pre-conv windows of the last ``W-1``
        positions, final state), and an enc-dec model's cross stack at
        ``S_enc``."""
        cfg = self.cfg
        x, positions, prefix_len, enc_out = self._inputs(tokens, enc_embeds, vision_embeds, attn_impl)
        caches = []
        for lp in self.layers:
            x, c, _ = self._layer(lp, x, positions, attn_impl, return_cache=True, prefix_len=prefix_len,
                                  enc_out=enc_out)
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
        pos: torch.Tensor,  # (B,) their positions (0-based; a VLM's count its vision tokens)
    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step for every sequence in the batch → ``(logits, cache)``.

        The new K/V (MLA's latent, or the slid conv windows and the new SSM
        state) are written **in place** into ``cache`` (which may be a view,
        such as a bucket's slice of the engine's cache), each layer at its
        :func:`cache_rows` row of its kind's stack: the reference donates its
        cache buffer to the same step, so callers hold no other copy either
        way.  The returned cache is ``cache`` itself.  An enc-dec decoder
        layer then attends over the whole of its row of the cross stack,
        which it only reads.  An MoE layer routes each sequence as its own
        group of one token, as the reference does, so a batch's other rows
        never move a row's experts."""
        cfg = self.cfg
        x = embed_apply(self.embed, tokens[:, None], cfg)[:, 0]
        attn_keys = _attn_cache_keys(cfg)
        for i, (lp, row) in enumerate(zip(self.layers, self.cache_rows)):
            h = rmsnorm(lp["ln1"], x, cfg.rms_eps)
            if "attn" in lp:
                attend = mla_decode if cfg.mla is not None else gqa_decode
                out = attend(lp["attn"], h, cfg, {k: cache[k][row] for k in attn_keys}, pos)
            else:
                out, new = mamba_decode(lp["ssm"], h, cfg, {k: cache[k][row] for k in SSM_CACHE_KEYS})
                for k in SSM_CACHE_KEYS:
                    cache[k][row].copy_(new[k])
            x = x + out
            if "cross" in lp and "cross_k" in cache:
                kv = {"k": cache["cross_k"][i], "v": cache["cross_v"][i]}
                x = x + cross_attn_apply(lp["cross"], rmsnorm(lp["ln_x"], x, cfg.rms_eps), cfg, kv)
            if "moe" in lp:
                x = self._ffn(lp, x[:, None])[0][:, 0]
            else:
                x = self._ffn(lp, x)[0]
        x = rmsnorm(self.final_norm, x, cfg.rms_eps)
        logits = logits_apply(self.embed, self.lm_head, x[:, None], cfg)[:, 0]
        return logits, cache
