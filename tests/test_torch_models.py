"""The port's dense decoder against the reference's, on the CPU in fp32.

Weights come from ``repro.models.init_params`` and move into the port
through ``load_jax_params``.  Tolerances, measured with these inputs:

* deepseek-7b logits within atol 5e-5.  A plain torch prefill of its smoke
  config differed from the reference by at most 6.2e-6 on logits up to 3.7;
  this test's batch of two measures 7.6e-6.  The rest is room for
  summation order.
* The other dense smokes' logits within atol 1e-4: phi3-medium-14b's batch
  of two measures 6.8e-5 on logits up to 3.1 (qwen2 1.8e-5, gemma 7e-7).
* The K/V cache within 5e-5 of each leaf's largest magnitude.  The
  reference's init draws the layer weights at std ``n_layers^-0.5`` (see
  ``test_init_recipes_match_reference``), a gain of ~6 per projection at
  these widths, so |k| and |v| reach ~26 and fp32 summation-order noise,
  carried through the residual stream, reaches 5.7e-4 absolute (2.2e-5 of
  the leaf's scale) by the last layer, from 7e-6 at the first.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import decode_step as ref_decode_step
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import model_defs as ref_model_defs
from repro.models import prefill as ref_prefill
from repro.serve.cache_utils import transplant as ref_transplant
from repro.serve.engine import _write_slot as ref_write_slot
from repro_torch.configs import get_smoke_config
from repro_torch.models import Transformer, load_jax_params
from repro_torch.models.convert import flatten_jax_tree
from repro_torch.models.params import ParamDef, init_params
from repro_torch.serve.cache_utils import transplant

LOGITS_ATOL = {"deepseek-7b": 5e-5, "qwen2-72b": 1e-4, "phi3-medium-14b": 1e-4, "gemma-7b": 1e-4}
CACHE_REL = 5e-5


def _setup(arch, seed=7):
    cfg = ref_smoke(arch)
    params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(seed), cfg.param_jdtype())
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = load_jax_params(Transformer(get_smoke_config(arch), device="cpu"), tree)
    return cfg, params, tree, model


@pytest.fixture(scope="module")
def deepseek():
    return _setup("deepseek-7b")


def _close_cache(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, atol=CACHE_REL * np.abs(ref).max(), rtol=0)


def _ref_kv(cache):
    inner = cache["blocks"]["pos_0"]["mixer"]
    return inner["k"], inner["v"]


@pytest.mark.parametrize("arch", sorted(LOGITS_ATOL))
def test_prefill_matches_reference(arch):
    cfg, params, _, model = _setup(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    want_logits, want_cache = ref_prefill(cfg, params, {"tokens": toks})
    logits, cache = model.prefill(torch.from_numpy(toks).long())
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGITS_ATOL[arch], rtol=0)
    assert np.array_equal(logits.argmax(-1).numpy(), np.asarray(want_logits).argmax(-1))
    wk, wv = _ref_kv(want_cache)
    assert tuple(cache["k"].shape) == wk.shape == (cfg.n_layers, 2, 37, cfg.n_kv_heads, cfg.resolved_head_dim)
    _close_cache(cache["k"], wk)
    _close_cache(cache["v"], wv)


def test_16_decode_steps_at_per_sequence_positions(deepseek):
    cfg, params, _, model = deepseek
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in (11, 23)]
    max_len = 48
    ref_cache = ref_init_cache(cfg, 2, max_len, dtype=cfg.compute_jdtype())
    cache = model.init_cache(2, max_len)
    tokens = []
    for slot, prompt in enumerate(prompts):
        ref_logits, small = ref_prefill(cfg, params, {"tokens": prompt[None]})
        one = ref_transplant(ref_init_cache(cfg, 1, max_len, dtype=cfg.compute_jdtype()), small)
        ref_cache = jax.tree_util.tree_map(lambda b, o: ref_write_slot(b, o, slot), ref_cache, one)
        logits, port_small = model.prefill(torch.from_numpy(prompt[None]).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=LOGITS_ATOL["deepseek-7b"], rtol=0)
        transplant({k: v[:, slot:slot + 1] for k, v in cache.items()}, port_small)
        tokens.append(int(np.asarray(ref_logits).argmax(-1)[0]))
    pos = np.array([len(p) for p in prompts], np.int32)
    tok = np.array(tokens, np.int32)
    for _ in range(16):
        ref_logits, ref_cache = ref_decode_step(cfg, params, ref_cache, tok, pos)
        logits, out_cache = model.decode_step(
            cache, torch.from_numpy(tok).long(), torch.from_numpy(pos).long()
        )
        assert out_cache is cache  # written in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=LOGITS_ATOL["deepseek-7b"], rtol=0)
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
        assert np.array_equal(logits.argmax(-1).numpy(), tok)
        pos = pos + 1
    wk, wv = _ref_kv(ref_cache)
    _close_cache(cache["k"], wk)
    _close_cache(cache["v"], wv)


def test_init_recipes_match_reference(deepseek):
    """Sizes equal leaf for leaf; the port's own seeded init draws each leaf
    with the reference's std (zeros exactly; normal leaves within 5%, the
    sampling error of >= 16k draws being under 1%, or within 4 standard
    errors of a smaller leaf's).  Dense deepseek-7b, and the MoE configs:
    deepseek-v2-lite, whose dense first layer the reference keeps outside
    its stack (so its weights read their true fan-in, d_model) and whose
    stacked layers read the repeat count, and llama4-scout (no prefix)."""
    for arch in ("deepseek-7b", "deepseek-v2-lite-16b", "llama4-scout-17b-a16e"):
        cfg, _, tree, _ = deepseek if arch == "deepseek-7b" else _setup(arch)
        ref_flat = flatten_jax_tree(tree, cfg)
        port = dict(Transformer(get_smoke_config(arch), device="cpu", seed=3).named_parameters())
        assert sorted(port) == sorted(ref_flat)
        for name, p in port.items():
            ref = ref_flat[name].astype(np.float64)
            assert tuple(p.shape) == ref.shape, name
            if not ref.any():
                assert not p.any(), name
                continue
            rtol = max(0.05, 4 / np.sqrt(2 * ref.size))
            np.testing.assert_allclose(p.double().std().item(), ref.std(), rtol=rtol, err_msg=f"{arch} {name}")
        # the reference reads the stacked layer count as the fan-in of a layer's weights
        n_prefix = cfg.moe.first_k_dense if cfg.moe else 0
        last = cfg.n_layers - 1
        np.testing.assert_allclose(ref_flat[f"layers.{last}.attn.wq"].std(), (cfg.n_layers - n_prefix) ** -0.5,
                                   rtol=0.05)
        if cfg.moe:
            np.testing.assert_allclose(ref_flat[f"layers.{last}.moe.router"].std(), 0.02, rtol=0.1)
            np.testing.assert_allclose(ref_flat[f"layers.{last}.moe.wo"].std(), 0.02 / np.sqrt(2), rtol=0.05)
        for j in range(n_prefix):  # unstacked: the true fan-in
            for leaf in ("attn.wq", "attn.w_dkv", "ffn.wi_gate", "ffn.wi_up"):
                np.testing.assert_allclose(ref_flat[f"layers.{j}.{leaf}"].std(), cfg.d_model ** -0.5, rtol=0.05)


def test_load_jax_params_raises_on_bad_trees(deepseek):
    cfg, _, tree, _ = deepseek
    model = Transformer(get_smoke_config("deepseek-7b"), device="cpu", seed=0)
    snapshot = model.final_norm["scale"].clone()
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="missing.*lm_head.w"):
        load_jax_params(model, missing)
    extra = dict(tree, extra={"w": np.zeros((3,), np.float32)})
    with pytest.raises(ValueError, match="extra.*extra.w"):
        load_jax_params(model, extra)
    bad = dict(tree, final_norm={"scale": np.zeros((cfg.d_model + 1,), np.float32)})
    with pytest.raises(ValueError, match="mis-shaped.*final_norm.scale"):
        load_jax_params(model, bad)
    assert torch.equal(model.final_norm["scale"], snapshot)  # nothing copied


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_draws_a_rank2_leaf_as_randn_times_std(dtype):
    """A normal leaf other than stacked experts is drawn in fp32 from the
    generator, scaled in place and cast: bit for bit ``(torch.randn(shape)
    * std).to(dtype)`` from a generator of the same seed, leaf after leaf in
    sorted-key order (``fan_in^-0.5``, then ``out_proj``'s 0.02/√2)."""
    defs = {"a": ParamDef((64, 48), ("embed", "mlp")), "b": ParamDef((48, 64), ("mlp", "embed"), init="out_proj")}
    got = init_params(defs, torch.Generator().manual_seed(5), dtype, "cpu")
    g = torch.Generator().manual_seed(5)
    want_a = (torch.randn((64, 48), generator=g) * 64 ** -0.5).to(dtype)
    want_b = (torch.randn((48, 64), generator=g) * (0.02 / 2 ** 0.5)).to(dtype)
    assert got["a"].dtype == got["b"].dtype == dtype
    assert torch.equal(got["a"], want_a) and torch.equal(got["b"], want_b)


def test_init_draws_stacked_experts_in_the_parameter_dtype():
    """A stacked experts leaf (leading axis "experts") is drawn one expert
    at a time into a bf16 tensor: the def's std (the reference's fan-in
    quirk: the expert count, 16^-0.5) over the whole leaf and over each
    expert within four standard errors of a sample std (std / sqrt(2n)),
    zero mean, and no two experts alike."""
    defn = ParamDef((16, 128, 256), ("experts", None, "expert_mlp"))
    leaf = init_params({"w": defn}, torch.Generator().manual_seed(2), torch.bfloat16, "cpu")["w"]
    assert leaf.dtype == torch.bfloat16 and leaf.shape == (16, 128, 256)
    x = leaf.double()
    std = 16 ** -0.5
    np.testing.assert_allclose(x.std().item(), std, rtol=4 / np.sqrt(2 * x.numel()))
    np.testing.assert_allclose(x.std(dim=(1, 2)).numpy(), std, rtol=4 / np.sqrt(2 * x[0].numel()))
    assert abs(x.mean().item()) < 4 * std / np.sqrt(x.numel())
    assert all(not torch.equal(leaf[i], leaf[j]) for i in range(16) for j in range(i))


def _hybrid_mamba2():
    """mamba2 with attention every other layer: the hybrid attention+SSM
    family without MoE."""
    return replace(get_smoke_config("mamba2-130m"), family="hybrid", n_heads=4, n_kv_heads=4, attn_every=2)


def _has_ssm_and_attention(model):
    return any("attn" in lp for lp in model.layers) and any("ssm" in lp for lp in model.layers)


def _has_encoder_and_cross(model):
    cfg = model.cfg
    return (len(model.encoder.layers) == cfg.n_enc_layers and all("cross" in lp and "ln_x" in lp for lp in model.layers)
            and all("attn" in lp and "ffn" in lp for lp in model.encoder.layers))


def _has_vision_prefix(model):
    return model.cfg.vision_tokens > 0 and model.cfg.prefix_lm and model.encoder is None


@pytest.mark.parametrize(
    "make_cfg,built",
    [
        pytest.param(lambda: get_smoke_config("jamba-1.5-large-398b"), _has_ssm_and_attention,
                     id="jamba-1.5-large-398b-hybrid"),
        pytest.param(_hybrid_mamba2, _has_ssm_and_attention, id="mamba2-130m-SSM"),
        pytest.param(lambda: get_smoke_config("whisper-medium"), _has_encoder_and_cross, id="whisper-medium-enc-dec"),
        pytest.param(lambda: get_smoke_config("paligemma-3b"), _has_vision_prefix,
                     id="paligemma-3b-enc-dec/prefix-LM"),
    ],
)
def test_later_slice_configs_raise_at_construction(make_cfg, built):
    """Every family builds now, none raises: pure SSM (mamba2-130m itself)
    since the SSM slice, MoE and MLA (deepseek-v2-lite, llama4-scout) since
    the MoE/MLA slice, the hybrid of attention and SSM layers (jamba; mamba2
    with attention every other layer) since the hybrid slice, with attention
    and SSM layers both, and since the enc-dec/prefix-LM slice whisper (an
    encoder, and cross-attention in every decoder layer) and paligemma (the
    vision prefix, no encoder)."""
    assert built(Transformer(make_cfg(), device="cpu"))
