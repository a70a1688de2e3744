"""The port's MoE layer and MoE decoders against the reference's, on the CPU in fp32.

Inputs come from numpy with a seed and go through both packages; weights
come from ``repro.models.init_params`` and move into the port through
``load_jax_params``.  Two smoke configs: deepseek-v2-lite (MLA attention,
8 experts top-2 plus a shared expert, a dense first layer before the
reference's stacked layers) and llama4-scout (GQA 4 over 2, 4 experts
top-1 plus a shared expert, no dense prefix).

Tolerances:

* The MoE layer alone: ``MOE_TOL`` (atol 2e-5, rtol 1e-4), the fp32
  tolerance of ``tests/test_kernels.py``; measured 4.8e-7 on outputs up to
  6.0.  Routing (expert indices), capacity and which entries drop are
  compared exactly.
* The gradient of the layer's output sum through the dispatch: within
  ``GRAD_REL`` (1e-4) of each leaf's largest entry, for summation order.
* Whole models: the logits within ``LOGITS_ATOL`` (5e-4).  The reference's
  init draws the stacked layers' weights at std ``repeats^-0.5`` (here
  repeats = 2 or 3, a gain of ~6-8 per projection at these widths), so fp32
  summation-order noise grows through the layers: the modules alone agree
  to ~1e-7, the deepseek-v2-lite forward measured 1.4e-4 on logits up to
  4.1 and llama4-scout 4.3e-5 on logits up to 4.3.  The aux loss within
  1e-6 relative.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models.layers import ffn_apply as ref_ffn_apply
from repro.models import model_defs as ref_model_defs
from repro.models import moe as ref_moe
from repro.models import prefill as ref_prefill
from repro.serve.cache_utils import transplant as ref_transplant
from repro.serve.engine import _write_slot as ref_write_slot
from repro_torch.configs import get_smoke_config
from repro_torch.models import Transformer, load_jax_params
from repro_torch.models import moe as port_moe
from repro_torch.models.params import iter_leaves
from repro_torch.serve.cache_utils import transplant

ARCHS = ("deepseek-v2-lite-16b", "llama4-scout-17b-a16e")
MOE_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_REL = 1e-4
LOGITS_ATOL = 5e-4
AUX_RTOL = 1e-6


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _moe_setup(arch, seed=3):
    cfg = ref_smoke(arch)
    params = ref_init_params(ref_moe.moe_defs(cfg, cfg.moe), jax.random.PRNGKey(seed), jnp.float32)
    return cfg, get_smoke_config(arch), params, _torch_tree(jax.tree_util.tree_map(np.asarray, params))


def _skewed_tokens(cfg, B, S, seed):
    """Tokens with a shared component, so the router prefers a few experts
    and a capacity factor of 1.25 drops entries."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, cfg.d_model)) + 2.0 * rng.standard_normal(cfg.d_model)).astype(np.float32)


def _kept(y, dense_parts):
    """Which of each token's k choices reached its output: the subset of its
    experts' weighted outputs (from the all-experts path) that, with the
    shared expert, reproduces ``y``.  ``(B*S, k)`` bool."""
    w, idx, per_expert, shared = dense_parts
    T, k = idx.shape
    y = np.asarray(y).reshape(T, -1)
    out = np.zeros((T, k), bool)
    for t in range(T):
        best = None
        for mask in range(1 << k):
            sel = [(mask >> j) & 1 for j in range(k)]
            got = shared[t] + sum(w[t, j] * per_expert[t, idx[t, j]] for j in range(k) if sel[j])
            err = np.abs(got - y[t]).max()
            if best is None or err < best[0]:
                best = (err, sel)
        assert best[0] < 1e-4, (t, best[0])
        out[t] = best[1]
    return out


def _dense_parts(params, x, cfg, moe):
    """Router weights and indices, every expert's output for every token, and
    the shared expert's, from the reference's own functions (numpy)."""
    xf = jnp.asarray(x).reshape(-1, cfg.d_model)
    w, idx, _ = ref_moe.router_topk(params, xf, moe)
    g = jnp.einsum("td,edf->tef", xf, params["wi_gate"])
    u = jnp.einsum("td,edf->tef", xf, params["wi_up"])
    h = jax.nn.silu(g) if cfg.hidden_act == "silu" else jax.nn.gelu(g, approximate=True)
    per_expert = jnp.einsum("tef,efd->ted", h * u, params["wo"])
    shared = ref_ffn_apply(params["shared"], xf, cfg.hidden_act) if moe.n_shared else jnp.zeros_like(xf)
    return tuple(np.asarray(a) for a in (w, idx, per_expert, shared))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_and_capacity_match_reference(arch):
    cfg, pcfg, params, tparams = _moe_setup(arch)
    x = _skewed_tokens(cfg, 2, 24, seed=1).reshape(-1, cfg.d_model)
    w, idx, aux = ref_moe.router_topk(params, jnp.asarray(x), cfg.moe)
    pw, pidx, paux = port_moe.router_topk(tparams, torch.from_numpy(x), pcfg.moe)
    assert np.array_equal(pidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(pw.numpy(), np.asarray(w), **MOE_TOL)
    np.testing.assert_allclose(float(paux), float(aux), rtol=AUX_RTOL)
    for n in (1, 7, 24, 37, 404, 1024):
        for cf in (1.0, 1.25, 2.0, float(cfg.moe.n_experts)):
            moe = replace(cfg.moe, capacity_factor=cf)
            assert port_moe.capacity(n, replace(pcfg.moe, capacity_factor=cf)) == ref_moe.capacity(n, moe)


@pytest.mark.parametrize("cf", [1.25, 2.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_its_drops_match_reference(arch, cf):
    """The sparse layer's output, and which (token, choice) entries drop at
    capacity, equal the reference's; at 1.25 the skewed tokens drop some."""
    cfg, pcfg, params, tparams = _moe_setup(arch)
    x = _skewed_tokens(cfg, 2, 48, seed=2)
    y, aux = ref_moe.moe_apply(params, jnp.asarray(x), cfg, cfg.moe, capacity_factor=cf)
    py, paux = port_moe.moe_apply(tparams, torch.from_numpy(x), pcfg, pcfg.moe, capacity_factor=cf)
    np.testing.assert_allclose(py.numpy(), np.asarray(y), **MOE_TOL)
    np.testing.assert_allclose(float(paux), float(aux), rtol=AUX_RTOL)
    parts = _dense_parts(params, x, cfg, cfg.moe)
    kept_ref = _kept(y, parts)
    kept_port = _kept(py.numpy(), parts)
    assert np.array_equal(kept_port, kept_ref)
    if cf == 1.25:
        assert not kept_ref.all(), "the skewed tokens must overflow some expert at capacity factor 1.25"


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_path_matches_reference_and_sparse_with_ample_capacity(arch):
    cfg, pcfg, params, tparams = _moe_setup(arch)
    x = _skewed_tokens(cfg, 2, 20, seed=4)
    y, aux = ref_moe.moe_apply_dense(params, jnp.asarray(x), cfg, cfg.moe)
    py, paux = port_moe.moe_apply_dense(tparams, torch.from_numpy(x), pcfg, pcfg.moe)
    np.testing.assert_allclose(py.numpy(), np.asarray(y), **MOE_TOL)
    np.testing.assert_allclose(float(paux), float(aux), rtol=AUX_RTOL)
    sparse, saux = port_moe.moe_apply(tparams, torch.from_numpy(x), pcfg, pcfg.moe,
                                      capacity_factor=float(pcfg.moe.n_experts))
    torch.testing.assert_close(sparse, py, **MOE_TOL)
    assert float(saux) == pytest.approx(float(paux))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradient_through_the_dispatch_matches_jax_grad(arch):
    """d(sum(y²) + 0.01 aux)/d(params, x) against ``jax.grad``, at a capacity
    factor of 1.25 (dropped entries carry no gradient in either).  With one
    expert a token (llama4-scout) the renormalised weight is w / w = 1, whose
    gradient is 0 in exact arithmetic and rounding noise in either
    framework, so there the router's gradient is compared on the aux loss
    alone, which is what trains it."""
    cfg, pcfg, params, tparams = _moe_setup(arch)
    x = _skewed_tokens(cfg, 1, 32, seed=5) * 0.5
    router_by_aux = cfg.moe.top_k == 1

    def grads(y_weight):
        def loss(p, xx):
            y, aux = ref_moe.moe_apply(p, xx, cfg, cfg.moe, capacity_factor=1.25)
            return y_weight * jnp.sum(y ** 2) + 0.01 * aux

        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
        leaves = {k: v.clone().requires_grad_() for k, v in _flat(tparams).items()}
        tx = torch.from_numpy(x).requires_grad_()
        y, aux = port_moe.moe_apply(_unflat(leaves), tx, pcfg, pcfg.moe, capacity_factor=1.25)
        (y_weight * (y ** 2).sum() + 0.01 * aux).backward()
        want = _flat(_torch_tree(jax.tree_util.tree_map(np.asarray, gp)))
        assert sorted(want) == sorted(leaves)
        got = {name: p.grad.numpy() for name, p in leaves.items()}
        return got, {k: v.numpy() for k, v in want.items()}, tx.grad.numpy(), np.asarray(gx)

    got, want, gx, want_x = grads(1.0)
    if router_by_aux:
        aux_got, aux_want, _, _ = grads(0.0)
        got["router"], want["router"] = aux_got["router"], aux_want["router"]
    for name, w in want.items():
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(got[name], w, atol=GRAD_REL * np.abs(w).max(), rtol=0, err_msg=name)
    np.testing.assert_allclose(gx, want_x, atol=GRAD_REL * np.abs(want_x).max(), rtol=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------- whole models
def _setup(arch, seed=7, **moe_overrides):
    cfg = ref_smoke(arch)
    pcfg = get_smoke_config(arch)
    if moe_overrides:
        cfg = replace(cfg, moe=replace(cfg.moe, **moe_overrides))
        pcfg = replace(pcfg, moe=replace(pcfg.moe, **moe_overrides))
    params = ref_init_params(ref_model_defs(cfg), jax.random.PRNGKey(seed), cfg.param_jdtype())
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = load_jax_params(Transformer(pcfg, device="cpu"), tree)
    return cfg, params, tree, model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_reference(arch):
    cfg, params, _, model = _setup(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    want_logits, want_aux = ref_forward(cfg, params, {"tokens": toks})
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(toks).long())
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32 and aux.ndim == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    assert n_moe == cfg.n_layers - cfg.moe.first_k_dense and float(aux) > 0.9 * n_moe  # the Switch loss is >= 1 a layer


def _ref_cache_leaf(cache, key):
    """The reference's cache leaf ``key`` over all layers, prefix first, as
    the port stacks it."""
    parts = [np.asarray(cache[name]["mixer"][key])[None] for name in sorted(cache) if name.startswith("prefix_")]
    parts.append(np.asarray(cache["blocks"]["pos_0"]["mixer"][key]))
    return np.concatenate(parts)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_16_decode_steps_at_per_sequence_positions(arch):
    """Prompts of 11 and 23 tokens transplanted into a shared cache, then 16
    batched decode steps, each sequence at its own position; at a capacity
    factor of n_experts nothing drops (the reference's decode-vs-forward
    convention for MoE)."""
    n_experts = ref_smoke(arch).moe.n_experts
    cfg, params, _, model = _setup(arch, capacity_factor=float(n_experts))
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
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=LOGITS_ATOL, rtol=0)
        transplant({k: v[:, slot:slot + 1] for k, v in cache.items()}, port_small)
        tokens.append(int(np.asarray(ref_logits).argmax(-1)[0]))
    pos = np.array([len(p) for p in prompts], np.int32)
    tok = np.array(tokens, np.int32)
    for _ in range(16):
        ref_logits, ref_cache = ref_decode_step(cfg, params, ref_cache, tok, pos)
        logits, out_cache = model.decode_step(cache, torch.from_numpy(tok).long(), torch.from_numpy(pos).long())
        assert out_cache is cache
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=LOGITS_ATOL, rtol=0)
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
        assert np.array_equal(logits.argmax(-1).numpy(), tok)
        pos = pos + 1
    for key in cache:
        want = _ref_cache_leaf(ref_cache, key)
        assert cache[key].shape == want.shape
        np.testing.assert_allclose(cache[key].numpy(), want, atol=5e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_jax_params_maps_the_dense_prefix_and_the_stack(arch):
    """deepseek-v2-lite's ``prefix_0`` (dense FFN) lands on layer 0 and the
    stacked ``blocks/pos_0`` (MoE) on layers 1.., leaf for leaf."""
    cfg, _, tree, model = _setup(arch)
    n_prefix = cfg.moe.first_k_dense
    assert sum(k.startswith("prefix_") for k in tree) == n_prefix
    port = dict(model.named_parameters())
    for i in range(cfg.n_layers):
        src = tree[f"prefix_{i}"] if i < n_prefix else jax.tree_util.tree_map(lambda a: a[i - n_prefix],
                                                                                 tree["blocks"]["pos_0"])
        kind = "ffn" if i < n_prefix else "moe"
        assert (f"layers.{i}.{kind}.wi_gate" in port) and (f"layers.{i}.{'moe' if kind == 'ffn' else 'ffn'}.wi_gate"
                                                          not in port)
        for path, arr in iter_leaves(src):
            assert np.array_equal(port[f"layers.{i}." + path.replace("/", ".")].detach().numpy(), arr), (i, path)


@pytest.mark.parametrize("k", [1, 2, 6])
def test_dispatch_gather_gradient_sums_in_order(k):
    """The MoE dispatch's gather (``moe.gather_tokens``) takes its gradient
    by summing each token's k rows in a fixed order, not by autograd's
    ``scatter_add`` (atomic adds on the card): on the CPU it equals
    autograd's ``scatter_add`` result within fp32 tolerance (2e-5), and its
    forward is the gather itself, bit for bit."""
    from repro_torch.models.moe import gather_tokens

    g = torch.Generator().manual_seed(k)
    B, T, d, E = 3, 11, 16, 8
    x = torch.randn(B, T, d, generator=g)
    flat_e = torch.randint(0, E, (B, T * k), generator=g)
    token_of = torch.argsort(flat_e, dim=1, stable=True) // k
    by_token = torch.argsort(token_of, dim=1, stable=True)
    grad = torch.randn(B, T * k, d, generator=g)
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = gather_tokens(x1, token_of, by_token, k)
    want = x2.gather(1, token_of[..., None].expand(B, T * k, d))
    assert torch.equal(got, want)
    (g1,), (g2,) = torch.autograd.grad(got, x1, grad), torch.autograd.grad(want, x2, grad)
    torch.testing.assert_close(g1, g2, atol=2e-5, rtol=0)
