#!/usr/bin/env python3
"""How the bf16 flash backward's rounding of P and dS meets its tolerance on real activations.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/flash_bwd_rounding.py                    # deepseek-7b, head dim 128
    python3 scripts/flash_bwd_rounding.py --model gemma-7b   # head dim 256
    python3 scripts/flash_bwd_rounding.py --model deepseek-v2-lite-16b   # MLA's (q/k 192, v 128)

It builds the model at its published width cut to ``chip_smoke.py``'s depth
(deepseek-7b 8 layers, gemma-7b 7, deepseek-v2-lite 4; bf16, random weights
from seed 0), runs
one forward and backward of the loss on ``chip_smoke.py``'s held-out probe
microbatch (2 x 2048) and keeps the q, k, v and upstream dO that each
layer's attention sees.  On each
layer's inputs (o and lse from the forward kernel) it counts the entries of
dq, dk and dv outside ``chip_smoke.py``'s backward tolerance (``_grads_close``:
rtol 1e-2 plus 1e-3 of the gradient's largest entry, and on the random cases at
(192, 128) at least ``BWD_ZERO_ATOL``, as ``mla_bwd_kernel`` holds them) against the plain
backward with fp32 P and dS: for the two CUDA backward kernels (the
tensor-core one, the SIMT one; at (192, 128), where the SIMT kernel takes
fp32 alone, the tensor-core one), and for the plain backward with P carried
in one bf16 term and in two (dS fp32), and with dS in one term and in two
(P fp32).  The same counts follow on ``chip_smoke.py``'s random bf16
inputs at its timed backward shape and its edge shapes of the model's head
dims (gemma-7b: ``GEMMA_BWD_TIMED``, ``GEMMA_BWD_SHORT`` and the D = 256
edges, MQA among them; deepseek-v2-lite: ``MLA_BWD_TIMED`` and
``MLA_BWD_EDGES``).  One JSON line per
case, then the totals over the layers and over the random cases.  Exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

#: (P terms, dS terms) of the plain backward's rounding model
VARIANTS = {"p_one_term": (1, 0), "p_two_terms": (2, 0), "ds_one_term": (0, 1), "ds_two_terms": (0, 2)}


#: model → chip_smoke.py's depth for it
DEPTHS = {"deepseek-7b": "DENSE_LAYERS", "gemma-7b": "GEMMA_LAYERS", "deepseek-v2-lite-16b": "MOE_TRAIN_LAYERS"}


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--model", choices=sorted(DEPTHS), default="deepseek-7b")
    model_name = args.parse_args(argv).model
    if not torch.cuda.is_available():
        print("flash_bwd_rounding: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_backward_ref
    from repro_torch.models import Transformer
    from repro_torch.train import TrainConfig, flash_widths, make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(model_name), n_layers=getattr(chip_smoke, DEPTHS[model_name]))
    model = Transformer(cfg, device="cuda", seed=0)
    it = make_train_iter(DataConfig(global_batch=chip_smoke.DENSE_BATCH, seq_len=chip_smoke.DENSE_SEQ,
                                    vocab_size=cfg.vocab_size, seed=7))
    probe = next(it)
    it.close()
    micro = {k: v[: chip_smoke.DENSE_BATCH // chip_smoke.DENSE_MICRO] for k, v in probe.items()}
    layers = chip_smoke.attention_inputs(model, make_loss_fn(model, TrainConfig()), micro)
    del model

    _, D, Dv = flash_widths(cfg)
    # (B, Sq, Sk, Hq, Hkv, D, Dv, causal)
    if cfg.mla is not None:
        shapes = [(1, S, S, chip_smoke.MLA_HEADS, chip_smoke.MLA_HEADS, D, Dv, True) for S in chip_smoke.MLA_BWD_TIMED]
        shapes += [(*e[:5], D, Dv, e[5]) for e in chip_smoke.MLA_BWD_EDGES]
    else:
        timed = [chip_smoke.BWD_TIMED] if D != chip_smoke.GEMMA_HEAD_DIM else [chip_smoke.GEMMA_BWD_TIMED,
                                                                                chip_smoke.GEMMA_BWD_SHORT]
        shapes = [(B, S, S, H, H, d, d, True) for B, S, H, d in timed]
        shapes += [(*e[:6], e[5], e[6]) for e in chip_smoke.BWD_EDGES
                   if (e[5] == D) == (D == chip_smoke.GEMMA_HEAD_DIM)]

    def cases():
        for layer, c in enumerate(layers):
            yield "layers", f"layer {layer}", c["q"], c["k"], c["v"], c["do"], True, c["kw"].get("scale")
        for i, (B, Sq, Sk, Hq, Hkv, d, dv, causal) in enumerate(shapes):
            q = chip_smoke.randn((B, Sq, Hq, d), torch.bfloat16, 700 + 10 * i)
            do = chip_smoke.randn((B, Sq, Hq, dv), torch.bfloat16, 701 + 10 * i)
            k = chip_smoke.randn((B, Sk, Hkv, d), torch.bfloat16, 702 + 10 * i)
            v = chip_smoke.randn((B, Sk, Hkv, dv), torch.bfloat16, 703 + 10 * i)
            yield ("random", f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={chip_smoke._dims_label(d, dv)[2:]} "
                             f"causal={causal}", q, k, v, do, causal, None)

    simt = D == Dv  # the SIMT kernel takes bf16 at the equal widths alone
    # the random cases at (192, 128) are mla_bwd_kernel's, which holds a gradient that is 0 in exact arithmetic
    # (S = 1) to BWD_ZERO_ATOL, as _grads_close does there; the others take no such floor
    zero_atol = chip_smoke.BWD_ZERO_ATOL if cfg.mla is not None else 0.0
    names = ["kernel_wgmma", *(["kernel_simt"] if simt else []), *VARIANTS]
    totals = {group: {name: {"dq": 0, "dk": 0, "dv": 0} for name in names} for group in ("layers", "random")}
    for group, case, q, k, v, do, causal, scale in cases():
        o, lse = fa.flash_attention(q, k, v, causal=causal, scale=scale, return_lse=True)
        kw = dict(causal=causal, scale=scale)
        want = flash_backward_ref(q, k, v, o, lse, do, **kw)
        got = {"kernel_wgmma": lambda: fa.flash_attention_backward(q, k, v, o, lse, do, **kw),
               "kernel_simt": lambda: fa.flash_attention_backward(q, k, v, o, lse, do, **kw, route="simt"),
               **{name: (lambda t=t: flash_backward_ref(q, k, v, o, lse, do, **kw, p_bf16_terms=t[0],
                                                        ds_bf16_terms=t[1]))
                  for name, t in VARIANTS.items()}}
        row = {"case": case, "entries": {"dq": q.numel(), "dk": k.numel(), "dv": v.numel()}}
        for name in names:
            out = got[name]()
            row[name] = {}
            for grad, g, w in zip(("dq", "dk", "dv"), out, want):
                g, w = g.float(), w.float()
                if not w.numel():  # no keys (Sk = 0): no dk or dv entries to count
                    row[name][grad] = {"outside_tol": 0, "worst_share_of_tol": 0.0}
                    continue
                atol = max(chip_smoke.BWD_ATOL_OF_MAX * w.abs().max().item(), zero_atol if group == "random" else 0.0)
                tol = chip_smoke.BWD_RTOL * w.abs() + atol
                err = (g - w).abs()
                n_out = int((err > tol).sum())
                row[name][grad] = {"outside_tol": n_out, "worst_share_of_tol": (err / tol).max().item()}
                totals[group][name][grad] += n_out
            del out
        print(json.dumps(row), flush=True)
        del o, lse, want
    print(json.dumps({"model": model_name, "layers": len(layers), "inputs": {
                          "layers": "the probe's first microbatch (2 x 2048), every layer",
                          "random": f"chip_smoke.py's randn at {[s[:6] for s in shapes]}"},
                      "outside_tol_total": totals,
                      "tolerance": {"rtol": chip_smoke.BWD_RTOL, "atol_of_max": chip_smoke.BWD_ATOL_OF_MAX,
                                    "random_zero_atol": zero_atol},
                      "kernel_terms": {"p": fa.BWD_P_TERMS, "ds": fa.BWD_DS_TERMS},
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
