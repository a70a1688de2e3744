#!/usr/bin/env python3
"""Readings behind deepseek-v2-lite's training cut in ``chip_smoke.py`` (``moe_train_full_width``).

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/moe_train_cut.py                 # all three readings
    python3 scripts/moe_train_cut.py depth repeat    # some of them

* ``depth``: deepseek-v2-lite at its published widths cut to one layer more
  than ``MOE_CUT`` (5: 1 dense + 4 MoE), trained through
  ``chip_smoke.full_width_run`` at the phase's settings and steps: its
  parameter count and peak device memory over the steps, against the 72 GB
  that a cut must stay under.
* ``repeat``: ``MOE_CUT`` trained twice from the same seed on the same
  batches: each run's losses, its held-out loss before and after, and the
  largest difference between the two runs' weights after the run.  The
  held-out change of one run is a reading only where it stands above the
  spread of such runs.
* ``first_layer``: on the second run's weights, the attention-only check
  (``chip_smoke._train_only``, the phase's steps and repeated microbatch) over
  the dense first layer's wq, w_dkv, w_uk and w_uv alone, the layer that lies
  before the reference's stack, with the backward kernel's gradients, zeroed
  and negated: whether a control falls as far as the gradient does.

One JSON line each, beside the card's name and power limit.  Exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

READINGS = ("depth", "repeat", "first_layer")


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("readings", nargs="*", choices=READINGS, help="default: all three")
    readings = args.parse_args(argv).readings or list(READINGS)
    if not torch.cuda.is_available():
        print("moe_train_cut: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cut = cs.MOE_CUT
    if "depth" in readings:
        cfg = dataclasses.replace(cs.cut_config(cut), n_layers=cut.layers + 1)
        run = cs.full_width_run(cfg, cut.steps, cut.eval_every)
        print(json.dumps({"reading": "depth", "config": cfg.name, "n_layers": cfg.n_layers, "params": run.n_params,
                          "params_counted": cs.MOE_TRAIN_PARAMS_5, "steps": cut.steps,
                          "max_memory_allocated_gb": run.peak_gb, "limit_gb": 72, "losses": [h["loss"] for h in
                                                                                          run.hist],
                          "device": smi}), flush=True)
        del run
        torch.cuda.empty_cache()
    if not {"repeat", "first_layer"} & set(readings):
        return 0

    cfg, runs, first, run = cs.cut_config(cut), [], None, None
    for _ in range(2 if "repeat" in readings else 1):
        run = None  # the earlier run's model goes before the next is built
        torch.cuda.empty_cache()
        run = cs.full_width_run(cfg, cut.steps, cut.eval_every)
        run.opt = None
        torch.cuda.empty_cache()
        runs.append({"losses": [h["loss"] for h in run.hist], "held_out_before": run.held_out_before,
                     "held_out_after": run.held_out_after,
                     "held_out_change": run.held_out_after - run.held_out_before})
        weights = {n: p.detach() for n, p in run.model.named_parameters()}
        if first is None:
            first = {n: w.clone() for n, w in weights.items()}
        else:
            runs[-1]["max_abs_weight_diff_from_run_1"] = max((w - first[n]).abs().max().item()
                                                             for n, w in weights.items())
            del first
        del weights
    if "repeat" in readings:
        print(json.dumps({"reading": "repeat", "config": cfg.name, "n_layers": cfg.n_layers, "steps": cut.steps,
                          "runs": runs, "device": smi}), flush=True)

    if "first_layer" in readings:
        names = [f"layers.0.attn.{w}" for w in ("wq", "w_dkv", "w_uk", "w_uv")]
        params = dict(run.model.named_parameters())
        saved = {n: params[n].detach().clone() for n in names}
        alone_cfg = dataclasses.replace(run.tcfg, schedule=dataclasses.replace(run.tcfg.schedule,
                                                                                decay_steps=cs.ATTN_ONLY_STEPS))
        micro = {k: v[: cs.DENSE_BATCH // cs.DENSE_MICRO] for k, v in run.probe.items()}
        backward, losses = ops.flash_attention_backward, {}
        for label, factor in (("gradient", 1.0), ("zeroed", 0.0), ("negated", -1.0)):
            ops.flash_attention_backward = lambda *a, f=factor, **kw: tuple(f * t for t in backward(*a, **kw))
            try:
                losses[label] = cs._train_only(run.model, alone_cfg, micro, names, cs.ATTN_ONLY_STEPS)
            finally:
                ops.flash_attention_backward = backward
                with torch.no_grad():
                    for n in names:
                        params[n].copy_(saved[n])
        print(json.dumps({"reading": "first_layer", "config": cfg.name, "n_layers": cfg.n_layers,
                          "trained": names, "weight_std": {n: saved[n].float().std().item() for n in names},
                          "stack_weight_std": {n.replace("layers.0", "layers.1"): params[n.replace(
                              "layers.0", "layers.1")].float().std().item() for n in names},
                          "losses": losses, "drops": {k: v[0] - v[-1] for k, v in losses.items()},
                          "min_drop": cs.ATTN_ONLY_DROP, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
