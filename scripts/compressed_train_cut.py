#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s compressed training cut (``dist_full_width``).

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/compressed_train_cut.py                  # both readings
    python3 scripts/compressed_train_cut.py depth            # one of them
    python3 scripts/compressed_train_cut.py depth --depths 6 7

* ``depth``: deepseek-7b at its published width cut to each depth (default
  7, 8 and 9), trained through ``chip_smoke.full_width_run`` at
  ``DIST_CUT``'s settings (4 x 2048 in 2 microbatches, int8 gradient
  compression with error feedback, a bf16 accumulator) for ``STEPS`` steps:
  its parameter count and its peak device memory over the steps, against
  the 72 GB a cut must stay under (a depth that runs out of the card's
  memory says so); then the deepest cut under 72 GB trained the same steps
  without compression, for the peak beside it.
* ``held_out``: ``DIST_CUT`` trained at the phase's settings and steps
  four ways — without compression and with it, each with an fp32 and a
  bf16 accumulator — and the compressed bf16 run once more from the same
  seed: each run's losses, its held-out loss before and after (the phase's
  fixed probe batch), and the largest difference between the two repeated
  runs' weights after the run.

One JSON line a run, beside the card's name and power limit.  Exits non-zero
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

READINGS = ("depth", "held_out")
STEPS, LIMIT_GB = 3, 72


def depth(cs, smi, depths):
    cut = cs.DIST_CUT
    fits = []
    for layers, compress in [(n, True) for n in depths] + [(None, False)]:
        if layers is None:  # the deepest compressed cut under the limit, without compression
            if not fits:
                break
            layers = max(fits)
        cfg = dataclasses.replace(cs.cut_config(cut), n_layers=layers)
        kw = dict(compress_grads=True, accum_dtype=cut.accum_dtype) if compress else {}
        line = {"reading": "depth", "config": cfg.name, "n_layers": layers, "compress_grads": compress,
                "accum_dtype": kw.get("accum_dtype", "float32"), "steps": STEPS, "limit_gb": LIMIT_GB,
                "device": smi}
        try:
            run = cs.full_width_run(cfg, STEPS, STEPS, **kw)
        except torch.OutOfMemoryError as err:
            line.update(out_of_memory=str(err).splitlines()[0])
        else:
            line.update(params=run.n_params, max_memory_allocated_gb=run.peak_gb,
                        losses=[h["loss"] for h in run.hist])
            if compress and run.peak_gb < LIMIT_GB:
                fits.append(layers)
            del run
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    print(json.dumps({"reading": "deepest_under_limit", "compressed_layers": max(fits) if fits else None,
                      "device": smi}), flush=True)


def held_out(cs, smi):
    cut = cs.DIST_CUT
    cfg = cs.cut_config(cut)
    kept = None
    for compress, accum, repeat in [(False, "float32", 0), (False, "bfloat16", 0), (True, "float32", 0),
                                    (True, "bfloat16", 0), (True, "bfloat16", 1)]:
        run = cs.full_width_run(cfg, cut.steps, cut.eval_every, compress_grads=compress, accum_dtype=accum)
        line = {"reading": "held_out", "config": cfg.name, "n_layers": cfg.n_layers, "compress_grads": compress,
                "accum_dtype": accum, "repeat": repeat, "steps": cut.steps, "peak_lr": cs.DENSE_LR,
                "losses": [h["loss"] for h in run.hist], "grad_norms": [h["grad_norm"] for h in run.hist],
                "held_out_before": run.held_out_before, "held_out_after": run.held_out_after,
                "held_out_change": run.held_out_after - run.held_out_before,
                "max_memory_allocated_gb": run.peak_gb, "device": smi}
        weights = {n: p.detach() for n, p in run.model.named_parameters()}
        if compress and accum == "bfloat16":
            if kept is None:
                kept = {n: w.clone() for n, w in weights.items()}
            else:
                line["max_weight_difference_from_first_run"] = max(
                    (w.float() - kept[n].float()).abs().max().item() for n, w in weights.items())
        del run, weights
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("readings", nargs="*", choices=READINGS, help="default: both")
    args.add_argument("--depths", nargs="*", type=int, default=[7, 8, 9])
    ns = args.parse_args(argv)
    readings = ns.readings or list(READINGS)
    if not torch.cuda.is_available():
        print("compressed_train_cut: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if "depth" in readings:
        depth(cs, smi, ns.depths)
    if "held_out" in readings:
        held_out(cs, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
