#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s compressed training cut (``dist_full_width``).

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/compressed_train_cut.py                  # every reading
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
* ``seeds``: ``DIST_CUT`` trained from each seed of ``--seeds`` (added to
  the weights' seed and the training batches'; the probe batch is the
  phase's) for each step count of ``--steps``, without compression (an fp32
  accumulator, as ``dense_train_full_width``) and with it (the phase's):
  each run's held-out loss before and after and its change less the
  uncompressed run's of the same seed and steps; the first compressed run
  once more from the same seed (the same-code repeat); and, after each
  compressed run, the share of nonzero int8 codes in each compression group
  of a fresh gradient of the probe's first microbatch.

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

READINGS = ("depth", "held_out", "seeds")
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


def int8_shares(run, cut):
    """Share of nonzero int8 codes in each compression group of one fresh
    gradient (the probe's first microbatch, no error feedback carried)."""
    from repro_torch.optim import ef_compress, ef_state_init
    from repro_torch.train import compress_groups

    run.opt = run.trainer = None  # the moments and the trainer's buffers, room for three fp32 copies
    torch.cuda.empty_cache()
    params = dict(run.model.named_parameters())
    micro = {k: v[: cut.batch // cut.micro] for k, v in run.probe.items()}
    total, _ = run.held_out(micro)
    grads = {n: g.float() for n, g in zip(params, torch.autograd.grad(total, list(params.values())))}
    groups = compress_groups(run.model.cfg, params)
    deq = ef_compress(grads, ef_state_init(params), groups)[0]
    nonzero, size = {}, {}
    for n, d in deq.items():
        key = groups.get(n, n)
        nonzero[key] = nonzero.get(key, 0) + int((d != 0).sum())
        size[key] = size.get(key, 0) + d.numel()
    return {key: nonzero[key] / size[key] for key in nonzero}


def seeds(cs, smi, seed_list, step_counts):
    cut = cs.DIST_CUT
    cfg = cs.cut_config(cut)
    kept = None
    plan = [(steps, seed, compress, 0) for steps in step_counts for seed in seed_list for compress in (False, True)]
    plan.insert(2, (step_counts[0], seed_list[0], True, 1))
    uncompressed = {}
    for steps, seed, compress, repeat in plan:
        kw = dict(compress_grads=True, accum_dtype=cut.accum_dtype) if compress else {}
        run = cs.full_width_run(cfg, steps, cut.eval_every, seed=seed, **kw)
        change = run.held_out_after - run.held_out_before
        line = {"reading": "seeds", "config": cfg.name, "n_layers": cfg.n_layers, "seed": seed, "steps": steps,
                "compress_grads": compress, "accum_dtype": kw.get("accum_dtype", "float32"), "repeat": repeat,
                "peak_lr": cs.DENSE_LR, "losses": [h["loss"] for h in run.hist],
                "held_out_before": run.held_out_before, "held_out_after": run.held_out_after,
                "held_out_change": change, "device": smi}
        if not compress:
            uncompressed[steps, seed] = change
        else:
            line["change_less_uncompressed"] = change - uncompressed[steps, seed]
            weights = {n: p.detach() for n, p in run.model.named_parameters()}
            if (steps, seed) == (step_counts[0], seed_list[0]):
                if kept is None:
                    kept = {n: w.clone() for n, w in weights.items()}
                else:
                    line["max_weight_difference_from_first_run"] = max(
                        (w.float() - kept[n].float()).abs().max().item() for n, w in weights.items())
                    kept = None
            del weights
            if not repeat:
                line["int8_nonzero_share"] = int8_shares(run, cut)
        del run
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("readings", nargs="*", choices=READINGS, help="default: all")
    args.add_argument("--depths", nargs="*", type=int, default=[7, 8, 9])
    args.add_argument("--seeds", nargs="*", type=int, default=[0, 1, 2, 3])
    args.add_argument("--steps", nargs="*", type=int, default=[10, 30])
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
    if "seeds" in readings:
        seeds(cs, smi, ns.seeds, ns.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
