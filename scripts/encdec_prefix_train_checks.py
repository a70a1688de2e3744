#!/usr/bin/env python3
"""Readings behind the training checks of ``chip_smoke.py``'s ``encdec_full_width`` (whisper-medium) and
``prefix_lm_full_width`` (paligemma-3b).

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/encdec_prefix_train_checks.py                  # both readings
    python3 scripts/encdec_prefix_train_checks.py attention        # one of them

* ``repeat``: each phase's cut (``ENCDEC_CUT``, ``PREFIX_CUT``) trained twice
  through ``chip_smoke.full_width_run`` from the same seed on the same
  batches: each run's losses, its held-out loss before and after, and the
  largest difference between the two runs' weights after the run.  The
  held-out change of one run is a reading only where it stands above the
  spread of such runs.
* ``attention``: on whisper-medium's weights after the second run, the
  attention-only check (``chip_smoke._train_only``, the phase's steps and
  repeated microbatch) over each set of projections into q, k and v (all of
  them, as the phase trains them; the decoder's self- and cross-attention;
  the encoder's) at each peak learning rate (the phase's ``DENSE_LR``;
  2.5e-4, whisper-medium's published one; 1e-4), with the backward
  kernel's gradients and with them negated: where ten steps descend and
  the control does not.

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

READINGS = ("repeat", "attention")
#: the attention-only reading's peak learning rates
LRS = (4.2e-4, 2.5e-4, 1e-4)


def _runs(cs, cut):
    """``cut`` trained twice from one seed: each run's readings, and the last run."""
    cfg, runs, first, run = cs.cut_config(cut), [], None, None
    for _ in range(2):
        run = None  # the earlier run's model goes before the next is built
        torch.cuda.empty_cache()
        run = cs.full_width_run(cfg, cut.steps, cut.eval_every, batch=cut.batch, seq=cut.seq, micro=cut.micro,
                                enc_len=cut.enc_len)
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
    return runs, run


def _attention(cs, run, smi):
    """The attention-only check over each set of whisper's q, k, v projections at each peak lr."""
    from repro_torch.kernels import ops

    cfg, cut = run.model.cfg, cs.ENCDEC_CUT
    qkv = ("wq", "wk", "wv")
    groups = {"all": [f"layers.{i}.{m}.{w}" for i in range(cfg.n_layers) for m in ("attn", "cross") for w in qkv]
                     + [f"encoder.layers.{j}.attn.{w}" for j in range(cfg.n_enc_layers) for w in qkv],
              "decoder_self_and_cross": [f"layers.{i}.{m}.{w}" for i in range(cfg.n_layers)
                                         for m in ("attn", "cross") for w in qkv],
              "encoder": [f"encoder.layers.{j}.attn.{w}" for j in range(cfg.n_enc_layers) for w in qkv]}
    params = dict(run.model.named_parameters())
    micro = {k: v[: cut.batch // cut.micro] for k, v in run.probe.items()}
    backward, out = ops.flash_attention_backward, {}
    for group, names in groups.items():
        saved = {n: params[n].detach().clone() for n in names}
        for lr in LRS:
            alone_cfg = dataclasses.replace(run.tcfg, schedule=dataclasses.replace(
                run.tcfg.schedule, peak_lr=lr, decay_steps=cs.ATTN_ONLY_STEPS))
            for label, factor in (("gradient", 1.0), ("negated", -1.0)):
                ops.flash_attention_backward = lambda *a, f=factor, **kw: tuple(f * t for t in backward(*a, **kw))
                try:
                    losses = cs._train_only(run.model, alone_cfg, micro, names, cs.ATTN_ONLY_STEPS)
                finally:
                    ops.flash_attention_backward = backward
                    with torch.no_grad():
                        for n in names:
                            params[n].copy_(saved[n])
                out[f"{group} lr={lr} {label}"] = {"drop": losses[0] - losses[-1], "losses": losses}
        del saved
    print(json.dumps({"reading": "attention", "config": cfg.name, "steps": cs.ATTN_ONLY_STEPS,
                      "min_drop": cs.ATTN_ONLY_DROP, "runs": out, "device": smi}), flush=True)


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("readings", nargs="*", choices=READINGS, help="default: both")
    readings = args.parse_args(argv).readings or list(READINGS)
    if not torch.cuda.is_available():
        print("encdec_prefix_train_checks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for cut in (cs.PREFIX_CUT, cs.ENCDEC_CUT):
        if "repeat" not in readings and cut is not cs.ENCDEC_CUT:
            continue
        runs, run = _runs(cs, cut) if "repeat" in readings else (None, None)
        if runs is not None:
            print(json.dumps({"reading": "repeat", "config": cut.config, "steps": cut.steps, "runs": runs,
                              "device": smi}), flush=True)
        if "attention" in readings and cut is cs.ENCDEC_CUT:
            if run is None:
                run = cs.full_width_run(cs.cut_config(cut), cut.steps, cut.eval_every, batch=cut.batch,
                                        seq=cut.seq, micro=cut.micro, enc_len=cut.enc_len)
                run.opt = None
            _attention(cs, run, smi)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
