#!/usr/bin/env python3
"""How the bf16 flash kernel's rounding of P meets the bf16 tolerance on real activations.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/flash_p_rounding.py

It builds deepseek-7b at full width (bf16, random weights from seed 0, as
``chip_smoke.py`` serves it), prefills the first prompt of ``chip_smoke.py``'s
serving trace and keeps the q/k/v that each of the 30 layers hands to the
attention op.  On each layer's inputs it counts the outputs that leave the
bf16 tolerance (atol 2e-2, rtol 1e-2) against the plain version (fp32
softmax and P): for the CUDA kernel, and for the blocked plain version
(``flash_blocked_ref``, 64 x 64 tiles) with P carried in one bf16 term and
in two (hi + lo, as the kernel carries it).  One JSON line per layer, then
the totals.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

BF16_TOL = dict(atol=2e-2, rtol=1e-2)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_p_rounding: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_blocked_ref
    from repro_torch.models import Transformer

    cfg = get_config("deepseek-7b")
    model = Transformer(cfg, device="cuda", seed=0)
    prompt = chip_smoke._full_width_load(cfg.vocab_size)[0][1].prompt
    probe = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    flash, captured = ops.flash_attention, []

    def capture(q, k, v, **kw):
        captured.append((q, k, v, kw))
        return flash(q, k, v, **kw)

    ops.flash_attention = capture
    try:
        with torch.no_grad():
            model.prefill(probe)
    finally:
        ops.flash_attention = flash

    totals = {"kernel": 0, "p_one_term": 0, "p_two_terms": 0}
    for layer, (q, k, v, kw) in enumerate(captured):
        want = flash(q, k, v, **{**kw, "impl": "plain"}).float()
        got = {
            "kernel": flash(q, k, v, **kw).float(),
            **{name: flash_blocked_ref(q, k, v, causal=kw["causal"], q_block=64, kv_block=64,
                                       p_bf16_terms=terms).float()
               for name, terms in (("p_one_term", 1), ("p_two_terms", 2))},
        }
        tol = BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()
        row = {"layer": layer, "max_abs_out": want.abs().max().item(), "outputs": want.numel()}
        for name, out in got.items():
            err = (out - want).abs()
            row[name] = {"outside_tol": int((err > tol).sum()), "max_abs_err": err.max().item()}
            totals[name] += row[name]["outside_tol"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"prompt_len": probe.shape[1], "layers": len(captured), "outside_tol_total": totals,
                      "tolerance": BF16_TOL, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
