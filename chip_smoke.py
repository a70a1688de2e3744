#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources (one ``nvcc`` per
source, all started together) and drives the port's paths:

* serving: the flash-attention kernels held against their plain version
  (bf16 on the tensor-core kernel, whose SASS must hold ``HGMMA`` and
  ``UTMALDG``; fp32 on the SIMT kernel) and the bf16 one timed beside SDPA
  at the serving lengths; gemma-7b's head dim of 256 (bf16 on the
  tensor-core kernels) checked forward and backward and timed beside SDPA
  and the SIMT kernel; the deepseek-7b smoke config served on the card
  and on the CPU and compared; deepseek-7b at full width (30 layers,
  d_model 4096, bf16, random weights from a seed) served through the
  continuous-batching engine, with the per-stream lanes checked and every
  prefill through the flash kernel;
* MoE/MLA serving: the flash forward at MLA's widths (q/k 192, v 128) on
  both kernels held against the plain version (SASS as above) and the bf16
  one timed beside SDPA; llama4-scout's and deepseek-v2-lite's smoke
  configs (the latter at the published MLA head dims) served on the card
  and on the CPU in fp32, experts compared first (a differing expert must
  be a tie), then tokens, statuses and lanes; deepseek-v2-lite at its
  published size, uncut (27 layers, 15.7 B parameters, bf16), served
  through the engine with every prefill's attention on the (192, 128)
  kernel, the kernel and the sparse MoE layer held on real inputs, no host
  sync in a decode step, and the device's idle share of a prefill and a
  decode step;
* hybrid serving: the bf16 SSD kernel at head dim 128 (two warpgroups a
  block; SASS as above) held against the sequential plain scan at edge
  shapes and at jamba's width and timed beside the plain chunked form at
  jamba's prefills, and fp32 at head dim 128 on the SIMT kernel; jamba's
  smoke config served on the card and on the CPU in fp32, experts compared
  first, then tokens, statuses and lanes; jamba at its published widths
  cut to 7 layers (35.07 B parameters, bf16) served through the engine
  with every prefill's SSD on the tensor-core kernel at head dim 128 and
  its attention on the flash kernel at D = 128, both kernels held on real
  inputs by relative error, no host sync in a decode step, and the
  device's idle share of a prefill and a decode step; jamba's smoke config
  trained three steps on the card and on the CPU (step 1's experts first,
  the zeroed and negated backward controls), and jamba at its published
  widths cut to its first layer (SSM + dense FFN, bf16 AdamW moments)
  trained through ``Trainer``: the SSD kernel at head dim 128 held on the
  real inputs, the SSM's and the FFN's weights trained alone beside zeroed
  and negated gradients, and the SSD backward's (autograd through the
  chunked form) share of the step's device time;
* qwen2-72b (QKV bias, 64 heads over 8 kv heads): its published widths cut
  to 36 layers served through the engine (every prefill's attention on the
  tensor-core kernel at group 8, held on real inputs; the trace replayed
  to the same tokens and lanes; the idle share of a prefill and a decode
  step) and cut to 3 layers trained with its published bf16 AdamW moments
  (the dense training checks below); its smoke config, at head dim 16, on
  the card and on the CPU;
* dense training: the bf16 flash backward kernel (tensor cores at every
  head dim, two warpgroups a block at 256; its dK/dV and dQ kernels' SASS
  must hold ``HGMMA`` and ``UTMALDG``) held against the plain FA-2 backward
  at edge shapes (head dim 256 and MQA among them), at B=1, S=2048, 32
  heads of 128 and at gemma-7b's 16 heads of 256 (S = 2048 and 404), and
  timed there beside SDPA's backward (replayed from a CUDA graph, and
  eagerly) and the SIMT backward; the four flash kernels at head dim 16
  (each run at 32 on zero-padded copies) held against their plain versions
  and timed, copies included, beside SDPA; the fp32 SIMT forward and backward timed
  beside SDPA in fp32; the deepseek-7b smoke config trained in fp32 (the SIMT
  kernels) on the card and on the CPU and compared; deepseek-7b at its
  published width cut to 8 layers and gemma-7b at its published width cut
  to 7 (bf16, remat full, AdamW, global batch 4 x 2048 in 2 microbatches)
  trained through ``Trainer`` with an eval lane, with the held-out loss,
  the per-stream lanes and the exact forward and backward launches (every
  backward on the tensor-core route) checked, every layer's real q, k, v
  and dO held through both kernels against the plain versions, and
  attention's weights alone trained beside zeroed and negated gradients;
* enc-dec and prefix-LM: the four flash kernels with a prefix-LM prefix
  (bf16 and fp32, forward and backward) held against their plain versions
  at edge prefixes and shapes (MQA at head dim 256 among them), a prefix
  of 0 and of S bit for bit the causal and the non-causal call, and timed
  beside SDPA with a boolean mask at paligemma's training shape, with
  whisper's encoder (non-causal 1,500 x 1,500) and cross-attention (448 x
  1,500) shapes timed beside SDPA; whisper's smoke config (at its head dim
  of 16) and paligemma's on the card and on the CPU in fp32: forward, prefill with
  every cache leaf, greedy decode, three train steps, each gap held against
  the same gap with the plain attention on the card; whisper-medium and
  paligemma-3b at their published sizes, uncut, trained through
  ``Trainer`` on stub frame or patch embeddings (every encoder, decoder,
  cross and prefix call on the tensor-core kernels, priced at its own
  shape and mask), then prefilled and decoded greedily from the trained
  weights through the model's entry points, fp32 decode held against a
  teacher-forced forward;
* training: the SSD-scan kernels held against the sequential plain scan
  (bf16 on the tensor-core kernel, whose SASS must hold ``HGMMA`` and
  ``UTMALDG``; fp32 on the SIMT kernel) and both timed in bf16; the mamba2
  smoke config trained, prefilled and decoded on the card
  and on the CPU and compared; mamba2-130m at its published widths cut to
  12 of its 24 layers (d_model 768, bf16 compute, fp32 parameters) trained for a few tens
  of steps with an eval lane, with the loss, the per-stream lanes and the
  exact number of SSD launches checked, the kernel held against the plain
  version on every layer's real inputs (where a form falls outside the
  tolerance, its worst element split into its intra-tile, inter-tile and
  skip terms as each form computes them, beside fp64), one step at seq 4096, and decode
  against forward in fp32; the fp32 SSD kernels checked at the same shapes
  and timed at the training microbatch and at seq 4096, kernel by kernel;
* distribution: a one-rank NCCL process group (an in-process store), the
  port's tiny mesh at (data 1, model 1) on the card, deepseek-7b's
  sharding plan at train_4k on it, a full-width cut's parameters
  distributed by the plan's placements and gathered back bit for bit, the
  one-stage GPipe pipeline over the cut's stacked layers (4 microbatches of
  2,048 tokens, the flash forward on ``wgmma``) bit for bit the sequential
  stack, and deepseek-7b's published width trained through ``Trainer``
  with int8 gradient compression and a bf16 accumulator (the other
  full-width training phases' checks and controls), beside the same cut's
  reading without compression;
* the step factory and the cost tooling: deepseek-7b at its published size,
  uncut (30 layers, bf16), a prefill cell (4 x 2,048 tokens) and a decode
  cell (4 rows against a 2,048-token cache) from ``launch.steps.build_cell``
  on a one-rank NCCL mesh, each counted by ``perf.cost`` on fake card
  tensors and on fake CPU tensors (the counts equal), run once with every
  prefill attention on the bf16 tensor-core flash kernel, profiled warm for
  the step's ms, busy ms, idle share and top kernels, and put on the
  roofline of the card nvidia-smi names; the flash kernel held against its
  plain version and timed beside SDPA at the prefill's shape; the counted
  prefill replayed as simulator kernels on two concurrent streams with the
  landings on the CUDA segment scatter and on NumPy (per-stream counts
  summing to the aggregate, tip at least clean, both streams tracked and
  overlapping, the same counts on both, launches equal to calls), and the
  accumulate entry timed at the replay's largest flush beside
  ``index_add_``; and deepseek-v2-lite's training cut run twice from one
  seed, bit for bit;
* the sharded steps: ``build_cell``'s steps with their inputs placed as
  DTensors at ``cell.in_shardings`` (``launch.steps.place``) on the
  one-rank NCCL mesh, each held against the same cell's plain-tensor step
  from one seed, every output leaf bit for bit by an exact digest and the
  flash and SSD launches equal (the kernels run on the local shards):
  deepseek-7b's prefill and decode cells above, its published width cut to
  8 layers trained one step of 4 x 2,048 tokens, and mamba2-130m's train
  cell at its widths cut to 12 layers; deepseek-v2-lite's prefill (4 x
  2,048) and decode (a 2,048-row latent cache) uncut and its train cell
  cut to 4 layers (MoE dispatch and combine and MLA on the shards, the
  (192, 128) flash forward and backward), and llama4-scout's prefill and
  decode at its widths cut to 8 of 48 layers (16 experts top-1, 40 query
  heads on 8), whose MoE op makes no host sync in a decode step
  (``torch.cuda.set_sync_debug_mode("error")``); whisper-medium's and
  paligemma-3b's three cells uncut (the encoder, cross attention and its
  cache; MQA at head dim 256 after a 256-token vision prefix), jamba's
  prefill and decode cut to 5 layers (SSM, MoE and its attention layer) and
  its train cell to 1; each run's ms, busy ms, idle share and peak memory,
  each kernel's route; run last, in a fresh process of its own (its two
  profiler traces a cell);
* the simulator: the segment-scatter kernel (the batched sweep's stat
  landing), its accumulate entry and the sequential-fold kernel held bit for
  bit against their plain versions, on test shapes and on the sweep's real
  landing inputs, and the segment kernel and its accumulate entry timed
  beside ``index_add_``; then
  the full scenario registry at 64 divergent draws each (1,088 jobs) run
  through ``BatchRunner(backend="batched")`` on ``array_backend="torch"``,
  with its signature held against the same jobs on NumPy, zero failed jobs
  and oracle failures, every kernel's launches equal to the calls that
  handed it work, the landing traced for the device's idle share, and a
  compiled-engine sweep whose running sums fold on the card.

Each phase prints one JSON line; then a ``{"kernels": [...]}`` line, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before that line; without a GPU it fails at
once.  The compiler's full report is written beside the built libraries,
``build/repro_torch/build.log``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: tests/test_kernels.py's shape set (B, S, Hq, Hkv, D): MHA, GQA, MQA ragged, S < block
KERNEL_SHAPES = [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 192, 6, 1, 64), (2, 64, 2, 2, 128)]
#: the fp32 forward's checks in phase_routes: every head dim, MHA, GQA and MQA, ragged tiles (64 rows, 32 at D = 256)
FP32_FWD_SHAPES = [*KERNEL_SHAPES, (1, 200, 8, 2, 128), (2, 97, 4, 4, 256), (1, 404, 16, 1, 256), (1, 33, 4, 2, 256)]
#: the main path's prefill attention: deepseek-7b, one prompt, 32 heads of 128
MAIN_SEQS = (1, 17, 63, 64, 65, 128, 500, 1024)
#: timed at B=1, H=32, D=128, bf16, causal; the shortest and longest prompt
#: that phase_full_width serves are timed beside these
TIMED_SEQS = (256, 512, 1024)
#: head dims of the bf16 kernel's shape checks (D = 32 takes the 64-byte swizzle)
BF16_HEAD_DIMS = (32, 64, 128)
#: SASS opcodes each instantiation of the bf16 flash kernel must hold: the
#: tensor-core product (wgmma) and the TMA tile load
SASS_OPS = ("HGMMA", "UTMALDG")
FP32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=1e-2)  # as tests/test_kernels.py: bf16 keeps 8 significant bits
#: smoke parity, card against CPU, both fp32 with TF32 off: the two differ
#: only by summation order (cuBLAS and the kernel against the CPU's BLAS and
#: the plain attention), ~1e-6 relative on logits of magnitude ~4
SMOKE_LOGITS_ATOL = 1e-4
#: Full width, bf16: the kernel is held against the plain version on the
#: q/k/v that every layer hands to ops.flash_attention while one real prompt
#: is prefilled, at BF16_TOL.  The logits are not a bf16 check: the
#: reference's init (layer weights at std n_layers^-0.5) makes attention
#: scores ~100 wide and softmax near one-hot, so one bf16 rounding that
#: flips a near-tied key in one layer moves the last logits far after 30
#: layers.  In fp32 (the same weights, converted exactly) the two paths'
#: last-position logits must agree to FULL_FP32_REL, relative L2.
FULL_FP32_REL = 1e-2
#: timing: each reading is the mean of LAUNCHES back-to-back calls, replayed
#: from one CUDA graph between a pair of CUDA events; ROUNDS readings per
#: function, the functions alternating within each round.  A plain PyTorch
#: version (a function named "plain..."), 10 to 100 times its kernel's time,
#: and any function whose last warm-up call took over SLOW_MS, takes
#: PLAIN_LAUNCHES calls a reading: a reading of some milliseconds either way
LAUNCHES, ROUNDS, PLAIN_LAUNCHES, SLOW_MS = 50, 9, 5, 1.0
#: the margins of the profiler traces that ``perf.cost.device_profile`` took
#: again (it brackets each traced call with spin kernels and retakes a trace
#: that lost one side's), and each kept trace's first device event's start
#: less its margin (ms after the window opens; far below 0, the clock drift),
#: printed at the end
BREAKDOWN_RETAKEN: list[float] = []
BREAKDOWN_LEAD_MS: list[float] = []

#: SSD kernel checks against the sequential plain scan: tests/test_kernels.py's
#: SSD shapes (B, S, H, P, N, G), grouped B/C among them, plus a P that is not
#: a multiple of the kernel's 32-row state slice and an S that is not a
#: multiple of its 64-row tile
SSD_SHAPES = [(1, 64, 2, 16, 8, 1), (2, 128, 4, 8, 16, 2), (2, 96, 6, 8, 16, 3), (1, 100, 2, 48, 8, 1)]
SSD_FP32_TOL = dict(atol=5e-5, rtol=1e-3)  # tests/test_kernels.py's SSD tolerance
SSD_BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # tests/test_kernels.py's bf16 SSD tolerance
#: mamba2-130m's SSD shape (H, P, N, G); bf16 checks at these lengths
SSD_WIDTH = (24, 64, 128, 1)
SSD_SEQS = (1, 37, 256, 1000)
#: timed: the training microbatch (B=4, S=256) and the train_4k length (B=1, 16 chunks of 256)
SSD_TIMED = ((4, 256), (1, 4096))
#: The final state's relative L2 error, kernel against the sequential plain
#: scan, on each layer's real inputs: both compute in fp32 from the same
#: bf16 inputs, so they differ by summation order; relative, because
#: exp(cum) can underflow over a chunk and shrink the state.
SSD_H_REL = 1e-3
#: smoke parity, card against CPU, fp32 with TF32 off.  Losses differ by
#: summation order (the kernel's 64-row tiles against 32-row chunks on the
#: CPU), ~1e-6 relative.  Grad norms: the CPU tests measured 4.9e-5 at the
#: first step and 2.0e-3 by the third between two fp32 implementations
#: (tests/test_torch_train.py), because AdamW's normalisation turns fp32
#: noise on near-zero gradients into whole steps.  Greedy decode logits
#: within 1e-4 on logits of magnitude ~1.
SSM_LOSS_RTOL, SSM_GNORM_RTOL, SSM_LOGITS_ATOL = 1e-4, 1e-2, 1e-4
#: full-width training: examples/train_100m.py's settings (batch 8 x 256, 2
#: microbatches, AdamW, warm-up 20 steps, cosine over its default 300 steps),
#: the first TRAIN_STEPS steps of that run.  At the reference's init the loss
#: sits at ~ln(vocab) for ~40 steps before it falls, so fewer steps show no fall.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, EVAL_EVERY, SCHEDULE_STEPS = 60, 8, 256, 2, 10, 300
#: mamba2-130m's published widths cut to MAMBA_LAYERS of its 24 layers: trained so, its SSD layers take inputs
#: 3-10x larger than the 24-layer run's (|y| to ~7e6), where large terms cancel, the case ssd_op holds the bf16
#: kernel on
MAMBA_LAYERS = 12
#: the loss on one fixed held-out batch must fall by at least this much over the run
EVAL_DROP = 0.05
#: gemma-7b's attention: 16 heads of 256, bf16 (the tensor-core kernels
#: forward and backward), checked and timed at the served prompt lengths
GEMMA_HEADS, GEMMA_HEAD_DIM = 16, 256
#: the fp32 forward's timed rows in phase_routes, (B, S, Hq = Hkv, D), causal: the bf16 row's shape, gemma-7b's 16
#: heads of 256 at the longest served prompt (S = None), the same 32 heads at D = 64 and 32, and dense_parity's
#: attention (the deepseek-7b smoke config's 4 heads of 32, microbatches of 2 x 64): D <= 64 has its own tiling
FP32_FWD_TIMED = {"flash_forward_fp32": (1, 512, 32, 128),
                  "flash_forward_fp32_d256": (1, None, GEMMA_HEADS, GEMMA_HEAD_DIM),
                  "flash_forward_fp32_d64": (1, 512, 32, 64), "flash_forward_fp32_d32": (1, 512, 32, 32),
                  "flash_forward_fp32_dense_parity": (2, 64, 4, 32)}
#: the flash backward, timed at B=1, S=2048, Hq=Hkv=32, D=128, bf16, causal:
#: one sequence of dense training's length at deepseek-7b's attention width;
#: and at gemma-7b's 16 heads of 256 at that length and at the longest
#: served prompt (404 tokens)
BWD_TIMED = (1, 2048, 32, 128)
GEMMA_BWD_TIMED = (1, 2048, 16, 256)
GEMMA_BWD_SHORT = (1, 404, 16, 256)
#: the tensor-core backward's edge shapes (B, Sq, Sk, Hq, Hkv, D, causal): a
#: ragged causal length, GQA group 2 at D = 64, non-causal Sq != Sk both ways
#: (D = 32 takes the 64-byte swizzle); at D = 256 (two warpgroups a block) a
#: ragged causal length and MQA, 8 q heads on 1 kv head, as paligemma-3b's
#: backbone has it
BWD_EDGES = [(2, 1000, 1000, 8, 8, 128, True), (1, 517, 517, 16, 8, 64, True),
             (1, 300, 700, 8, 4, 128, False), (2, 450, 130, 4, 2, 32, False),
             (1, 777, 777, 16, 16, 256, True), (2, 333, 333, 8, 1, 256, True)]
#: The backward kernel against flash_backward_ref on the same bf16 inputs
#: (the kernel's own o and lse): both compute in fp32 and round each output
#: once to bf16 (2^-8 relative), from fp32 sums taken in another order.  A
#: gradient is held to rtol BWD_RTOL plus an atol of BWD_ATOL_OF_MAX times
#: the tensor's largest entry: at the reference's init attention is near
#: one-hot, so dS = P (dP - D) cancels and the gradients' entries span many
#: decades.  The lse (fp32 both) to LSE_TOL on random inputs; on the
#: training inputs the scores reach the hundreds and the lse ~3,000 (fp32's
#: spacing there is 2.4e-4), and their fp32 sums, taken in another order on
#: the tensor cores, differ by up to 1.46e-3 (measured 9.8e-4 to 1.46e-3 a
#: layer on the H100, 4 to 6 of fp32's spacings): atol LSE_TRAIN_ATOL there.
#: A wider model's larger scores give a larger lse and error in the same
#: unit (qwen2-72b's 3-layer cut: lse to ~17,100, spacing 1.95e-3; 6.8e-3
#: measured, 3.5 spacings), so an lse is held to the larger of
#: LSE_TRAIN_ATOL and LSE_TRAIN_SPACINGS of fp32's spacing at its own
#: magnitude: 10 spacings, set from those readings (3.5 to 6), so an lse
#: off by more than 10 spacings (0.0195 at 17,100) fails.

BWD_RTOL, BWD_ATOL_OF_MAX = 1e-2, 1e-3
#: A gradient that is 0 in exact arithmetic (a query that sees one key: dS = P (dP - D_i) = 0) holds only the
#: fp32 noise of dP - D_i summed in two orders, which both the kernel and the plain version leave: held to
#: BWD_ZERO_ATOL where BWD_ATOL_OF_MAX of its largest entry is below it.  The noise grows with the terms of
#: the sums and the heads compared: measured on the H100 3.7e-7 at D = 64 and 5.5e-7 at D = 256 (4 to 16
#: heads; tests/test_torch_cuda.py holds those at 1e-6), and 1.33e-6 at (192, 128) over 16 heads (plain:
#: 4.9e-7), so mla_bwd_kernel's S = 1 edge takes 4e-6, about three times it
BWD_ZERO_ATOL = 4e-6
#: the fp32 backward kernel against the plain backward, both fp32 from the
#: same inputs: they differ by the order of their fp32 sums over up to 2,048
#: rows or columns (tests/test_torch_cuda.py's BWD_FP32_TOL)
BWD_FP32_TOL = dict(atol=1e-4, rtol=1e-4)
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
LSE_TRAIN_ATOL, LSE_TRAIN_SPACINGS = 5e-3, 10
#: dense smoke parity, card against CPU, fp32 with TF32 off, three steps from
#: the same weights.  The first step differs only by summation order and is
#: held tightly: loss and grad norm to rtol DENSE_STEP1_RTOL (measured 7e-8
#: and 9e-7 on the H100); each leaf's gradient, read as AdamW's first moment
#: after the step ((1 - b1) times the clipped gradient), within
#: DENSE_GRAD_REL of the CPU's in relative L2, and each leaf's change within
#: DENSE_STEP1_CHANGE_REL (AdamW's first step is lr g / (|g| + eps), so an
#: entry whose gradient sits near eps moves by a share of the lr that the
#: noise sets): measured 1.8e-4 and 1.4e-2 on the H100 (the CPU tests,
#: tests/test_torch_train.py, 4.5e-4 and 3.2e-2 between the port and the
#: reference).  After it the runs drift:
#: the reference's init makes attention near one-hot, so entries whose
#: gradient is at the noise level step in opposite directions, and the grad
#: norm moved 6 % at the second step and 10.6 % at the third, the loss
#: 1.8e-3 (measured on the H100).  Later steps: losses rtol DENSE_LOSS_RTOL,
#: grad norms rtol DENSE_GNORM_RTOL, each leaf's change over the three steps
#: within DENSE_CHANGE_REL (measured 0.31 on the H100; 0.22 in the CPU
#: tests).  The control, one card step with the backward kernel's gradients
#: zeroed and one with them negated, must fail the first step's checks: it
#: measured grad norms off by 0.85 and 0.076, gradients by 5.6 and 2.1.
DENSE_STEP1_RTOL, DENSE_GRAD_REL, DENSE_STEP1_CHANGE_REL = 1e-5, 2e-3, 0.1
DENSE_LOSS_RTOL, DENSE_GNORM_RTOL, DENSE_CHANGE_REL = 5e-3, 0.25, 0.5
#: dense training at full width: deepseek-7b's published width (d_model 4096,
#: 32 heads of 128, d_ff 11008, vocab 102400, bf16 params and compute, fp32
#: AdamW moments, remat full) cut to DENSE_LAYERS layers, the only cut: at
#: ~16 bytes a parameter (bf16 weight and gradient, fp32 accumulator, m and
#: v) 30 layers (6.9 B) need ~110 GB, 8 layers (2.46 B) ~39 GB.  Global batch
#: 4 x 2048 in 2 microbatches, AdamW (wd 0.1, clip 1.0), 10 steps, an eval
#: every 5, peak lr 4.2e-4 (DeepSeek LLM 7B's, arXiv:2401.02954) after 2
#: warm-up steps.  At the reference's init (layer weights at std 8^-0.5, so
#: attention near one-hot) ten steps on fresh batches move the held-out loss
#: by thousandths, so that check cannot tell a working backward from a
#: broken one; the attention-only check below can.
DENSE_LAYERS, DENSE_STEPS, DENSE_BATCH, DENSE_SEQ, DENSE_MICRO, DENSE_EVAL_EVERY, DENSE_LR = 8, 10, 4, 2048, 2, 5, 4.2e-4
#: gemma-7b at its published width (d_model 3072, 16 heads of 256, kv 16,
#: GeGLU d_ff 24576, vocab 256,000 with tied and scaled embeddings, bf16
#: params and compute, fp32 AdamW moments, remat full) cut to GEMMA_LAYERS
#: layers, the only cut: a layer is 276.8 M parameters and the tied
#: embedding 786.4 M.  Measured on the H100: 6 layers (2.45 B parameters)
#: peak at 63.9 GB and 7 (2.72 B) at 70.9 GB, 6.7-7.0 GB a layer, so 7 is
#: the deepest cut that peaks under 72 GB of the card's 80 (8 would reach
#: ~78).  Global batch 4 x 2048 in 2 microbatches,
#: GEMMA_STEPS steps, an eval every GEMMA_EVAL_EVERY.  Gemma's report
#: (arXiv:2403.08295) publishes no learning rate, so the peak lr is
#: DENSE_LR, DeepSeek LLM 7B's, a dense decoder of the same size.
GEMMA_LAYERS, GEMMA_STEPS, GEMMA_EVAL_EVERY = 7, 6, 3
#: the attention-only check: from the trained weights, only the stacked
#: layers' wq, wk and wv (MLA: wq, w_dkv, w_uk, w_uv; their gradients reach
#: them through the backward kernel's dq, dk and dv alone) take
#: ATTN_ONLY_STEPS AdamW steps (warm-up 2, cosine over ATTN_ONLY_STEPS, the
#: phase's peak lr) on one repeated microbatch (the probe's first),
#: everything else frozen.  The loss on it must fall by ATTN_ONLY_DROP; the
#: same run with the backward kernel's gradients zeroed, and with them
#: negated, must not.  Measured on the H100 (deepseek-7b): 11.8976 -> 11.7191
#: (a drop of 0.178) with the kernel's gradients, no change zeroed, a rise of
#: 0.170 negated.  The FFN-only check is the same run over the stacked
#: layers' MLP weights (a MoE layer's router, routed and shared experts),
#: its controls scaling those weights' own gradients: it holds the dense and
#: MoE layers' bf16 backward at full width (measured on the H100: drops of
#: 11.8 to 12.8, the repeated microbatch all but memorised; none zeroed; a
#: rise of 25 to 42 negated).  A layer before the reference's
#: stack (deepseek-v2's dense first layer, TrainCut.stack_from) is left out
#: of both: its init reads its true fan-in (MLA weights at std ~0.02,
#: against ~0.5 in the stack), and AdamW's lr-sized steps on it lower this
#: loss whatever their sign (scripts/moe_train_cut.py's first_layer reading).
ATTN_ONLY_DROP, ATTN_ONLY_STEPS = 0.05, 10
#: decode after prefill against forward on the extended sequence, fp32,
#: relative L2 of each step's logits: the same weights and math, the SSD
#: state handed from the kernel to the exact recurrence
DECODE_FP32_REL = 1e-3
#: MLA's prefill attention at deepseek-v2's published widths: 16 heads, q and k 128 + 64 rope columns, v 128
MLA_HEADS, MLA_DQK, MLA_DV = 16, 192, 128
#: the (192, 128) kernel timed at these lengths (the served trace's prompts are 132 to 404), bf16, causal
MLA_TIMED = (132, 404, 1024)
#: mla_bwd_kernel: the backward at MLA's (192, 128) on both routes against the plain version at these edge
#: shapes (B, Sq, Sk, Hq, Hkv, causal): ragged causal lengths over 16 heads (one row, a tile less and more a
#: row, 517), non-causal Sq != Sk both ways, no key at all (Sk = 0), GQA 16 over 4 (MLA runs 16 over 16); on
#: strided views of one wider projection (MLA_BWD_VIEWS); then held and timed at MLA_BWD_TIMED, one
#: training sequence and the longest served prompt, B = 1, 16 heads, causal
MLA_BWD_EDGES = [(1, 1, 1, 16, 16, True), (1, 63, 63, 16, 16, True), (2, 65, 65, 16, 16, True),
                 (1, 517, 517, 16, 16, True), (1, 300, 700, 16, 16, False), (2, 450, 130, 16, 16, False),
                 (1, 5, 0, 16, 16, False), (1, 404, 404, 16, 4, True)]
MLA_BWD_VIEWS = (2, 300, 16, 16)
MLA_BWD_TIMED = (2048, 404)
#: moe_parity: where the card and the CPU pick different experts for a token, the check passes only if that
#: token's top-(k+1) router probabilities lie within TIE_EPS of each other (a tie, not an error): both run
#: fp32 with TF32 off, so the router's inputs differ by summation order, ~1e-6 relative after three layers,
#: and its probabilities by ~1e-7
TIE_EPS = 1e-5
#: deepseek-v2-lite at its published size, counted from repro.models.model_defs (and model_defs here)
MOE_FULL_PARAMS = 15_706_484_224
#: moe_full_width holds the sparse MoE layer (at capacity factor n_experts, so nothing drops) against the
#: all-experts path on one layer's real hidden states in fp32 (the bf16 weights and hidden states upcast
#: exactly), at FP32_TOL: the two compute one function in another summation order.  Not in bf16: there the
#: sparse path adds each token's k = 6 weighted expert outputs and the shared expert's one after another in
#: bf16, as the reference's segment_sum does, where the all-experts path sums in fp32 and rounds once, so the
#: two differ by design by up to 2^-9 of a partial sum at each of those roundings (1.0 apart on outputs up
#: to 206 measured)
#: operations of one decode step listed from its device breakdown
TOP_OPS = 12
#: moe_train_parity: deepseek-v2-lite's smoke config at the published MLA head dims, card against CPU in
#: fp32, held at step 1 to dense_parity's tolerances (DENSE_STEP1_*) after its experts (a token routed to
#: other experts must be a top-k tie, TIE_EPS), but for the grad norm: the MoE layers' fp32 sums (the
#: experts' bmm, the router's softmax, the combine) move it past DENSE_STEP1_RTOL whatever the attention
#: runs.  The phase measures it both ways, card against CPU at step 1: with the kernels, and with the plain
#: attention on the card ("plain_attention_step1_gaps" in its line).  Read on the H100 (PERF.md §6 names the
#: runs): 1.44e-4 with the kernels, 7.0e-5 with the plain attention; deepseek-7b's (dense) 4.2e-6 and 3.9e-6.
#: MOE_STEP1_GNORM_RTOL is about three times the kernels' reading; each leaf's gradient stays within
#: DENSE_GRAD_REL (measured 8.1e-4), and the zeroed and negated controls miss the grad norm by 0.94 and
#: 0.099 and the gradients by 16.7 and 1.9.  After step 1 the two runs' weights differ by AdamW's amplified
#: fp32 noise and the router sends the tokens whose top-k margin sits below that difference to other
#: experts (12 of 512 at step 2, 315 at step 3, margins up to 4.7e-2), so the later steps are printed with
#: those counts and not held.
MOE_STEP1_GNORM_RTOL = 4.5e-4
#: moe_train_full_width: deepseek-v2-lite at its published widths (d_model 2048, 16 MLA heads at q/k 128 + 64
#: and v 128 over a 512-wide latent, 64 experts top-6 of 1408 and 2 shared after a dense first layer of
#: 10944, vocab 102400, untied; bf16 params and compute, fp32 AdamW moments, remat full) cut to
#: MOE_TRAIN_LAYERS layers (one dense and three MoE), the only cut.  Counted from model_defs: 4 layers
#: 2,254,983,168 parameters, 5 2,839,831,040, 6 3.425 B; at ~16 bytes a parameter (bf16 weight and gradient,
#: fp32 accumulator, m and v) 36.1, 45.4 and 54.8 GB of states.  scripts/moe_train_cut.py's depth reading
#: trains 5 layers through this phase's run and reads its peak: past 72 GB of the card's 80, so 4 is the
#: deepest cut under it (gemma-7b's rule).  gemma-7b's settings: 4 x 2048 in 2 microbatches, GEMMA_STEPS
#: steps, an eval every GEMMA_EVAL_EVERY, peak lr DENSE_LR.
MOE_TRAIN_LAYERS, MOE_TRAIN_PARAMS_5 = 4, 2_839_831_040


class TrainCut(NamedTuple):
    """A full-width training phase's per-config facts (_train_full_width)."""
    phase: str
    config: str
    layers: int
    steps: int
    eval_every: int
    params: int  # the cut's parameter count, from model_defs
    stack_from: int  # the first layer of the reference's stack: the weights trained alone are the stack's
    depth: str  # why this depth
    held_out: str  # "falls": the held-out loss must fall over the run; else why it is printed and not held
    batch: int = DENSE_BATCH  # rows a step
    seq: int = DENSE_SEQ  # text tokens a row
    micro: int = DENSE_MICRO  # microbatches a step
    enc_len: int = 0  # an encoder-decoder config's stub frame embeddings a row
    compress_grads: bool = False  # TrainConfig's: int8 compression with error feedback
    accum_dtype: str = "float32"  # TrainConfig's gradient accumulator


DENSE_CUT = TrainCut("dense_train_full_width", "deepseek-7b", DENSE_LAYERS, DENSE_STEPS, DENSE_EVAL_EVERY,
                     2_457_931_776, 0, "8 of 30 layers, ~39 GB of states at ~16 bytes a parameter", "falls")
GEMMA_CUT = TrainCut("gemma_train_full_width", "gemma-7b", GEMMA_LAYERS, GEMMA_STEPS, GEMMA_EVAL_EVERY,
                     2_724_246_528, 0, "7 of 28 layers, the deepest cut whose peak stays under 72 GB", "falls")
#: deepseek-v2-lite's held-out loss over its 6 steps moved by thousandths either way in the runs that took
#: it (-0.0007 and +0.0111 in two runs of one seed before the MoE dispatch's gradient lost its atomics), so it
#: is printed; the FFN-only check holds the MoE weights' gradients instead, and the phase holds a second run
#: from the same seed on the same batches bit for bit the first (the dispatch's gather now sums each token's
#: k gradient rows in order, models/moe.py ``gather_tokens``)
MOE_CUT = TrainCut("moe_train_full_width", "deepseek-v2-lite-16b", MOE_TRAIN_LAYERS, GEMMA_STEPS,
                   GEMMA_EVAL_EVERY, 2_254_983_168, 1,
                   "4 of 27 layers (1 dense + 3 MoE), the deepest cut whose peak stays under 72 GB "
                   "(scripts/moe_train_cut.py depth: 5 layers past it)",
                   "printed: a 6-step change of thousandths either way at this init; the FFN-only check holds "
                   "the MoE weights' gradients, and the repeat (moe_train_repeat) holds a second run bit for bit")
#: encdec_full_width: whisper-medium at its published size, uncut: 24 encoder and 24 decoder layers, d_model
#: 1024, 16 heads of 64, d_ff 4096, vocab 51,865 padded to 51,968, untied, no positional rotation (sinusoidal
#: positions on the encoder, none on the decoder, as the reference), bf16 params and compute, fp32 AdamW
#: moments, remat "dots" (the port recomputes the whole layer: the same math).  1,012,525,056 parameters from
#: model_defs (the encoder 402,703,360): ~16 GB of states at ~16 bytes a parameter.  A row: 1,500 stub frame
#: embeddings (30 s of audio after the stubbed conv front end) and 448 tokens (whisper's text context); 8 rows
#: in 2 microbatches, gemma-7b's steps, evals and peak lr.
ENCDEC_CUT = TrainCut("encdec_full_width", "whisper-medium", 24, GEMMA_STEPS, GEMMA_EVAL_EVERY, 1_012_525_056, 0,
                      "uncut: 24 encoder and 24 decoder layers", "falls", batch=8, seq=448, micro=2, enc_len=1500)
#: prefix_lm_full_width: paligemma-3b at its published size, uncut: 18 layers, d_model 2048, 8 heads of 256 on
#: one kv head, d_ff 16,384 GeGLU, a tied and scaled embedding of 257,216 (padded 257,280), bf16, remat full.
#: 2,508,793,856 parameters (the embedding 526,909,440): ~40 GB of states.  A row: 256 stub patch embeddings
#: (the 224-px SigLIP output) and 256 tokens, so attention runs at S = 512 with a prefix of 256; 8 rows in 2
#: microbatches.
#: Its held-out loss over the 6 steps is printed, not held: two runs from one seed are bit for bit the same
#: (scripts/encdec_prefix_train_checks.py repeat), and this run's held-out loss rises a little (PERF.md), while
#: its attention-only and FFN-only checks fall with their controls failing
PREFIX_CUT = TrainCut("prefix_lm_full_width", "paligemma-3b", 18, GEMMA_STEPS, GEMMA_EVAL_EVERY, 2_508_793_856, 0,
                      "uncut: 18 layers",
                      "printed: 6 steps of 2,048 text tokens leave it where two bit-identical runs of one seed leave "
                      "it, a little above its start (scripts/encdec_prefix_train_checks.py repeat); the "
                      "attention-only and FFN-only checks hold the gradients", batch=8, seq=256, micro=2)
#: dist_full_width: deepseek-7b's published width (DENSE_CUT's config, settings and controls: 4 x 2048 in 2
#: microbatches, DENSE_STEPS steps, peak lr DENSE_LR) trained with int8 gradient compression (error feedback
#: in fp32, one scale per reference leaf: the stacked layers share one) and a bf16 accumulator, cut to
#: DIST_LAYERS layers, the deepest cut whose peak stays under 72 GB of the card's 80 (gemma-7b's rule; the
#: reading is PERF.md's, scripts/compressed_train_cut.py depth).  That is DENSE_CUT's depth, so the reading
#: beside it without compression is dense_train_full_width's, earlier in the run.  The mesh and the pipeline take a cut of
#: DIST_PIPE_LAYERS layers: DIST_PIPE_MICRO microbatches of one 2,048-token row through one stage.  Its held-out
#: loss is held to the same cut's without compression: from the same weights on the same batches, its change
#: over the run must lie within DIST_HELD_OUT_GAP of dense_train_full_width's.  Alone, the change is no test
#: at this init: over four seeds of both (scripts/compressed_train_cut.py seeds, PERF.md) the uncompressed
#: 10-step change ran from -0.230 to +0.0024 and the compressed from -0.225 to +0.0080, each rising at some
#: seed, while the compressed less the uncompressed stayed within 0.0178 (0.0285 over 30 steps).  Its
#: attention-only and FFN-only checks run each step's gradients through the same int8 error-feedback
#: compression (``_train_only`` with ``compress_grads``), beside zeroed and negated controls.
DIST_LAYERS, DIST_PARAMS, DIST_PIPE_LAYERS, DIST_PIPE_MICRO = 8, 2_457_931_776, 4, 4
DIST_HELD_OUT_GAP = 0.03
DIST_CUT = TrainCut("dist_full_width", "deepseek-7b", DIST_LAYERS, DENSE_STEPS, DENSE_EVAL_EVERY, DIST_PARAMS, 0,
                    "8 of 30 layers, the deepest cut whose peak stays under 72 GB with compression "
                    "(scripts/compressed_train_cut.py depth)",
                    f"within {DIST_HELD_OUT_GAP} of the uncompressed cut's change (dense_train_full_width's: the "
                    "same weights, batches and probe); the change alone rises at some seeds with and without "
                    "compression (scripts/compressed_train_cut.py seeds)",
                    compress_grads=True, accum_dtype="bfloat16")
#: qwen2_train_full_width: qwen2-72b at its published widths (QWEN2_SERVE_LAYERS' note) with its published bf16
#: AdamW moments, cut to 3 layers (5,124,478,976 parameters).  At ~12 stored bytes a parameter (bf16 weight,
#: gradient, m and v, the fp32 accumulator) 3 layers hold 61.5 GB beside the fp32 logits of a 2 x 2,048-token
#: microbatch over 152,064 entries (2.5 GB each for the logits, their softmax and their gradient); 4 layers
#: (6.0 B) hold 72.0 GB of states alone.  AdamW runs slice by slice (optim.adamw.CHUNK_ELEMS): its fp32
#: temporaries over all leaves at once (~20 bytes a bf16 parameter) would not fit at any depth.  The held-out
#: loss is printed; the attention-only and FFN-only checks hold the gradients.
QWEN2_CUT = TrainCut("qwen2_train_full_width", "qwen2-72b", 3, GEMMA_STEPS, GEMMA_EVAL_EVERY, 5_124_478_976, 0,
                     "3 of 80 layers: ~61.5 GB of states at ~12 bytes a parameter; 4 layers hold 72 GB of states",
                     "printed: 6 steps at the reference's init move it by thousandths either way (the other "
                     "full-width cuts); the attention-only and FFN-only checks hold the gradients")
#: jamba_train_full_width: jamba-1.5-large at its published widths (hybrid_full_width's note) with its published
#: bf16 moments, cut to its first layer: an SSM layer (128 heads of 128, d_state 128, the bf16 SSD kernel at P =
#: 128 forward, autograd through the chunked form backward) and a dense FFN of 24,576, 2,083,628,416 parameters
#: with the untied embedding and head.  No deeper cut fits one card: the second layer is a MoE layer of 16
#: experts of 24,576 (9.66 B parameters of experts; 12,153,334,528 at 2 layers, ~146 GB of states at ~12 bytes a
#: parameter).  The held-out loss is printed; the SSM-only and FFN-only checks hold the gradients.
JAMBA_CUT = TrainCut("jamba_train_full_width", "jamba-1.5-large-398b", 1, GEMMA_STEPS, GEMMA_EVAL_EVERY,
                     2_083_628_416, 0,
                     "1 of 72 layers (SSM + dense FFN): the second layer is MoE, 12.15 B parameters at 2 layers",
                     "printed: 6 steps at the reference's init; the SSM-only and FFN-only checks hold the gradients")
#: serving from the trained weights through the model's entry points: (rows, prompt tokens, greedy decode
#: steps); whisper's prompt is a few forced tokens after 1,500 frames, paligemma's follows its 256 patches
ENCDEC_DECODE, PREFIX_DECODE = (4, 4, 30), (4, 32, 16)
#: encdec_parity's stub frames a row (the smoke config's encoder)
ENCDEC_PARITY_FRAMES = 80
#: the smoke parity phases' cache leaves, card against CPU, relative to each leaf's largest entry
SMOKE_CACHE_REL = 1e-4
#: the smoke parity phases hold each card-against-CPU gap with the kernels within the larger of its
#: dense_parity tolerance and this many times the same gap with the plain attention on the card: the card's
#: own fp32 noise (cuBLAS against the CPU's GEMMs), which whisper's smoke weights amplify past those
#: tolerances whatever the attention runs (PERF.md)
SMOKE_NOISE_FACTOR = 2.0
#: prefix_kernel's edge shapes (B, S, Hq, Hkv, D): S off the 64-row tile at head dims 64 and 128, MQA at
#: paligemma's D = 256, and paligemma's own training shape; each at the prefixes PREFIX_LENS and one past S
PREFIX_EDGES = [(1, 200, 4, 2, 64), (2, 130, 4, 4, 128), (1, 300, 8, 1, 256), (2, 517, 8, 1, 256)]
PREFIX_LENS = (0, 1, 63, 64, 65)
#: prefix_kernel's timed shapes: paligemma's training microbatch (B, S, Hq, Hkv, D, prefix), and whisper's two
#: new ones at its microbatch, (B, Sq, Sk, H, D) non-causal: the encoder's and the cross-attention's
PREFIX_TIMED = (4, 512, 8, 1, 256, 256)
ENCDEC_TIMED = {"encoder": (4, 1500, 1500, 16, 64), "cross": (4, 448, 1500, 16, 64)}
#: head dim 16 (qwen2-72b's and whisper-medium's smoke configs), which the kernels take at 32 on zero-padded
#: copies (flash_attention.PAD_D16): checked in both directions and both dtypes at D16_EDGES (B, Sq,
#: Sk, Hq, Hkv, causal: one row, ragged causal lengths, GQA 4 and MQA, non-causal Sq != Sk both ways), then
#: timed with the copies beside the plain versions and SDPA at D16_TIMED: the qwen2 smoke's training
#: microbatch (2 x 64, 8 heads on 2, fp32: the SIMT kernels, as qwen2_parity runs them) and a long bf16
#: sequence (1 x 2,048, 32 heads: the tensor-core kernels)
D16_EDGES = [(1, 1, 1, 2, 1, True), (2, 100, 100, 8, 2, True), (1, 517, 517, 8, 1, True), (1, 77, 150, 4, 4, False),
             (2, 130, 45, 4, 2, False)]
D16_TIMED = {"qwen2_smoke_fp32": (2, 64, 8, 2, torch.float32), "long_bf16": (1, 2048, 32, 32, torch.bfloat16)}
#: jamba's SSD width (H, P, N, G): 128 heads of 128, d_state 128, one group.  The bf16 kernel at head dim
#: 128 (two warpgroups a block) is checked there at P128_SEQS with and without h0, at the edge shapes
#: P128_EDGES (B, S, H, P, N, G: a ragged S over several chunks, d_state 64 with grouped B/C, one row), the
#: fp32 SIMT kernel at P128_FP32, and the bf16 kernel is timed at P128_TIMED, the shortest and longest
#: prompt of the served trace (jamba's prefills)
JAMBA_SSD_WIDTH = (128, 128, 128, 1)
P128_SEQS = (1, 132, 404)
P128_EDGES = [(2, 300, 4, 128, 64, 2), (3, 700, 6, 128, 128, 3), (1, 1, 6, 128, 128, 3)]
P128_FP32 = [(1, 404, 128, 128, 128, 1), (2, 150, 4, 128, 128, 2)]
P128_TIMED = (132, 404)
#: the fp32 SIMT kernels timed at jamba's width at the longest served prompt
P128_FP32_TIMED = 404
#: hybrid_full_width: jamba-1.5-large at its published widths cut to HYBRID_LAYERS layers, the first seven
#: positions of its 8-layer superblock (SSM + FFN at 0, 2, 6; SSM + MoE at 1, 3, 5; attention + FFN at 4):
#: every kind of layer it has.  Counted from model_defs, in bf16: 5 layers 23.99 B parameters (44.7 GiB),
#: 6 34.06 B (63.4 GiB), 7 35.07 B (65.3 GiB), the whole superblock 45.14 B (84.1 GiB), more than the card
#: holds.  At 7 layers the superblock period falls back to 7 (one repeat), in both packages.
HYBRID_LAYERS, HYBRID_PARAMS = 7, 35_067_494_656
#: the served trace is _full_width_load's at deepseek's vocabulary (10 requests, prompts of 132-404 tokens,
#: 16-30 new tokens, as deepseek-7b and deepseek-v2-lite serve it); jamba's runs its token ids modulo its
#: own vocabulary (65,536), so the arrivals and lengths are the same
TRACE_VOCAB = 102_400
#: hybrid_full_width holds the SSD kernel (against the sequential plain scan) and the flash kernel (against
#: the plain version) on jamba's real inputs by relative L2 error, within REAL_INPUT_REL, about one bf16
#: rounding (2^-9) of every output.  At one repeat the reference's init draws jamba's layer weights at std 1,
#: so the SSD's x reaches ~800, dt ~400 and y ~4e10: 5 to 10 of a layer's 4.2 M entries are terms of ~1e6
#: that cancel to ~1e2, past what the kernel's two-term bf16 operands (~16 bits) keep, so they fall outside
#: SSD_BF16_TOL of an fp64 scan where the sequential fp32 scan does not; q and k reach ~1e2, so softmax is
#: near one-hot and a near tie flips an output row.  Measured on the H100: SSD y 2.5e-4 to 2.7e-4 a layer
#: against the sequential scan (both 1.65e-3 to 1.66e-3 against fp64: bf16 output rounding), the state
#: 9e-6 to 5.1e-5 (held to SSD_H_REL), attention 3.3e-5 with 31 of 2.1 M entries outside BF16_TOL.
REAL_INPUT_REL = 2e-3
#: qwen2_full_width: qwen2-72b at its published widths (d_model 8192, 64 heads of 128 over 8 kv heads: GQA
#: group 8, QKV bias, SwiGLU d_ff 29,568, rope theta 1e6, an untied vocabulary of 152,064; bf16, random weights
#: from seed 0) cut to QWEN2_SERVE_LAYERS of its 80 layers.  Counted from model_defs: 877,684,736 parameters a
#: layer and 2,491,416,576 of embedding and head, so 36 layers hold 34,088,075,264 (68.2 GB in bf16), 37
#: 34.97 B (69.9 GB): at 36 the init peaks at ~74.7 GB (the weights and one leaf's fp32 draw, the 5 GB
#: embedding's the largest) and serving (the engine's cache, 4 slots of 1,024 tokens, 0.6 GB, and a prefill's
#: activations) below it, leaving ~10 GB of the card's 85 free; 37 would leave ~8 GB.  It serves the
#: full-width trace (10 requests, prompts of 132-404 tokens, TRACE_VOCAB's ids, all below qwen2's vocabulary),
#: then the same trace again through a fresh engine: greedy tokens and lanes equal.
QWEN2_SERVE_LAYERS, QWEN2_SERVE_PARAMS = 36, 34_088_075_264
#: the reference draws the QKV biases as zeros; the served cut draws them from this seed at this std, so that
#: the bias path moves the outputs (the phase checks that zeroing them moves the probe's logits)
QWEN2_BIAS_SEED, QWEN2_BIAS_STD = 5, 1.0
#: the simulator's batched sweep: the full scenario registry at SIM_DRAWS
#: divergent draws a scenario (1,088 jobs), event engine, as a validation
#: sweep of the per-kernel, per-stream counts runs it; the segment kernel is
#: also timed on the SIM_SMALL_DRAWS sweep's landing; the compiled engine
#: runs SIM_COMPILED_DRAWS draws, whose trace workloads fold bandwidth
#: pointers through running_sum.  Everything here is compared bit for bit.
SIM_DRAWS, SIM_SMALL_DRAWS, SIM_COMPILED_DRAWS, SIM_SEED = 64, 2, 2, 0
#: segment-kernel checks (events, n_segs, row_size): tests/test_batched.py's
#: shapes, with events on two rows past the table that must drop
SEG_SHAPES = [(2000, 1, 8), (2000, 5, 64), (2000, 16, 300)]
#: host-clock readings (median taken) of the landing op with its copies, and of
#: one prefill and one decode step in moe_full_width
HOST_ROUNDS = 3


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


#: seconds from the previous phase line (or the script's start) to each phase's line, printed at the end
PHASE_S: dict[str, float] = {}
_LAST_LINE_AT = [time.perf_counter()]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    if "phase" in obj:
        now = time.perf_counter()
        PHASE_S[obj["phase"]] = PHASE_S.get(obj["phase"], 0.0) + now - _LAST_LINE_AT[0]
        _LAST_LINE_AT[0] = now


def time_interleaved(fns, warmup: int = 3, eager=()):
    """Device ms per call of each function in ``fns`` (name → callable).

    Each function's ``LAUNCHES`` back-to-back calls (``PLAIN_LAUNCHES`` for
    a plain version, named "plain...", and for a call over ``SLOW_MS``) are
    captured once into a CUDA graph; a reading is one replay between a pair
    of CUDA events, divided by the calls, so it holds device time without
    the host's per-call cost (an SDPA call costs the host about as long as
    the card).  A function named in ``eager`` cannot be captured (its
    output shape depends on the data, which needs a sync): a reading of it
    is its calls run back to back between the two events, so it also holds
    whatever host time the card waits for.  Each round takes one reading of
    every function in turn; returns per name the median, min and max of
    ``ROUNDS`` readings."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    last = {name: (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for name in fns}
    with torch.cuda.stream(side):  # warm-up off the default stream, as graph capture wants
        for name, fn in fns.items():
            for i in range(warmup):
                if i == warmup - 1:
                    last[name][0].record()
                fn()
            last[name][1].record()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    calls = {name: PLAIN_LAUNCHES if name.startswith("plain") or start.elapsed_time(end) > SLOW_MS else LAUNCHES
             for name, (start, end) in last.items()}
    graphs = {}
    for name, fn in fns.items():
        if name in eager:
            continue
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(calls[name]):
                fn()
    torch.cuda.synchronize()

    def run_eager(name):
        for _ in range(calls[name]):
            fns[name]()

    readings = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay() if name in graphs else run_eager(name)
            end.record()
            end.synchronize()
            readings[name].append(start.elapsed_time(end) / calls[name])
    return {name: {"median": statistics.median(r), "min": min(r), "max": max(r)}
            for name, r in readings.items()}


def device_breakdown(fn):
    """Device microseconds of one call of ``fn`` (after one warm-up call), by
    kernel, memset or memcpy: ``repro_torch.perf.cost.device_profile``'s
    ``us_by_kernel``, its traced call between two runs of PROFILE_SPINS
    spin kernels, each PROFILE_MARGIN_S of host sleep inside the trace's
    window, taken again at twice the margin where a side's spins were lost
    (see there); the check fails if no trace of PROFILE_TRIES kept them."""
    from repro_torch.perf.cost import device_profile

    try:
        prof = device_profile(fn, wall_rounds=0)
    except RuntimeError as err:
        raise CheckFailed(str(err)) from err
    BREAKDOWN_LEAD_MS.append(prof["lead_ms"])
    BREAKDOWN_RETAKEN.extend(prof["retaken_margins_s"])
    return prof["us_by_kernel"]


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


def phase_device():
    if not torch.cuda.is_available():
        raise CheckFailed("no CUDA device: the port's entry points and kernels need an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
    })
    return smi


def sass_counts(lib_path: str, out_path: Path):
    """Per kernel function of a built library, how many of each of
    ``SASS_OPS`` its SASS holds (``cuobjdump -sass``; the listing is written
    to ``out_path``)."""
    tool = shutil.which("cuobjdump") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300, check=True).stdout
    out_path.write_text(sass)
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                counts[fn][op] += len(re.findall(rf"\b{op}\b", line))
    return counts


def _demangle(name: str) -> str:
    """``kernel<args>`` of a kernel's mangled name (``_ZN`` and length-prefixed
    names: the source's unnamed namespace, then the kernel); the name as it
    is when it is not of that form."""
    i, parts = 3, []
    while name.startswith("_ZN") and i < len(name) and name[i].isdigit():
        n = re.match(r"\d+", name[i:]).group()
        i += len(n)
        parts.append(name[i:i + int(n)])
        i += int(n)
    if not parts:
        return name
    args = []
    if name[i:i + 1] == "I":
        i += 1
        while i < len(name) and name[i] != "E":
            if name[i] == "L":  # a literal: L <type> <value> E
                j = name.find("E", i)
                if j < 0:
                    return name
                args.append(name[i + 2:j])
                i = j + 1
            elif name[i].isdigit():  # a named type
                n = re.match(r"\d+", name[i:]).group()
                i += len(n)
                args.append(name[i:i + int(n)])
                i += int(n)
            else:
                args.append({"f": "float", "d": "double", "i": "int", "j": "unsigned", "x": "long long",
                             "y": "unsigned long long"}.get(name[i], name[i]))
                i += 1
    return f"{parts[-1]}<{', '.join(args)}>" if args else parts[-1]


def _ptxas_by_kernel(log: str):
    """Registers a thread and spill bytes of every kernel in ``nvcc -Xptxas=-v``'s report."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = _demangle(m.group(1))
            out.setdefault(fn, {})
        elif fn is not None and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            out[fn].update(spill_stores=int(st), spill_loads=int(ld))
        elif fn is not None and "registers" in line:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def _dims_label(dqk: int, dv: int) -> str:
    return f"D={dqk}" if dqk == dv else f"D={dqk}/{dv}"


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    info = build.build()
    wall = time.perf_counter() - t0
    (build.BUILD_DIR / "build.log").write_text(
        "\n".join(f"== {name}\n{i['log']}" for name, i in info.items())
    )
    ptxas = {name: _ptxas_by_kernel(str(i["log"])) for name, i in info.items()}
    from repro_torch.kernels import flash_attention as fa

    sass = {}
    # library → (pattern of its tensor-core kernels' mangled names, the instantiations each must have); both
    # directions' templates take the q/k and the v head dim, named "D=<d>" when they are equal
    dims = [_dims_label(*p) for p in fa.FWD_PAIRS if p[0] != 16]  # 16 runs at fa.PAD_D16
    for lib, pattern in (("flash_attention_wgmma", r"(flash_fwd_wgmma)ILi(\d+)ELi(\d+)E"),
                         ("flash_attention_bwd_wgmma", r"(flash_bwd_dkdv_wgmma|flash_bwd_dq_wgmma)ILi(\d+)ELi(\d+)E")):
        per_fn = {}
        for fn, c in sass_counts(info[lib]["path"], build.BUILD_DIR / f"{lib}.sass").items():
            m = re.search(pattern, fn)
            if m:
                per_fn[f"{m.group(1)} {_dims_label(int(m.group(2)), int(m.group(3)))}"] = c
        kernels = sorted({name.split()[0] for name in per_fn})
        check(sorted(per_fn) == sorted(f"{k} {d}" for k in kernels for d in dims) and per_fn,
              f"{lib}: tensor-core instantiations in the SASS: {sorted(per_fn)}")
        for name, c in per_fn.items():
            check(all(c[op] > 0 for op in SASS_OPS), f"{lib} {name} lacks {SASS_OPS} in its SASS: {c}")
        sass[lib] = per_fn
    check(len({n.split()[0] for n in sass["flash_attention_bwd_wgmma"]}) == 2, "the dK/dV and the dQ kernel")
    for lib in ("flash_attention", "flash_attention_wgmma", "flash_attention_bwd", "flash_attention_bwd_wgmma",
                "ssd_scan"):
        spill_lines = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", str(info[lib]["log"]))
        check(spill_lines, f"{lib}: no spill report from ptxas")
        check(all(a == b == "0" for a, b in spill_lines), f"{lib}: a kernel spills: {ptxas[lib]}")
    emit({"phase": "build", "seconds": round(wall, 3),
          "per_kernel_s": {n: round(float(i["seconds"]), 3) for n, i in info.items()},
          "ptxas": ptxas, "sass_flash_attention_wgmma": sass["flash_attention_wgmma"],
          "sass_flash_attention_bwd_wgmma": sass["flash_attention_bwd_wgmma"]})
    return sass


def phase_kernel(smi: str, served_lens):
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa

    fp32_err = 0.0
    for i, (B, S, Hq, Hkv, D) in enumerate(KERNEL_SHAPES):
        q, k, v = (randn(s, torch.float32, 10 * i + j) for j, s in
                   enumerate(((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))))
        for causal in (True, False):
            out = ops.flash_attention(q, k, v, causal=causal)
            want = ops.flash_attention(q, k, v, causal=causal, impl="plain")
            torch.cuda.synchronize()
            fp32_err = max(fp32_err, (out - want).abs().max().item())
            check(torch.allclose(out, want, **FP32_TOL),
                  f"fp32 kernel disagrees with plain at {(B, S, Hq, Hkv, D)} causal={causal}")
    empty_k = torch.empty((1, 0, 2, 32), device="cuda")
    edge = ops.flash_attention(randn((1, 5, 2, 32), torch.float32, 99), empty_k, empty_k, causal=False)
    check(torch.count_nonzero(edge).item() == 0, "rows that see no key must give 0")

    bf16_err = 0.0
    for i, (B, S, Hq, Hkv, _) in enumerate(KERNEL_SHAPES):
        for D in BF16_HEAD_DIMS:
            q, k, v = (randn(s, torch.bfloat16, 50 + 10 * i + j) for j, s in
                       enumerate(((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))))
            for causal in (True, False):
                out = ops.flash_attention(q, k, v, causal=causal)
                want = ops.flash_attention(q, k, v, causal=causal, impl="plain")
                torch.cuda.synchronize()
                bf16_err = max(bf16_err, (out.float() - want.float()).abs().max().item())
                check(torch.allclose(out.float(), want.float(), **BF16_TOL),
                      f"bf16 kernel disagrees with plain at {(B, S, Hq, Hkv, D)} causal={causal}")
    edge = ops.flash_attention(randn((1, 5, 2, 32), torch.bfloat16, 98), empty_k.bfloat16(), empty_k.bfloat16(),
                               causal=False)
    check(torch.count_nonzero(edge).item() == 0, "bf16: rows that see no key must give 0")
    for S in MAIN_SEQS:
        q, k, v = (randn((1, S, 32, 128), torch.bfloat16, 100 + S + j) for j in range(3))
        out = ops.flash_attention(q, k, v, causal=True)
        want = ops.flash_attention(q, k, v, causal=True, impl="plain")
        torch.cuda.synchronize()
        bf16_err = max(bf16_err, (out.float() - want.float()).abs().max().item())
        check(torch.allclose(out.float(), want.float(), **BF16_TOL),
              f"bf16 kernel disagrees with plain at S={S}")

    from repro_torch.perf.hw import chip_for

    chip = chip_for(smi)
    timings = {}
    for S in sorted({*TIMED_SEQS, *served_lens}):
        B, H, D = 1, 32, 128
        q, k, v = (randn((B, S, H, D), torch.bfloat16, 200 + S + j) for j in range(3))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = time_interleaved({
            "kernel": lambda: ops.flash_attention(q, k, v, causal=True),
            "plain": lambda: ops.flash_attention(q, k, v, causal=True, impl="plain"),
            "library": lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
        })
        flops, nbytes = fa.flash_flops(B, S, S, H, D, causal=True), fa.flash_bytes(B, S, S, H, H, D, 2)
        bound_ms, bound_by = _bound(flops, nbytes, smi)
        timings[S] = {
            "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"],
            "library_ms": ms["library"]["median"], "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes,
            "kernel_tflops": flops / (ms["kernel"]["median"] * 1e-3) / 1e12,
            "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()},
        }
    d256 = phase_kernel_d256(smi, served_lens)
    emit({"phase": "kernel", "name": "flash_attention", "fp32_max_abs_err": fp32_err,
          "bf16_max_abs_err": bf16_err, "tolerances": {"fp32": FP32_TOL, "bf16": BF16_TOL},
          "peaks": {"bf16_flops": chip.peak_bf16_flops, "hbm_bytes_s": chip.hbm_bw,
                    "source": f"{chip.name} datasheet (repro_torch.perf.hw)"},
          "routes": {f"{dt}, D={D}": fa.select_route(dt, D) for dt in fa.ROUTES for D in fa.SUPPORTED_HEAD_DIMS},
          "d256": d256,
          "timing": {str(S): t for S, t in timings.items()}, "served_prompt_lens": list(served_lens),
          "timing_note": f"B=1 H=32 D=128 bf16 causal (the wgmma kernel); median of {ROUNDS} readings, "
                         f"each the mean of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) back-to-back calls replayed "
                         "from one CUDA graph between CUDA events; kernel, plain and SDPA alternate; inputs warm in "
                         "L2"})
    fa.flash_attention.launches = 0  # comparisons and timings are not the main path's launches
    return bf16_err, timings, d256


def _bound(flops, nbytes, smi, fp32=False):
    """The least ms the card could take: bytes over the HBM rate or FLOPs
    over the peak of their type (bf16 tensor cores, or fp32 with ``fp32``)."""
    from repro_torch.perf.hw import chip_for

    chip = chip_for(smi)
    peak_flops = chip.peak_fp32_flops if fp32 else chip.peak_bf16_flops
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / chip.hbm_bw * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _lse_train_tol(lse_ref):
    """Each lse's tolerance on training inputs: the larger of LSE_TRAIN_ATOL
    and LSE_TRAIN_SPACINGS of fp32's spacing at its magnitude."""
    _, exp = torch.frexp(lse_ref.abs().nan_to_num(posinf=0.0))
    return torch.clamp(LSE_TRAIN_SPACINGS * torch.ldexp(torch.ones_like(lse_ref), exp - 24), min=LSE_TRAIN_ATOL)


def _grads_close(got, want, zero_atol=0.0, fp32=False):
    """Per gradient: max abs error, the largest entry, and whether it is
    within rtol BWD_RTOL plus BWD_ATOL_OF_MAX of the largest entry (at
    least ``zero_atol``), or with ``fp32`` within BWD_FP32_TOL; a gradient
    with no entries (no query rows, or no keys) need only have its shape."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        scale = w.abs().max().item() if w.numel() else 0.0
        tol = BWD_FP32_TOL if fp32 else dict(rtol=BWD_RTOL, atol=max(BWD_ATOL_OF_MAX * scale, zero_atol))
        out[name] = {"max_abs_err": (g - w).abs().max().item() if w.numel() else 0.0, "max_abs": scale,
                     "ok": g.shape == w.shape and bool(torch.allclose(g, w, **tol))}
    return out


def phase_kernel_d256(smi: str, served_lens):
    """gemma-7b's attention shape (16 heads of 256) at the served prompt
    lengths, bf16, which takes the tensor-core kernel: forward against the
    plain version and timed beside SDPA and the SIMT kernel
    (``route="simt"``); lse against the plain version, and the backward (the
    tensor-core one) on that lse against the plain backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_lse_ref, flash_backward_ref

    H, D = GEMMA_HEADS, GEMMA_HEAD_DIM
    check(fa.select_route(torch.bfloat16, D) == "wgmma", "bf16 at head dim 256 takes the tensor-core kernel")
    check(fa.select_bwd_route(torch.bfloat16, D) == "wgmma", "bf16 at head dim 256 takes the tensor-core backward")
    err, bwd_err, rows = 0.0, {}, {}
    for S in served_lens:
        q, k, v, do = (randn((1, S, H, D), torch.bfloat16, 300 + S + j) for j in range(4))
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        want = ops.flash_attention(q, k, v, causal=True, impl="plain")
        torch.cuda.synchronize()
        err = max(err, (out.float() - want.float()).abs().max().item())
        check(torch.allclose(out.float(), want.float(), **BF16_TOL), f"D=256 bf16 kernel disagrees at S={S}")
        check(torch.allclose(lse, attention_lse_ref(q, k, v, causal=True), **LSE_TOL),
              f"D=256 lse disagrees at S={S}")
        g = _grads_close(fa.flash_attention_backward(q, k, v, out, lse, do, causal=True),
                         flash_backward_ref(q, k, v, out, lse, do, causal=True))
        bwd_err[str(S)] = g
        check(all(r["ok"] for r in g.values()), f"D=256 backward disagrees at S={S}: {g}")
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        simt = fa.flash_attention(q, k, v, causal=True, route="simt")
        check(torch.allclose(simt.float(), want.float(), **BF16_TOL), f"D=256 SIMT kernel disagrees at S={S}")
        ms = time_interleaved({
            "kernel": lambda: ops.flash_attention(q, k, v, causal=True),
            "simt": lambda: fa.flash_attention(q, k, v, causal=True, route="simt"),
            "plain": lambda: ops.flash_attention(q, k, v, causal=True, impl="plain"),
            "library": lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
        })
        bound_ms, bound_by = _bound(fa.flash_flops(1, S, S, H, D, causal=True),
                                    fa.flash_bytes(1, S, S, H, H, D, 2), smi)
        rows[str(S)] = {"kernel_ms": ms["kernel"]["median"], "simt_ms": ms["simt"]["median"],
                        "plain_ms": ms["plain"]["median"],
                        "library_ms": ms["library"]["median"], "bound_ms": bound_ms, "bound_by": bound_by,
                        "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()}}
    return {"shape": f"B=1 Hq=Hkv={H} D={D} bf16 causal (gemma-7b), route wgmma", "max_abs_err": err,
            "backward": bwd_err, "timing": rows}


def _replay(model, scfg, spec, vocab):
    from repro_torch.serve import Engine, generate_load, replay_load

    eng = Engine(model, scfg)
    load = generate_load(spec, vocab)
    rep = replay_load(eng, load)
    return eng, [r for _, r in load], rep


def _lanes(eng, reqs):
    frame = eng.frame
    return {
        r.name: (int(frame.filter(stream=r.stream_id, access_type="SLO", outcome="TOKENS_OUT").sum()),
                 int(frame.filter(stream=r.stream_id, access_type="KV_ACC_W").sum()))
        for r in reqs
    }


def phase_parity():
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Transformer
    from repro_torch.serve import LoadSpec, ServeConfig, TenantSpec

    cfg = get_smoke_config("deepseek-7b")
    cpu_model = Transformer(cfg, device="cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    spec = LoadSpec(tenants=(TenantSpec("solo", rate=0.6, prompt_len=(8, 48), max_new_tokens=(4, 12)),),
                    steps=12, seed=11)
    scfg = ServeConfig(n_slots=4, max_len=128, batch_buckets=(1, 2))
    before = fa.flash_attention.launches
    cpu_eng, cpu_reqs, _ = _replay(cpu_model, scfg, spec, cfg.vocab_size)
    gpu_eng, gpu_reqs, _ = _replay(gpu_model, scfg, spec, cfg.vocab_size)
    gpu_launches = fa.flash_attention.launches - before
    check(gpu_launches == cfg.n_layers * len(gpu_reqs), "every card prefill runs the kernel once per layer")
    check([r.status for r in gpu_reqs] == [r.status for r in cpu_reqs], "request statuses differ")
    check([r.generated for r in gpu_reqs] == [r.generated for r in cpu_reqs],
          "greedy tokens differ between card and CPU")
    check(_lanes(gpu_eng, gpu_reqs) == _lanes(cpu_eng, cpu_reqs), "per-stream TOKENS_OUT/KV_ACC_W differ")
    check(gpu_eng.fault_summary() == cpu_eng.fault_summary(), "fault_summary differs")
    tokens = torch.as_tensor(cpu_reqs[0].prompt, dtype=torch.long)[None]
    cpu_logits, _ = cpu_model.prefill(tokens)
    gpu_logits, _ = gpu_model.prefill(tokens.cuda())
    err = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    check(err <= SMOKE_LOGITS_ATOL, f"smoke logits card vs CPU differ by {err}")
    fa.flash_attention.launches = before
    emit({"phase": "parity", "config": "deepseek-7b SMOKE", "requests": len(gpu_reqs),
          "tokens_out": sum(len(r.generated) for r in gpu_reqs),
          "statuses": {s: sum(r.status == s for r in gpu_reqs) for s in {r.status for r in gpu_reqs}},
          "lanes_equal": True, "fault_summary": gpu_eng.fault_summary(),
          "logits_max_abs_err": err, "logits_atol": SMOKE_LOGITS_ATOL,
          "card_kernel_launches": gpu_launches})


def _full_width_load(vocab: int):
    """The serving trace phase_full_width replays: two tenants, 10 requests."""
    from repro_torch.serve import LoadSpec, TenantSpec, generate_load

    spec = LoadSpec(
        tenants=(TenantSpec("interactive", rate=0.5, prompt_len=(128, 512), max_new_tokens=(16, 32), priority=1),
                 TenantSpec("batch", rate=0.4, prompt_len=(128, 512), max_new_tokens=(16, 32))),
        steps=12, seed=1,
    )
    return generate_load(spec, vocab)


def served_prompt_lens():
    """The shortest and longest prompt of the full-width trace."""
    from repro_torch.configs import get_config

    lens = [len(r.prompt) for _, r in _full_width_load(get_config("deepseek-7b").vocab_size)]
    return min(lens), max(lens)


def phase_full_width():
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer
    from repro_torch.serve import Engine, ServeConfig, replay_load

    cfg = get_config("deepseek-7b")
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    eng = Engine(model, ServeConfig(n_slots=4, max_len=1024, batch_buckets=(1, 2)))
    load = _full_width_load(cfg.vocab_size)
    check(8 <= len(load) <= 12, f"trace has {len(load)} requests, want 8-12")

    # warm-up outside the measured run: cuBLAS handles, allocator, the kernel library
    warm = torch.randint(0, cfg.vocab_size, (1, 64), device="cuda")
    model.prefill(warm)
    scratch = model.init_cache(1, 80)
    model.decode_step(scratch, warm[:, 0], torch.zeros(1, dtype=torch.long, device="cuda"))
    del scratch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.flash_attention.launches = 0
    rep = replay_load(eng, load)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches

    reqs = [r for _, r in load]
    check(all(r.status == "done" for r in reqs), f"statuses {[r.status for r in reqs]}")
    kvb = eng._kv_bytes_per_token
    check(kvb == 2 * cfg.n_kv_heads * cfg.resolved_head_dim * cfg.n_layers * 2, "kv bytes per token")
    lanes = _lanes(eng, reqs)
    for r in reqs:
        tok_out, kv = lanes[r.name]
        check(tok_out == len(r.generated), f"{r.name}: TOKENS_OUT {tok_out} != {len(r.generated)}")
        want_kv = (len(r.prompt) + len(r.generated) - 1) * kvb
        check(kv == want_kv, f"{r.name}: KV_ACC_W {kv} != {want_kv}")
        check(len(r.generated) == r.max_new_tokens, f"{r.name}: {len(r.generated)} tokens")
    check(launches == cfg.n_layers * len(reqs), f"flash launches {launches} != 30 x {len(reqs)} prefills")

    prompt_tokens = sum(len(r.prompt) for r in reqs)
    prefill_s = sum(r.prefill_s for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    decode_s = sum(r.decode_s for r in reqs)
    ttft_ms = sorted(r.ttft_s * 1e3 for r in reqs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one real prompt: keep the q/k/v every layer hands to the attention op,
    # then hold the kernel against the plain version on each layer's inputs
    probe = torch.as_tensor(reqs[0].prompt, dtype=torch.long, device="cuda")[None]
    V = cfg.vocab_size
    flash, captured = ops.flash_attention, []

    def capture(q, k, v, **kw):
        captured.append((q, k, v, kw))
        return flash(q, k, v, **kw)

    ops.flash_attention = capture
    try:
        k_logits = model.prefill(probe)[0][..., :V]
    finally:
        ops.flash_attention = flash
    check(len(captured) == cfg.n_layers, f"{len(captured)} attention calls in one prefill")
    op_err, op_scale = 0.0, 0.0
    for layer, (q, k, v, kw) in enumerate(captured):
        out = flash(q, k, v, **kw).float()
        want = flash(q, k, v, **{**kw, "impl": "plain"}).float()
        op_err = max(op_err, (out - want).abs().max().item())
        op_scale = max(op_scale, want.abs().max().item())
        check(torch.allclose(out, want, **BF16_TOL),
              f"bf16 kernel disagrees with plain on layer {layer}'s prefill attention inputs")
    del captured, out, want
    p_logits = model.prefill(probe, attn_impl="plain")[0][..., :V]
    check(bool(torch.isfinite(k_logits).all()), "non-finite logits")
    del eng
    model.to(torch.float32)  # the same weights, exactly, as the fp32 model both bf16 paths round
    model.cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    f_kernel = model.prefill(probe)[0][..., :V]
    f_plain = model.prefill(probe, attn_impl="plain")[0][..., :V]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    logits = {
        "bf16_kernel_vs_plain": rel(k_logits, p_logits),
        "bf16_plain_vs_fp32": rel(p_logits, f_plain),
        "bf16_kernel_vs_fp32": rel(k_logits, f_plain),
        "fp32_kernel_vs_plain": rel(f_kernel, f_plain),
        "bf16_kernel_vs_plain_max_abs": (k_logits - p_logits).abs().max().item(),
        "scale_max_abs": p_logits.abs().max().item(),
        "argmax_equal_bf16": bool(k_logits.argmax() == p_logits.argmax()),
        "argmax_equal_fp32": bool(f_kernel.argmax() == f_plain.argmax()),
    }
    check(logits["fp32_kernel_vs_plain"] <= FULL_FP32_REL, f"fp32 logits kernel vs plain: {logits}")
    emit({
        "phase": "full_width", "config": "deepseek-7b", "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.param_dtype,
        "params": n_params, "init_s": init_s, "requests": len(reqs), "engine_steps": rep.steps,
        "statuses": {s: sum(r.status == s for r in reqs) for s in {r.status for r in reqs}},
        "flash_launches": launches, "prefills": len(reqs),
        "prompt_tokens": prompt_tokens, "prefill_tok_s": prompt_tokens / prefill_s,
        "decode_tokens": decode_tokens, "decode_tok_s": decode_tokens / decode_s,
        "ttft_p50_ms": statistics.median(ttft_ms), "ttft_max_ms": ttft_ms[-1],
        "wall_s": rep.wall_s, "goodput_tok_s": rep.total_goodput_tok_s,
        "per_tenant_ttft_p50_us": {t: row["ttft_us"]["p50"] for t, row in rep.per_tenant.items()},
        "max_memory_allocated_gb": peak_gb,
        "attention_op_bf16": {"layers": cfg.n_layers, "prompt_len": probe.shape[1],
                              "max_abs_err": op_err, "max_abs_out": op_scale, "tolerance": BF16_TOL},
        "logits_rel_l2": logits, "logits_tolerance": {"fp32_kernel_vs_plain": FULL_FP32_REL},
    })
    return launches, op_err


def phase_mla_kernel(smi: str, served_lens, sass):
    """MLA's prefill attention at deepseek-v2's widths, (q/k 192, v 128) over
    16 heads: both routes against the plain version (bf16 on the tensor-core
    kernel, fp32 on the SIMT one) at MAIN_SEQS and the served lengths,
    causal, and on a non-causal call, a B = 2 ragged call and GQA 16 over 4;
    the bf16 kernel timed at MLA_TIMED beside the plain version, SDPA at the
    same widths and the bound, the fp32 one at the longest served prompt."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    H, DQK, DV = MLA_HEADS, MLA_DQK, MLA_DV
    scale = DQK ** -0.5
    routes = {str(dt): fa.select_route(dt, DQK, DV) for dt in (torch.bfloat16, torch.float32)}
    check(routes == {"torch.bfloat16": "wgmma", "torch.float32": "simt"}, f"(192, 128) routes {routes}")

    def qkv(B, S, Hq, Hkv, dtype, seed, Sk=None):
        Sk = S if Sk is None else Sk
        return (randn((B, S, Hq, DQK), dtype, seed), randn((B, Sk, Hkv, DQK), dtype, seed + 1),
                randn((B, Sk, Hkv, DV), dtype, seed + 2))

    # (B, Sq, Hq, Hkv, causal, Sk)
    cases = [(1, S, H, H, True, S) for S in sorted({*MAIN_SEQS, *served_lens})]
    cases += [(1, 404, H, H, False, 404), (2, 333, H, H, True, 333), (1, 404, H, 4, True, 404),
              (2, 77, H, 4, False, 150)]
    err = {}
    for i, (B, S, Hq, Hkv, causal, Sk) in enumerate(cases):
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            q, k, v = qkv(B, S, Hq, Hkv, dtype, 700 + 3 * i, Sk)
            out = ops.flash_attention(q, k, v, causal=causal, scale=scale)
            want = ops.flash_attention(q, k, v, causal=causal, scale=scale, impl="plain")
            torch.cuda.synchronize()
            check(out.shape == (B, S, Hq, DV), f"(192, 128) output shape {tuple(out.shape)}")
            e = (out.float() - want.float()).abs().max().item()
            err[str(dtype)] = max(err.get(str(dtype), 0.0), e)
            check(torch.allclose(out.float(), want.float(), **tol),
                  f"(192, 128) {dtype} kernel disagrees with plain at B={B} S={S} Sk={Sk} Hq={Hq} Hkv={Hkv} "
                  f"causal={causal}: {e}")

    rows = {}
    for S in sorted({*MLA_TIMED, *served_lens}):
        q, k, v = qkv(1, S, H, H, torch.bfloat16, 800 + S)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=scale)
        ms = time_interleaved({
            "kernel": lambda: ops.flash_attention(q, k, v, causal=True, scale=scale),
            "plain": lambda: ops.flash_attention(q, k, v, causal=True, scale=scale, impl="plain"),
            "library": sdpa,
        })
        flops = fa.flash_flops(1, S, S, H, DQK, causal=True, v_head_dim=DV)
        nbytes = fa.flash_bytes(1, S, S, H, H, DQK, 2, v_head_dim=DV)
        bound_ms, bound_by = _bound(flops, nbytes, smi)
        rows[str(S)] = {"kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"],
                        "library_ms": ms["library"]["median"], "bound_ms": bound_ms, "bound_by": bound_by,
                        "flops": flops, "bytes": nbytes,
                        "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()}}
    # which SDPA backend takes Dv != Dqk: the kernels it launches
    sdpa_kernels = sorted(device_breakdown(sdpa))

    S = max(served_lens)
    q, k, v = qkv(1, S, H, H, torch.float32, 900)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = time_interleaved({
        "kernel": lambda: ops.flash_attention(q, k, v, causal=True, scale=scale),
        "plain": lambda: ops.flash_attention(q, k, v, causal=True, scale=scale, impl="plain"),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=scale),
    })
    bound_ms, bound_by = _bound(fa.flash_flops(1, S, S, H, DQK, causal=True, v_head_dim=DV),
                                fa.flash_bytes(1, S, S, H, H, DQK, 4, v_head_dim=DV), smi, fp32=True)
    fp32_row = {"shape": f"B=1 S={S} Hq=Hkv={H} Dqk={DQK} Dv={DV} fp32 causal, route simt",
                "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"],
                "library_ms": ms["library"]["median"], "bound_ms": bound_ms, "bound_by": bound_by}
    line = {"phase": "mla_kernel", "shape": f"B=1 Hq=Hkv={H} Dqk={DQK} Dv={DV} bf16 causal, scale {DQK}^-0.5, "
                                            "route wgmma", "routes": routes, "max_abs_err": err,
            "tolerances": {"bfloat16": BF16_TOL, "float32": FP32_TOL}, "checked": len(cases),
            "sass": sass, "timing": rows, "sdpa_kernels": sdpa_kernels, "fp32": fp32_row,
            "timing_note": f"median of {ROUNDS} readings, each the mean of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) "
                           "back-to-back calls replayed from one CUDA graph; kernel, plain and SDPA alternate; "
                           "inputs warm in L2"}
    emit(line)
    fa.flash_attention.launches = 0
    return line


class _RouterTrace:
    """Every router call of one engine run over the requests ``reqs``: each
    token's experts, the smallest gap between its top-(k+1) router
    probabilities (from the router's own top-k, asked for one more), and the
    request and token index its row works for (None for a decode bucket's
    empty rows).  Installed over ``moe.router_topk`` alone; the owners come
    from the engine's public state: a prefill's rows belong to the one
    submitted request that has left the queue with no token yet, a decode
    step's row i to the request in slot i."""

    def __init__(self, eng, reqs):
        from repro_torch.models import moe as moe_mod

        self.calls, self._eng, self._reqs, self._mod = [], eng, reqs, moe_mod
        self._real = moe_mod.router_topk

    def _owners(self, rows: int):
        eng = self._eng
        prefilling = [r for r in self._reqs if r.stream_id >= 0 and not r.generated
                      and all(r is not q for q in eng.queue)]
        check(len(prefilling) <= 1, f"{len(prefilling)} requests between the queue and their first token")
        if prefilling:
            req = prefilling[0]
            owners = [(req.name, 0)] * len(req.prompt)
        else:
            owners = [(r.name, len(r.generated)) if r is not None else None for r in eng.slots[:rows]]
        check(rows == len(owners), f"{rows} router rows, {len(owners)} rows the engine runs")
        return owners

    def __enter__(self):
        def traced(params, x, moe):
            w, idx, aux = self._real(params, x, moe)
            more = dataclasses.replace(moe, top_k=min(moe.top_k + 1, moe.n_experts), router_scale=False)
            top = self._real(params, x, more)[0].float()
            gap = (top[..., :-1] - top[..., 1:]).min(-1).values
            self.calls.append((idx.cpu(), gap.cpu(), self._owners(idx.shape[0])))
            return w, idx, aux

        self._mod.router_topk = traced
        return self

    def __exit__(self, *exc):
        self._mod.router_topk = self._real


def _ties(cpu_calls, gpu_calls):
    """Compare the two runs' experts call by call.  A token whose experts
    differ must be a tie (its top-(k+1) probabilities within TIE_EPS on both
    devices); from there on its request's routing is not compared.  Returns
    each such request's first tied token index and the ties."""
    check(len(cpu_calls) == len(gpu_calls), f"{len(cpu_calls)} router calls on the CPU, {len(gpu_calls)} on the card")
    first, ties = {}, []
    for n, ((ci, cgap, owners), (gi, ggap, gowners)) in enumerate(zip(cpu_calls, gpu_calls)):
        check(owners == gowners, "the two engines ran different schedules")
        for t, owner in enumerate(owners):
            if owner is None or owner[0] in first or torch.equal(ci[t], gi[t]):
                continue
            margin = max(cgap[t].item(), ggap[t].item())
            check(margin < TIE_EPS, f"router call {n}, {owner}: experts {ci[t].tolist()} on the CPU and "
                                    f"{gi[t].tolist()} on the card with a top-k margin of {margin}")
            first[owner[0]] = owner[1]
            ties.append({"call": n, "request": owner[0], "token": owner[1], "margin": margin,
                         "cpu": ci[t].tolist(), "card": gi[t].tolist()})
    return first, ties


def _serving_parity(configs):
    """Each config served on the CPU and on the card, fp32 with TF32 off, the
    same weights on both devices, through the engine on one two-tenant
    trace.  Experts are compared first, then greedy tokens up to each
    request's first tie; statuses, TOKENS_OUT, KV_ACC_W and fault_summary()
    in full; every card prefill runs the flash kernel once per attention
    layer and the SSD kernel once per SSM layer."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.models import Transformer
    from repro_torch.serve import Engine, LoadSpec, ServeConfig, TenantSpec, generate_load, replay_load

    spec = LoadSpec(tenants=(TenantSpec("online", rate=0.6, prompt_len=(8, 48), max_new_tokens=(4, 12), priority=1),
                             TenantSpec("batch", rate=0.5, prompt_len=(8, 48), max_new_tokens=(4, 12))),
                    steps=12, seed=13)
    scfg = ServeConfig(n_slots=4, max_len=128, batch_buckets=(1, 2))
    out = {}
    for name, cfg in configs.items():
        cpu_model = Transformer(cfg, device="cpu", seed=0)
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        runs = {}
        for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            eng = Engine(model, scfg)
            load = generate_load(spec, cfg.vocab_size)
            before = fa.flash_attention.launches, sk.ssd_scan.launches
            reqs = [r for _, r in load]
            with _RouterTrace(eng, reqs) as trace:
                replay_load(eng, load)
            runs[dev] = (eng, reqs, trace.calls,
                         (fa.flash_attention.launches - before[0], sk.ssd_scan.launches - before[1]))
        (cpu_eng, cpu_reqs, cpu_calls, _), (gpu_eng, gpu_reqs, gpu_calls, (launches, ssd_launches)) = \
            runs["cpu"], runs["cuda"]
        n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
        check(launches == n_attn * len(gpu_reqs), f"{name}: {launches} card flash launches")
        check(ssd_launches == (cfg.n_layers - n_attn) * len(gpu_reqs), f"{name}: {ssd_launches} card SSD launches")
        first, ties = _ties(cpu_calls, gpu_calls)
        check([r.status for r in gpu_reqs] == [r.status for r in cpu_reqs], f"{name}: request statuses differ")
        for c, g in zip(cpu_reqs, gpu_reqs):
            upto = first.get(c.name, len(c.generated))
            check(g.generated[:upto] == c.generated[:upto] and len(g.generated) == len(c.generated),
                  f"{name}: {c.name}'s greedy tokens differ before its first tie ({upto}): {c.generated} vs "
                  f"{g.generated}")
        check(_lanes(gpu_eng, gpu_reqs) == _lanes(cpu_eng, cpu_reqs), f"{name}: TOKENS_OUT/KV_ACC_W differ")
        check(gpu_eng.fault_summary() == cpu_eng.fault_summary(), f"{name}: fault_summary differs")
        out[name] = {"requests": len(gpu_reqs), "tokens_out": sum(len(r.generated) for r in gpu_reqs),
                     "router_calls": len(gpu_calls), "routed_tokens": sum(len(c[2]) for c in gpu_calls),
                     "ties": ties, "tokens_compared": sum(first.get(r.name, len(r.generated)) for r in cpu_reqs),
                     "card_kernel_launches": launches, "fault_summary": gpu_eng.fault_summary()}
        if ssd_launches:
            out[name]["card_ssd_launches"] = ssd_launches
        del cpu_model, gpu_model, runs
    fa.flash_attention.launches = 0
    sk.ssd_scan.launches = 0
    return out


def phase_moe_parity():
    """MoE serving, card against CPU (``_serving_parity``): llama4-scout's
    smoke config (GQA, 4 experts top-1 and a shared one; the fp32 flash
    kernel at head dim 32) and deepseek-v2-lite's at deepseek-v2's published
    MLA head dims (q/k 192, v 128, on the fp32 (192, 128) kernel; 8 experts
    top-2 and a shared one after a dense first layer)."""
    from repro_torch.configs import MLAConfig, get_smoke_config

    published = MLAConfig(kv_lora_rank=32, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)
    configs = {"llama4-scout-17b-a16e SMOKE": get_smoke_config("llama4-scout-17b-a16e"),
               "deepseek-v2-lite-16b SMOKE at the published MLA head dims":
                   dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"), mla=published)}
    emit({"phase": "moe_parity", "dtype": "float32, TF32 off", "tie_eps": TIE_EPS,
          "configs": _serving_parity(configs), "lanes_equal": True, "statuses_equal": True})


def phase_hybrid_parity():
    """Hybrid serving, card against CPU (``_serving_parity``, the engine
    settings and trace of moe_parity): jamba's smoke config, one 8-layer
    superblock of Mamba-2 layers (head dim 32, on the fp32 SIMT SSD kernel)
    and one attention layer (4 heads of 32 over 2, the fp32 flash kernel),
    4 experts top-2 every second layer, its caches one stack per kind."""
    from repro_torch.configs import get_smoke_config

    configs = {"jamba-1.5-large-398b SMOKE": get_smoke_config("jamba-1.5-large-398b")}
    emit({"phase": "hybrid_parity", "dtype": "float32, TF32 off", "tie_eps": TIE_EPS,
          "configs": _serving_parity(configs), "lanes_equal": True, "statuses_equal": True})


def _wall_and_busy(fn):
    """One call of ``fn``: its median wall ms over HOST_ROUNDS (host clock to
    synchronize, no profiler), its device time by operation
    (``device_breakdown``) and the device's idle share of the wall time."""
    walls = []
    for _ in range(HOST_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    by_op = device_breakdown(fn)
    wall = statistics.median(walls)
    busy = sum(by_op.values()) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall),
            "device_ops": len(by_op)}, by_op


def _device_shares(model, probe):
    """``_wall_and_busy`` of one prefill of ``probe`` and of one decode step
    of a full batch of four (at positions 400, 300, 200 and 132 of a
    1024-long cache), after checking that the decode step waits on the host
    nowhere: no op in it synchronises.  Returns both and the syncs seen."""
    prefill = _wall_and_busy(lambda: model.prefill(probe))
    cache = model.init_cache(4, 1024)
    tok = torch.randint(0, model.cfg.vocab_size, (4,), device="cuda")
    pos = torch.tensor([400, 300, 200, 132], device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.decode_step(cache, tok, pos)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:160] for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    check(not syncs, f"a decode step synchronised with the host: {syncs}")
    return prefill, _wall_and_busy(lambda: model.decode_step(cache, tok, pos)), syncs


def phase_moe_full_width(smi: str):
    """deepseek-v2-lite at its published size, uncut (27 layers, d_model 2048,
    16 heads of MLA with a 512-wide latent, 64 experts top-6 of 1408 and 2
    shared after a dense first layer of 10944, vocab 102400; bf16, random
    weights from seed 0 with the reference's init recipe), served through the
    continuous-batching engine on _full_width_load's two-tenant trace: the
    lanes, every prefill's attention on the (192, 128) tensor-core kernel,
    the kernel against the plain version on every layer's real q, k and v,
    and the sparse MoE layer against the all-experts path on one layer's
    real hidden states."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer
    from repro_torch.models import transformer as tmod
    from repro_torch.models.moe import moe_apply, moe_apply_dense
    from repro_torch.serve import Engine, ServeConfig, replay_load

    t_phase = time.perf_counter()
    cfg = get_config("deepseek-v2-lite-16b")
    m = cfg.mla
    check(cfg.n_layers == 27 and cfg.d_model == 2048 and (m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim) == (192, 128),
          "deepseek-v2-lite's published config")
    check(fa.select_route(cfg.compute_tdtype(), MLA_DQK, MLA_DV) == "wgmma", "bf16 MLA takes the tensor-core kernel")
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == MOE_FULL_PARAMS, f"{n_params} parameters, want {MOE_FULL_PARAMS}")
    eng = Engine(model, ServeConfig(n_slots=4, max_len=1024, batch_buckets=(1, 2)))
    load = _full_width_load(cfg.vocab_size)
    check(len(load) == 10, f"trace has {len(load)} requests, want 10")

    warm = torch.randint(0, cfg.vocab_size, (1, 64), device="cuda")
    model.prefill(warm)
    scratch = model.init_cache(1, 80)
    model.decode_step(scratch, warm[:, 0], torch.zeros(1, dtype=torch.long, device="cuda"))
    del scratch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.flash_attention.launches = 0
    rep = replay_load(eng, load)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches

    reqs = [r for _, r in load]
    check(all(r.status == "done" for r in reqs), f"statuses {[r.status for r in reqs]}")
    kvb = eng._kv_bytes_per_token
    check(kvb == (m.kv_lora_rank + m.qk_rope_dim) * cfg.n_layers * 2, f"kv bytes per token {kvb}")
    lanes = _lanes(eng, reqs)
    for r in reqs:
        tok_out, kv = lanes[r.name]
        check(tok_out == len(r.generated) == r.max_new_tokens, f"{r.name}: TOKENS_OUT {tok_out}, {len(r.generated)}")
        check(kv == (len(r.prompt) + len(r.generated) - 1) * kvb, f"{r.name}: KV_ACC_W {kv}")
    check(launches == cfg.n_layers * len(reqs), f"flash launches {launches} != {cfg.n_layers} x {len(reqs)} prefills")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    prefill_s = sum(r.prefill_s for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    decode_s = sum(r.decode_s for r in reqs)
    ttft_ms = sorted(r.ttft_s * 1e3 for r in reqs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one real prompt: every layer's attention inputs and every MoE layer's hidden states
    probe = torch.as_tensor(reqs[0].prompt, dtype=torch.long, device="cuda")[None]
    flash, real_moe, captured, moe_in = ops.flash_attention, tmod.moe_apply, [], []

    def capture(q, k, v, **kw):
        captured.append((q, k, v, kw))
        return flash(q, k, v, **kw)

    def capture_moe(params, x, *args, **kw):
        moe_in.append((params, x))
        return real_moe(params, x, *args, **kw)

    ops.flash_attention, tmod.moe_apply = capture, capture_moe
    try:
        logits = model.prefill(probe)[0][..., :cfg.vocab_size]
    finally:
        ops.flash_attention, tmod.moe_apply = flash, real_moe
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(len(captured) == cfg.n_layers, f"{len(captured)} attention calls in one prefill")
    op_err, op_scale = 0.0, 0.0
    for layer, (q, k, v, kw) in enumerate(captured):
        check(q.dtype == torch.bfloat16 and (q.shape[-1], v.shape[-1]) == (MLA_DQK, MLA_DV),
              f"layer {layer}: attention at {q.dtype}, ({q.shape[-1]}, {v.shape[-1]})")
        out = flash(q, k, v, **kw).float()
        want = flash(q, k, v, **{**kw, "impl": "plain"}).float()
        op_err = max(op_err, (out - want).abs().max().item())
        op_scale = max(op_scale, want.abs().max().item())
        check(torch.allclose(out, want, **BF16_TOL), f"(192, 128) kernel disagrees with plain on layer {layer}")
    check(len(moe_in) == cfg.n_layers - cfg.moe.first_k_dense, f"{len(moe_in)} MoE calls in one prefill")
    layer = len(moe_in) // 2
    params, h = moe_in[layer]
    up = lambda t: {**{n: p.float() for n, p in t._parameters.items()}, **{n: up(c) for n, c in t._modules.items()}}
    ps, x = up(params), h.float()
    sparse = moe_apply(ps, x, cfg, cfg.moe, capacity_factor=float(cfg.moe.n_experts))[0]
    dense = moe_apply_dense(ps, x, cfg, cfg.moe)[0]
    err = (sparse - dense).abs()
    moe_check = {"moe_layer": layer, "capacity_factor": cfg.moe.n_experts, "dtype": "float32",
                 "max_abs_err": err.max().item(), "max_abs_out": dense.abs().max().item(), "tolerance": FP32_TOL,
                 "worst_err_over_tol": (err / (FP32_TOL["atol"] + FP32_TOL["rtol"] * dense.abs())).max().item()}
    check(torch.allclose(sparse, dense, **FP32_TOL),
          f"sparse MoE disagrees with the all-experts path on MoE layer {layer}: {moe_check}")
    del captured, moe_in, out, want, sparse, dense, err, params, h, ps, x

    # the device's share of one prefill (the probe) and of one decode step of the full batch
    (prefill_busy, _), (decode_busy, decode_ops), syncs = _device_shares(model, probe)
    top = dict(sorted(decode_ops.items(), key=lambda kv: -kv[1])[:TOP_OPS])
    del eng, model
    torch.cuda.empty_cache()
    line = {
        "phase": "moe_full_width", "config": "deepseek-v2-lite-16b", "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "mla": dataclasses.asdict(m),
        "moe": dataclasses.asdict(cfg.moe), "d_ff_dense": cfg.d_ff, "vocab": cfg.vocab_size,
        "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s, "requests": len(reqs),
        "engine_steps": rep.steps, "flash_launches": launches, "flash_route": "wgmma (192, 128)",
        "prompt_tokens": prompt_tokens, "prefill_tok_s": prompt_tokens / prefill_s,
        "decode_tokens": decode_tokens, "decode_tok_s": decode_tokens / decode_s,
        "ttft_p50_ms": statistics.median(ttft_ms), "ttft_max_ms": ttft_ms[-1], "wall_s": rep.wall_s,
        "max_memory_allocated_gb": peak_gb, "kv_bytes_per_token": kvb,
        "attention_op_bf16": {"layers": cfg.n_layers, "prompt_len": probe.shape[1], "max_abs_err": op_err,
                              "max_abs_out": op_scale, "tolerance": BF16_TOL},
        "moe_sparse_vs_dense": moe_check,
        "prefill_device": {"prompt_len": probe.shape[1], **prefill_busy},
        "decode_step_device": {"batch": 4, "host_syncs": len(syncs), **decode_busy}, "decode_step_top_ops_us": top,
        "phase_wall_s": time.perf_counter() - t_phase,
    }
    emit(line)
    fa.flash_attention.launches = 0
    return line


def phase_hybrid_full_width(smi: str):
    """jamba-1.5-large at its published widths (d_model 8192; 64 heads of 128
    over 8 kv heads, no rope; Mamba-2 layers of 128 heads of 128, d_state
    128; 16 experts top-2 of 24,576 every second layer, dense FFN of 24,576
    elsewhere; vocab 65,536; bf16, random weights from seed 0) cut to
    HYBRID_LAYERS layers, served through the continuous-batching engine on
    the full-width trace: the lanes, every prefill's SSD on the bf16
    tensor-core kernel at P = 128 and its attention on the flash kernel at D
    = 128, the SSD kernel held against the sequential plain scan on every
    SSM layer's real inputs and the flash kernel against the plain version
    on the attention layer's, no host sync in a decode step, and the
    device's idle share of a prefill and a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.models import Transformer
    from repro_torch.serve import Engine, ServeConfig, replay_load

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), n_layers=HYBRID_LAYERS)
    s = cfg.ssm
    H, P, N, G = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.n_groups
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, H, P, N, G, cfg.moe.n_experts,
           cfg.moe.expert_d_ff, cfg.vocab_size) == (8192, 64, 8, 128, *JAMBA_SSD_WIDTH, 16, 24576, 65536),
          "jamba's published widths")
    kinds = ["attn" if cfg.layer_is_attn(i) else "ssm" for i in range(cfg.n_layers)]
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    check(cfg.superblock_period == HYBRID_LAYERS and (n_attn, n_ssm) == (1, 6)
          and [cfg.layer_is_moe(i) for i in range(cfg.n_layers)] == [False, True] * 3 + [False],
          f"the cut: {kinds}, period {cfg.superblock_period}")
    check(sk.select_route(cfg.compute_tdtype()) == "wgmma" and fa.select_route(cfg.compute_tdtype(), 128, 128)
          == "wgmma", "bf16 SSD and attention take the tensor-core kernels")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == HYBRID_PARAMS, f"{n_params} parameters, want {HYBRID_PARAMS}")
    eng = Engine(model, ServeConfig(n_slots=4, max_len=1024, batch_buckets=(1, 2)))
    load = _full_width_load(TRACE_VOCAB)
    for _, r in load:
        r.prompt = np.asarray(r.prompt) % cfg.vocab_size
    check(len(load) == 10, f"trace has {len(load)} requests, want 10")

    warm = torch.randint(0, cfg.vocab_size, (1, 64), device="cuda")
    model.prefill(warm)
    scratch = model.init_cache(1, 80)
    model.decode_step(scratch, warm[:, 0], torch.zeros(1, dtype=torch.long, device="cuda"))
    del scratch
    torch.cuda.synchronize()

    # every SSD and attention call the engine makes, by dtype and width
    ssd_op, flash_op, calls = ops.ssd_scan, ops.flash_attention, {"ssd": [], "flash": []}

    def rec_ssd(x, *args, **kw):
        calls["ssd"].append((x.device.type, x.dtype, x.shape[-1], args[3].shape[-1]))
        return ssd_op(x, *args, **kw)

    def rec_flash(q, k, v, **kw):
        calls["flash"].append((q.device.type, q.dtype, q.shape[-1], v.shape[-1], kw.get("impl", "auto")))
        return flash_op(q, k, v, **kw)

    fa.flash_attention.launches = 0
    sk.ssd_scan.launches = 0
    ops.ssd_scan, ops.flash_attention = rec_ssd, rec_flash
    try:
        rep = replay_load(eng, load)
    finally:
        ops.ssd_scan, ops.flash_attention = ssd_op, flash_op
    torch.cuda.synchronize()
    flash_launches, ssd_launches = fa.flash_attention.launches, sk.ssd_scan.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    reqs = [r for _, r in load]
    check(all(r.status == "done" for r in reqs), f"statuses {[r.status for r in reqs]}")
    kvb = eng._kv_bytes_per_token
    check(kvb == 2 * cfg.n_kv_heads * cfg.resolved_head_dim * n_attn * 2, f"kv bytes per token {kvb}")
    lanes = _lanes(eng, reqs)
    for r in reqs:
        tok_out, kv = lanes[r.name]
        check(tok_out == len(r.generated) == r.max_new_tokens, f"{r.name}: TOKENS_OUT {tok_out}, {len(r.generated)}")
        check(kv == (len(r.prompt) + len(r.generated) - 1) * kvb, f"{r.name}: KV_ACC_W {kv}")
    check(ssd_launches == n_ssm * len(reqs) == len(calls["ssd"]),
          f"SSD launches {ssd_launches}, calls {len(calls['ssd'])}, want {n_ssm} x {len(reqs)} prefills")
    check(set(calls["ssd"]) == {("cuda", torch.bfloat16, P, N)} and "ssd_scan_wgmma" in build._LOADED,
          f"SSD calls {set(calls['ssd'])}: every prefill's SSD on the bf16 tensor-core kernel at P = {P}")
    check(flash_launches == n_attn * len(reqs) == len(calls["flash"])
          and set(calls["flash"]) == {("cuda", torch.bfloat16, 128, 128, "auto")},
          f"flash launches {flash_launches}, calls {set(calls['flash'])}")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    prefill_s = sum(r.prefill_s for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    decode_s = sum(r.decode_s for r in reqs)
    ttft_ms = sorted(r.ttft_s * 1e3 for r in reqs)

    # one real prompt: every SSM layer's SSD inputs and the attention layer's q, k, v
    probe = torch.as_tensor(reqs[0].prompt, dtype=torch.long, device="cuda")[None]
    ssd_in, attn_in = [], []

    def capture_ssd(*args, **kw):
        ssd_in.append((args, kw))
        return ssd_op(*args, **kw)

    def capture_flash(q, k, v, **kw):
        attn_in.append((q, k, v, kw))
        return flash_op(q, k, v, **kw)

    ops.ssd_scan, ops.flash_attention = capture_ssd, capture_flash
    try:
        logits = model.prefill(probe)[0][..., :cfg.vocab_size]
    finally:
        ops.ssd_scan, ops.flash_attention = ssd_op, flash_op
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(len(ssd_in) == n_ssm and len(attn_in) == n_attn, f"{len(ssd_in)} SSD, {len(attn_in)} attention calls")
    ssd_rows = []
    for args, kw in ssd_in:
        with torch.no_grad():
            y, h = ssd_op(*args, **kw)
            sy, sh = ssd_ref(*args, h0=kw.get("h0"), return_state=True)
            dy, _ = ssd_ref(*[a.double() if torch.is_tensor(a) else a for a in args], return_state=True)
        outside = ~torch.isclose(y.float(), sy.float(), **SSD_BF16_TOL)
        worst = int(((y.double() - sy.double()).abs() - SSD_BF16_TOL["rtol"] * sy.double().abs()).argmax())
        ssd_rows.append({
            "max_abs_err": (y.float() - sy.float()).abs().max().item(), "max_abs_out": sy.float().abs().max().item(),
            "y_rel_l2": _rel(y, sy), "h_rel_l2": _rel(h, sh),
            "y_rel_l2_vs_fp64": {"kernel": _rel(y.double(), dy), "seq": _rel(sy.double(), dy)},
            "outside_bf16_tol": int(outside.sum()),
            "outside_bf16_tol_vs_fp64": {n: int((~torch.isclose(v.double(), dy, **SSD_BF16_TOL)).sum())
                                         for n, v in (("kernel", y), ("seq", sy))},
            "worst": {"kernel": y.flatten()[worst].item(), "seq": sy.flatten()[worst].item(),
                      "fp64": dy.flatten()[worst].item()},
            "max_abs_x": args[0].float().abs().max().item(), "max_dt": args[1].max().item(),
        })
    q, k, v, kw = attn_in[0]
    out = flash_op(q, k, v, **kw).float()
    want = flash_op(q, k, v, **{**kw, "impl": "plain"}).float()
    attn = {"shape": list(q.shape), "kv_heads": k.shape[2], "rel_l2": _rel(out, want),
            "max_abs_err": (out - want).abs().max().item(), "max_abs_out": want.abs().max().item(),
            "outside_bf16_tol": int((~torch.isclose(out, want, **BF16_TOL)).sum()), "tolerance_rel_l2": REAL_INPUT_REL}
    del ssd_in, attn_in, out, want, y, h, sy, sh, dy
    (prefill_busy, prefill_ops), (decode_busy, decode_ops), syncs = _device_shares(model, probe)
    del eng, model
    torch.cuda.empty_cache()
    line = {
        "phase": "hybrid_full_width", "config": f"jamba-1.5-large-398b cut to {HYBRID_LAYERS} layers",
        "layers": kinds, "moe_layers": [i for i in range(cfg.n_layers) if cfg.layer_is_moe(i)],
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "ssm": {"heads": H, "head_dim": P, "d_state": N, "groups": G, "conv_width": s.conv_width},
        "moe": dataclasses.asdict(cfg.moe), "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.param_dtype,
        "params": n_params, "init_s": init_s, "init_peak_gb": init_peak_gb, "max_memory_allocated_gb": peak_gb,
        "requests": len(reqs), "engine_steps": rep.steps, "ssd_launches": ssd_launches,
        "ssd_route": f"wgmma P={P} N={N}", "flash_launches": flash_launches, "flash_route": "wgmma (128, 128)",
        "prompt_tokens": prompt_tokens, "prefill_tok_s": prompt_tokens / prefill_s,
        "decode_tokens": decode_tokens, "decode_tok_s": decode_tokens / decode_s,
        "ttft_p50_ms": statistics.median(ttft_ms), "ttft_max_ms": ttft_ms[-1], "wall_s": rep.wall_s,
        "kv_bytes_per_token": kvb,
        "ssd_op_bf16": {"prompt_len": probe.shape[1], "layers": ssd_rows, "y_rel_tolerance": REAL_INPUT_REL,
                        "h_rel_tolerance": SSD_H_REL},
        "attention_op_bf16": attn,
        "prefill_device": {"prompt_len": probe.shape[1], **prefill_busy},
        "prefill_top_ops_us": dict(sorted(prefill_ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]),
        "decode_step_device": {"batch": 4, "host_syncs": len(syncs), **decode_busy},
        "decode_step_top_ops_us": dict(sorted(decode_ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]),
        "phase_wall_s": time.perf_counter() - t_phase,
    }
    emit(line)
    for layer, r in zip([i for i, k_ in enumerate(kinds) if k_ == "ssm"], ssd_rows):
        check(r["y_rel_l2"] <= REAL_INPUT_REL, f"bf16 SSD kernel disagrees with ssd_ref on layer {layer}'s inputs: {r}")
        check(r["h_rel_l2"] <= SSD_H_REL, f"h_final kernel vs ssd_ref on layer {layer}: {r}")
    check(attn["rel_l2"] <= REAL_INPUT_REL, f"flash kernel vs plain on the attention layer's inputs: {attn}")
    fa.flash_attention.launches = 0
    sk.ssd_scan.launches = 0
    return line


def phase_qwen2_full_width(smi: str):
    """qwen2-72b at its published widths cut to QWEN2_SERVE_LAYERS layers,
    served through the continuous-batching engine on the full-width trace:
    the lanes, every prefill's attention on the bf16 tensor-core flash
    kernel at (128, 128) over 64 q heads on 8 kv heads (group 8), the kernel
    held against the plain version on every layer's real inputs (QKV bias
    and rope theta 1e6 in them), the same trace replayed through a fresh
    engine to the same greedy tokens and lanes, no host sync in a decode
    step, and the device's idle share of a prefill and a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer
    from repro_torch.serve import Engine, ServeConfig, replay_load

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-72b"), n_layers=QWEN2_SERVE_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.qkv_bias,
           cfg.rope_theta, cfg.param_dtype, cfg.tie_embeddings)
          == (8192, 64, 8, 128, 29568, 152064, True, 1_000_000.0, "bfloat16", False), "qwen2-72b's published widths")
    check(fa.select_route(cfg.compute_tdtype(), 128, 128) == "wgmma", "bf16 attention takes the tensor-core kernel")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == QWEN2_SERVE_PARAMS, f"{n_params} parameters, want {QWEN2_SERVE_PARAMS}")
    biases = {n: p for n, p in model.named_parameters() if n.rsplit(".", 1)[-1] in ("bq", "bk", "bv")}
    check(len(biases) == 3 * cfg.n_layers, f"QKV bias in every layer: {len(biases)} bias leaves")
    # the reference initialises the biases to zero, which would leave their path idle: draw them from a seed
    g = torch.Generator(device="cuda").manual_seed(QWEN2_BIAS_SEED)
    with torch.no_grad():
        for p in biases.values():
            p.copy_(torch.randn(p.shape, generator=g, device="cuda") * QWEN2_BIAS_STD)
    scfg = ServeConfig(n_slots=4, max_len=1024, batch_buckets=(1, 2))

    warm = torch.randint(0, cfg.vocab_size, (1, 64), device="cuda")
    model.prefill(warm)
    scratch = model.init_cache(1, 80)
    model.decode_step(scratch, warm[:, 0], torch.zeros(1, dtype=torch.long, device="cuda"))
    del scratch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_op, calls = ops.flash_attention, []

    def rec_flash(q, k, v, **kw):
        calls.append((q.device.type, q.dtype, q.shape[2], k.shape[2], q.shape[-1], v.shape[-1], kw.get("impl", "auto")))
        return flash_op(q, k, v, **kw)

    runs = []
    for attempt in range(2):  # the trace, then the same trace through a fresh engine
        eng = Engine(model, scfg)
        load = _full_width_load(TRACE_VOCAB)
        fa.flash_attention.launches = 0
        shapes_before = fa.flash_attention.shapes.copy()
        ops.flash_attention = rec_flash
        try:
            rep = replay_load(eng, load)
        finally:
            ops.flash_attention = flash_op
        torch.cuda.synchronize()
        reqs = [r for _, r in load]
        runs.append({"eng": eng, "reqs": reqs, "rep": rep, "launches": fa.flash_attention.launches,
                     "by_shape": fa.flash_attention.shapes - shapes_before, "lanes": _lanes(eng, reqs),
                     "tokens": [list(r.generated) for r in reqs]})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first = runs[0]
    eng, reqs, rep, launches = first["eng"], first["reqs"], first["rep"], first["launches"]
    check(len(reqs) == 10 and all(r.status == "done" for r in reqs), f"statuses {[r.status for r in reqs]}")
    kvb = eng._kv_bytes_per_token
    check(kvb == 2 * cfg.n_kv_heads * cfg.resolved_head_dim * cfg.n_layers * 2, f"kv bytes per token {kvb}")
    for r in reqs:
        tok_out, kv = first["lanes"][r.name]
        check(tok_out == len(r.generated) == r.max_new_tokens, f"{r.name}: TOKENS_OUT {tok_out}, {len(r.generated)}")
        check(kv == (len(r.prompt) + len(r.generated) - 1) * kvb, f"{r.name}: KV_ACC_W {kv}")
    check(launches == cfg.n_layers * len(reqs) == len(calls) // 2
          and set(calls) == {("cuda", torch.bfloat16, 64, 8, 128, 128, "auto")},
          f"flash launches {launches}, calls {set(calls)}: every prefill layer on the bf16 kernel, 64 over 8 heads")
    check(all((r.Hq, r.Hkv, r.D, r.Dv, r.esize) == (64, 8, 128, 128, 2) for r in first["by_shape"]),
          f"launches by shape {first['by_shape']}")
    replay_same = {"tokens": first["tokens"] == runs[1]["tokens"], "lanes": first["lanes"] == runs[1]["lanes"],
                   "launches": launches == runs[1]["launches"]}
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    prefill_s = sum(r.prefill_s for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    decode_s = sum(r.decode_s for r in reqs)
    ttft_ms = sorted(r.ttft_s * 1e3 for r in reqs)
    del runs

    # one real prompt: every layer's q, k, v through the kernel against the plain version
    probe = torch.as_tensor(reqs[0].prompt, dtype=torch.long, device="cuda")[None]
    attn_in = []

    def capture_flash(q, k, v, **kw):
        attn_in.append((q, k, v, kw))
        return flash_op(q, k, v, **kw)

    ops.flash_attention = capture_flash
    try:
        logits = model.prefill(probe)[0][..., :cfg.vocab_size]
    finally:
        ops.flash_attention = flash_op
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(len(attn_in) == cfg.n_layers, f"{len(attn_in)} attention calls in one prefill")
    saved = {n: p.detach().clone() for n, p in biases.items()}
    with torch.no_grad():
        for p in biases.values():
            p.zero_()
        bias_effect = _rel(model.prefill(probe)[0][..., :cfg.vocab_size].float(), logits.float())
        for n, p in biases.items():
            p.copy_(saved[n])
    del saved
    attn_rows = []
    for q, k, v, kw in attn_in:
        out = flash_op(q, k, v, **kw).float()
        want = flash_op(q, k, v, **{**kw, "impl": "plain"}).float()
        attn_rows.append({"rel_l2": _rel(out, want), "max_abs_err": (out - want).abs().max().item(),
                          "max_abs_out": want.abs().max().item(),
                          "outside_bf16_tol": int((~torch.isclose(out, want, **BF16_TOL)).sum())})
    del attn_in, out, want
    (prefill_busy, prefill_ops), (decode_busy, decode_ops), syncs = _device_shares(model, probe)
    del eng, model
    torch.cuda.empty_cache()
    line = {
        "phase": "qwen2_full_width", "config": f"qwen2-72b cut to {QWEN2_SERVE_LAYERS} of 80 layers",
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "qkv_bias": cfg.qkv_bias,
        "rope_theta": cfg.rope_theta, "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s,
        "init_peak_gb": init_peak_gb, "max_memory_allocated_gb": peak_gb,
        "card_memory_gb": torch.cuda.get_device_properties(0).total_memory / 1e9,
        "requests": len(reqs), "engine_steps": rep.steps,
        "flash_launches": launches, "flash_route": "wgmma (128, 128), 64 q heads on 8 kv heads (group 8)",
        "flash_launches_by_shape": {f"S={r.Sq} B={r.B} Hq={r.Hq} Hkv={r.Hkv}": n
                                    for r, n in sorted(first["by_shape"].items())},
        "prompt_tokens": prompt_tokens, "prefill_tok_s": prompt_tokens / prefill_s,
        "decode_tokens": decode_tokens, "decode_tok_s": decode_tokens / decode_s,
        "ttft_p50_ms": statistics.median(ttft_ms), "ttft_max_ms": ttft_ms[-1], "wall_s": rep.wall_s,
        "goodput_tok_s": rep.total_goodput_tok_s, "kv_bytes_per_token": kvb,
        "replay_equal": replay_same, "qkv_bias_std": QWEN2_BIAS_STD,
        "logits_rel_l2_with_zero_bias": bias_effect,
        "attention_op_bf16": {"prompt_len": probe.shape[1], "layers": attn_rows, "tolerance_rel_l2": REAL_INPUT_REL},
        "prefill_device": {"prompt_len": probe.shape[1], **prefill_busy},
        "prefill_top_ops_us": dict(sorted(prefill_ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]),
        "decode_step_device": {"batch": 4, "host_syncs": len(syncs), **decode_busy},
        "decode_step_top_ops_us": dict(sorted(decode_ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]),
        "phase_wall_s": time.perf_counter() - t_phase,
    }
    emit(line)
    check(all(replay_same.values()), f"a replay of the trace differs: {replay_same}")
    check(bias_effect > REAL_INPUT_REL, f"zeroing the QKV bias moves the logits by {bias_effect} only")
    for layer, r in enumerate(attn_rows):
        check(r["rel_l2"] <= REAL_INPUT_REL, f"flash kernel vs plain on layer {layer}'s prefill inputs: {r}")
    fa.flash_attention.launches = 0
    return line


def _ssd_inputs(B, S, H, P, N, G, dtype, seed, h0=False):
    """Seeded SSD inputs on the card: x, B, C in ``dtype``; dt, A, D, h0 fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    x = rn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H) - 1.0)
    A = -torch.exp(rn(H) * 0.5)
    Bm, Cm = (rn(B, S, G, N) * 0.3).to(dtype), (rn(B, S, G, N) * 0.3).to(dtype)
    D = rn(H) * 0.2
    return x, dt, A, Bm, Cm, D, (rn(B, H, P, N) * 0.1 if h0 else None)


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


def phase_ssd_kernel(smi: str):
    """The SSD kernels against the sequential plain scan: fp32 on the SIMT
    kernel at SSD_SHAPES, bf16 on the tensor-core kernel (whose SASS must
    hold HGMMA and UTMALDG) at mamba2-130m's width on every SSD_SEQS length
    with and without h0; at head dim 128 (``p128``) bf16 on the tensor-core
    kernel at P128_EDGES and at jamba's width on every P128_SEQS length with
    and without h0, fp32 on the SIMT kernel at P128_FP32; then both kernels
    timed in bf16 beside the plain chunked form at the training shapes, and
    the tensor-core kernel beside it at jamba's prefills."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import ssd_ref

    fp32_err = 0.0
    for i, shape in enumerate(SSD_SHAPES):
        for with_h0 in (False, True):
            x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(*shape, torch.float32, 300 + i, with_h0)
            y, h = sk.ssd_scan(x, dt, A, Bm, Cm, D, h0, chunk=32)
            want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h0, return_state=True)
            torch.cuda.synchronize()
            fp32_err = max(fp32_err, (y - want_y).abs().max().item(), (h - want_h).abs().max().item())
            check(torch.allclose(y, want_y, **SSD_FP32_TOL) and torch.allclose(h, want_h, **SSD_FP32_TOL),
                  f"fp32 SSD kernel disagrees with ssd_ref at {shape} h0={with_h0}")
    H, P, N, G = SSD_WIDTH
    check(sk.select_route(torch.bfloat16) == "wgmma" and sk.select_route(torch.float32) == "simt",
          "SSD routes: bf16 on the tensor-core kernel, fp32 on the SIMT kernel")
    bf16_err, h_rel = 0.0, 0.0
    for S in SSD_SEQS:
        for with_h0 in (False, True):
            x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(1, S, H, P, N, G, torch.bfloat16, 400 + S, with_h0)
            y, h = sk.ssd_scan(x, dt, A, Bm, Cm, D, h0, chunk=256)
            want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h0, return_state=True)
            torch.cuda.synchronize()
            bf16_err = max(bf16_err, (y.float() - want_y.float()).abs().max().item())
            h_rel = max(h_rel, _rel(h, want_h))
            check(y.dtype == torch.bfloat16 and h.dtype == torch.float32, "SSD output dtypes")
            check(torch.allclose(y.float(), want_y.float(), **SSD_BF16_TOL),
                  f"bf16 SSD kernel disagrees on y at S={S} h0={with_h0}")
            check(torch.allclose(h, want_h, **SSD_BF16_TOL), f"bf16 SSD kernel disagrees on h_final at S={S} h0={with_h0}")
    # head dim 128: bf16 on the tensor-core kernel (two warpgroups a block), fp32 on the SIMT kernel
    JH, JP, JN, JG = JAMBA_SSD_WIDTH
    p128 = {"bf16_max_abs_err": 0.0, "bf16_max_rel_err": 0.0, "bf16_h_final_rel_l2": 0.0, "fp32_max_abs_err": 0.0}
    for shape in [*P128_EDGES, *((1, S, JH, JP, JN, JG) for S in P128_SEQS)]:
        for with_h0 in (False, True):
            x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(*shape, torch.bfloat16, 600 + shape[1], with_h0)
            y, h = sk.ssd_scan(x, dt, A, Bm, Cm, D, h0, chunk=256)
            want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h0, return_state=True)
            torch.cuda.synchronize()
            err = (y.float() - want_y.float()).abs()
            p128["bf16_max_abs_err"] = max(p128["bf16_max_abs_err"], err.max().item())
            p128["bf16_max_rel_err"] = max(p128["bf16_max_rel_err"], _rel(y, want_y))
            p128["bf16_h_final_rel_l2"] = max(p128["bf16_h_final_rel_l2"], _rel(h, want_h))
            check(torch.allclose(y.float(), want_y.float(), **SSD_BF16_TOL),
                  f"bf16 SSD kernel at P = 128 disagrees on y at {shape} h0={with_h0}")
            check(_rel(h, want_h) <= SSD_H_REL, f"bf16 SSD kernel at P = 128 disagrees on h_final at {shape} "
                                                f"h0={with_h0}: {_rel(h, want_h)}")
    for i, shape in enumerate(P128_FP32):
        x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(*shape, torch.float32, 650 + i, True)
        y, h = sk.ssd_scan(x, dt, A, Bm, Cm, D, h0, chunk=shape[1])
        want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, D, h0, return_state=True)
        torch.cuda.synchronize()
        p128["fp32_max_abs_err"] = max(p128["fp32_max_abs_err"], (y - want_y).abs().max().item(),
                                       (h - want_h).abs().max().item())
        check(torch.allclose(y, want_y, **SSD_FP32_TOL) and torch.allclose(h, want_h, **SSD_FP32_TOL),
              f"fp32 SSD kernel at P = 128 disagrees with ssd_ref at {shape}")
    p128["checked"] = {"bf16": [list(s) for s in P128_EDGES] + [[1, S, JH, JP, JN, JG] for S in P128_SEQS],
                       "fp32": [list(s) for s in P128_FP32], "h0": [False, True]}

    lib = build.build(["ssd_scan_wgmma"])["ssd_scan_wgmma"]["path"]
    sass = {fn: c for fn, c in sass_counts(lib, build.BUILD_DIR / "ssd_scan_wgmma.sass").items()
            if re.search(r"ssd_(prep|out)ILi(64|128)ELi(64|128)E", fn)}
    sass = {re.search(r"(ssd_(?:prep|out))ILi(\d+)ELi(\d+)E", fn).expand(r"\1<P=\2,N=\3>"): c
            for fn, c in sass.items()}
    check(len(sass) == 8 and all(c[op] > 0 for c in sass.values() for op in SASS_OPS),
          f"bf16 SSD kernels lack {SASS_OPS} in their SASS: {sass}")

    timings = {}
    for B, S in SSD_TIMED:
        x, dt, A, Bm, Cm, D, _ = _ssd_inputs(B, S, H, P, N, G, torch.bfloat16, 500 + S)
        ms = time_interleaved({
            "kernel": lambda: sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256),
            "simt": lambda: sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, route="simt"),
            "plain": lambda: ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, impl="plain"),
        })
        flops, nbytes = sk.ssd_flops(B, S, H, P, N, G), sk.ssd_bytes(B, S, H, P, N, G, 2)  # no h0
        bound_ms, bound_by = _bound(flops, nbytes, smi)
        timings[f"B{B}_S{S}"] = {
            "kernel_ms": ms["kernel"]["median"], "simt_ms": ms["simt"]["median"], "plain_ms": ms["plain"]["median"],
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes,
            "tiles_per_chunk": sk.tiles_per_chunk(B, H, S, torch.cuda.get_device_properties(0).multi_processor_count),
            "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()},
            "device_us_by_kernel": device_breakdown(lambda: sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256)),
        }
        by_kernel = timings[f"B{B}_S{S}"]["device_us_by_kernel"]
        check(len(by_kernel) == sk.KERNELS_PER_CALL,
              f"a bf16 SSD call launched {sorted(by_kernel)}, not {sk.KERNELS_PER_CALL} kernels")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p128["timing"] = {}
    for S in P128_TIMED:
        x, dt, A, Bm, Cm, D, _ = _ssd_inputs(1, S, JH, JP, JN, JG, torch.bfloat16, 700 + S)
        ms = time_interleaved({
            "kernel": lambda: sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256),
            "simt": lambda: sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, route="simt"),
            "plain": lambda: ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, impl="plain"),
        })
        flops, nbytes = sk.ssd_flops(1, S, JH, JP, JN, JG), sk.ssd_bytes(1, S, JH, JP, JN, JG, 2)  # no h0
        bound_ms, bound_by = _bound(flops, nbytes, smi)
        by_kernel = device_breakdown(lambda: sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256))
        check(len(by_kernel) == sk.KERNELS_PER_CALL,
              f"a bf16 SSD call at P = 128 launched {sorted(by_kernel)}, not {sk.KERNELS_PER_CALL} kernels")
        p128["timing"][f"B1_S{S}"] = {
            "kernel_ms": ms["kernel"]["median"], "simt_ms": ms["simt"]["median"], "plain_ms": ms["plain"]["median"],
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "tiles_per_chunk": sk.tiles_per_chunk(1, JH, S, sms, JP),
            "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()}, "device_us_by_kernel": by_kernel,
        }
    # fp32 at jamba's width on the SIMT kernels (the fp32 route: jamba's smoke parity runs it at P = 32)
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(1, P128_FP32_TIMED, JH, JP, JN, JG, torch.float32, 760)
    ms = time_interleaved({
        "kernel": lambda: sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256),
        "plain": lambda: ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, impl="plain"),
    })
    flops = sk.ssd_flops(1, P128_FP32_TIMED, JH, JP, JN, JG)
    nbytes = sk.ssd_bytes(1, P128_FP32_TIMED, JH, JP, JN, JG, 4)  # no h0
    bound_ms, bound_by = _bound(flops, nbytes, smi, fp32=True)
    by_kernel = device_breakdown(lambda: sk.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256))
    check(len(by_kernel) == sk.KERNELS_PER_CALL,
          f"an fp32 SSD call at P = 128 launched {sorted(by_kernel)}, not {sk.KERNELS_PER_CALL} kernels")
    p128["fp32_timing"] = {f"B1_S{P128_FP32_TIMED}": {
        "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"], "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()}, "device_us_by_kernel": by_kernel}}
    emit({"phase": "ssd_kernel", "name": "ssd_scan", "fp32_max_abs_err": fp32_err, "bf16_max_abs_err": bf16_err,
          "bf16_h_final_rel_l2": h_rel, "tolerances": {"fp32": SSD_FP32_TOL, "bf16": SSD_BF16_TOL},
          "routes": {"bfloat16": sk.select_route(torch.bfloat16), "float32": sk.select_route(torch.float32)},
          "sass_ssd_scan_wgmma": sass, "p128": {"width": "H=128 P=128 N=128 G=1 (jamba)", **p128},
          "bound": "FLOPs of the least work (ssd_flops): C B^T once per (batch, group, 64-row tile) and M X, "
                   "each the causal half, C h^T and the state product per (batch, head, tile); bytes as listed; "
                   "at the bf16 dense peak and HBM rate",
          "timing": timings,
          "timing_note": f"median of {ROUNDS} readings, each the mean of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) "
                         "back-to-back calls replayed from one CUDA graph between CUDA events; the tensor-core "
                         "kernel (kernel), "
                         "the SIMT kernel on the same bf16 inputs (simt) and the plain chunked form "
                         "alternate; inputs warm in L2; no single PyTorch call computes the SSD scan (library: none)"})
    return max(bf16_err, fp32_err), timings, p128


def phase_ssm_parity():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.optim import ScheduleConfig, adamw_init
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = get_smoke_config("mamba2-130m")
    check(cfg.compute_dtype == "float32" and cfg.remat == "full", "mamba2 smoke is fp32 with full remat")
    tcfg = TrainConfig(schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10), microbatches=2)
    cpu_model, cpu_opt = init_train_state(cfg, tcfg, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gpu_opt = adamw_init(dict(gpu_model.named_parameters()))

    # greedy prefill + decode from the same weights
    prompt = torch.as_tensor(np.random.default_rng(21).integers(0, cfg.vocab_size, (2, 40)), dtype=torch.long)
    c_logits, c_cache = cpu_model.prefill(prompt)
    before = sk.ssd_scan.launches
    g_logits, g_cache = gpu_model.prefill(prompt.cuda())
    check(sk.ssd_scan.launches - before == cfg.n_layers, "every card prefill layer runs the SSD kernel once")
    logits_err, tokens = (g_logits.cpu() - c_logits).abs().max().item(), []
    pos = torch.full((2,), prompt.shape[1], dtype=torch.long)
    for _ in range(12):
        tok = c_logits.argmax(-1)
        check(torch.equal(g_logits.argmax(-1).cpu(), tok), "greedy tokens differ between card and CPU")
        tokens.append(tok.tolist())
        c_logits, c_cache = cpu_model.decode_step(c_cache, tok, pos)
        g_logits, g_cache = gpu_model.decode_step(g_cache, tok.cuda(), pos.cuda())
        logits_err = max(logits_err, (g_logits.cpu() - c_logits).abs().max().item())
        pos = pos + 1
    check(logits_err <= SSM_LOGITS_ATOL, f"smoke prefill/decode logits card vs CPU differ by {logits_err}")

    it = make_train_iter(DataConfig(global_batch=4, seq_len=64, vocab_size=cfg.vocab_size, seed=5))
    batches = [next(it) for _ in range(3)]
    it.close()
    cpu_step, gpu_step = make_train_step(cpu_model, tcfg), make_train_step(gpu_model, tcfg)
    before = sk.ssd_scan.launches
    rows = []
    for b in batches:
        cpu_opt, cm = cpu_step(cpu_opt, b)
        gpu_opt, gm = gpu_step(gpu_opt, b)
        rows.append({k: (float(gm[k]), float(cm[k])) for k in ("loss", "grad_norm")})
    launches = sk.ssd_scan.launches - before
    for i, r in enumerate(rows):
        (gl, cl), (gg, cg) = r["loss"], r["grad_norm"]
        check(abs(gl - cl) <= SSM_LOSS_RTOL * abs(cl), f"step {i}: loss card {gl} vs CPU {cl}")
        check(abs(gg - cg) <= SSM_GNORM_RTOL * abs(cg), f"step {i}: grad norm card {gg} vs CPU {cg}")
    # each microbatch: one launch per layer forward, one per layer recompute under remat
    want = len(batches) * tcfg.microbatches * 2 * cfg.n_layers
    check(launches == want, f"SSD launches in 3 smoke steps: {launches}, want {want}")
    emit({"phase": "ssm_parity", "config": "mamba2-130m SMOKE", "dtype": "float32, TF32 off",
          "steps": [{k: {"card": v[0], "cpu": v[1]} for k, v in r.items()} for r in rows],
          "decode_tokens": tokens, "logits_max_abs_err": logits_err, "card_ssd_launches": launches,
          "tolerances": {"loss_rtol": SSM_LOSS_RTOL, "grad_norm_rtol": SSM_GNORM_RTOL,
                         "logits_atol": SSM_LOGITS_ATOL}})


def phase_train_full_width():
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import TrainConfig, Trainer, make_loss_fn, make_train_step

    cfg = get_config("mamba2-130m")
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    check((cfg.n_layers, cfg.d_model, H, s.head_dim, s.d_state, s.n_groups, s.chunk, cfg.vocab_size)
          == (24, 768, 24, 64, 128, 1, 256, 50280), "mamba2-130m's published shape")
    cfg = dataclasses.replace(cfg, n_layers=MAMBA_LAYERS)
    tcfg = TrainConfig(adamw=AdamWConfig(weight_decay=0.1, grad_clip=1.0),
                       schedule=ScheduleConfig(peak_lr=6e-4, warmup_steps=20, decay_steps=SCHEDULE_STEPS),
                       microbatches=TRAIN_MICRO)
    dcfg = DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size)
    train_it = make_train_iter(dcfg)
    eval_it = make_train_iter(dataclasses.replace(dcfg, seed=99))
    probe_it = make_train_iter(dataclasses.replace(dcfg, seed=7))
    probe = next(probe_it)  # one fixed held-out batch
    probe_it.close()
    trainer = Trainer(cfg, tcfg, train_it, eval_iter=eval_it, eval_every=EVAL_EVERY, device="cuda")
    t0 = time.perf_counter()
    model, opt = trainer.restore_or_init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    held_out = make_loss_fn(model, tcfg)
    with torch.no_grad():
        probe_before = float(held_out(probe)[1]["loss"])
    torch.cuda.reset_peak_memory_stats()

    sk.ssd_scan.launches = fa.flash_attention.launches = 0
    model, opt, hist = trainer.run(model, opt, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches, flash_launches = sk.ssd_scan.launches, fa.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_it.close()
    eval_it.close()

    with torch.no_grad():
        probe_after = float(held_out(probe)[1]["loss"])
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(e["loss"]) for e in trainer.eval_history), "non-finite loss")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first, f"train loss does not fall: first-10 mean {first}, last-10 mean {last}")
    check(probe_after < probe_before - EVAL_DROP,
          f"held-out loss does not fall by {EVAL_DROP}: {probe_before} -> {probe_after}")
    n_evals = TRAIN_STEPS // EVAL_EVERY
    train, evals = trainer.stats.summary(trainer.train_stream), trainer.stats.summary(trainer.eval_stream)
    check(train["steps"] == TRAIN_STEPS == len(hist), f"train lane steps {train['steps']}")
    check(evals["steps"] == n_evals == len(trainer.eval_history), f"eval lane steps {evals['steps']}")
    check(train["tokens"] == TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ, f"train lane tokens {train['tokens']}")
    per_launch = sk.ssd_flops(TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, H, s.head_dim, s.d_state, s.n_groups)
    per_step = TRAIN_MICRO * 2 * cfg.n_layers  # a forward and a remat recompute per layer and microbatch
    check(trainer.cost_parts["ssd_kernel"] == per_step * per_launch, f"scan FLOPs {trainer.cost_parts}")
    lane_flops = TRAIN_STEPS * (trainer.cost_parts["counted"] + trainer.cost_parts["ssd_kernel"])
    check(abs(train["flops"] - lane_flops) <= 1e-9 * lane_flops, "the train lane's FLOPs are the counted plus the scan's")
    check(evals["flops"] == 0 and flash_launches == 0, "the eval lane carries no cost; no attention here")
    want = TRAIN_STEPS * per_step + n_evals * cfg.n_layers
    check(launches == want, f"SSD launches {launches}, want {want} = {TRAIN_STEPS} steps x {per_step} + "
                            f"{n_evals} evals x {cfg.n_layers}")
    step_ms = [r.seconds * 1e3 for r in trainer.stats.records if r.stream_id == trainer.train_stream]
    steady_ms = statistics.median(step_ms[2:])

    # the device's busy time over one more step, traced (the counts were read above); the
    # idle share is taken against the unprofiled median step, since the profiler's own host
    # cost would otherwise count as device idle.  Device events only: recording the host's
    # ops too took 8.3 s against 0.8 for a trace of 24,000 small kernels on the H100
    from torch.profiler import ProfilerActivity, profile

    step = make_train_step(model, tcfg)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        opt, _ = step(opt, probe)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t1
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    idle = {"device_busy_ms": busy_s * 1e3, "kernel_launches": len(kernels), "step_ms_median": steady_ms,
            "idle_share": max(0.0, 1.0 - busy_s * 1e3 / steady_ms) if kernels else "not measured",
            "traced_step_ms": traced_s * 1e3, "profiler_s": time.perf_counter() - t0}

    # one step at the train_4k length
    long_batch = {k: np.concatenate([v] * (4096 // TRAIN_SEQ), axis=1)[:2] for k, v in probe.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt, m4k = step(opt, long_batch)
    loss_4k = float(m4k["loss"])
    step_4k_ms = (time.perf_counter() - t0) * 1e3
    peak_4k_gb = torch.cuda.max_memory_allocated() / 1e9
    check(np.isfinite(loss_4k), "non-finite loss at seq 4096")

    emit({
        "phase": "train_full_width", "config": "mamba2-130m", "n_layers": cfg.n_layers, "published_layers": 24,
        "d_model": cfg.d_model,
        "ssd": {"H": H, "P": s.head_dim, "N": s.d_state, "G": s.n_groups, "chunk": s.chunk},
        "vocab": cfg.vocab_size, "dtype": {"compute": cfg.compute_dtype, "params": cfg.param_dtype},
        "remat": cfg.remat, "params": n_params, "init_s": init_s,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS,
        "schedule_steps": SCHEDULE_STEPS, "loss_first10": first, "loss_last10": last, "losses": losses,
        "held_out_loss": {"before": probe_before, "after": probe_after, "min_drop": EVAL_DROP},
        "eval_losses": [e["loss"] for e in trainer.eval_history],
        "lanes": {"train": train, "eval": evals}, "step_cost": trainer.cost_parts, "count_s": trainer.count_s,
        "ssd_launches": launches, "ssd_launches_expected": want,
        "tokens_per_s": train["tokens_per_s"], "step_ms_median": steady_ms,
        "step_ms_first": step_ms[0], "max_memory_allocated_gb": peak_gb, "device_idle": idle,
        "seq4096": {"batch": 2, "microbatches": TRAIN_MICRO, "loss": loss_4k, "step_ms": step_4k_ms,
                    "max_memory_allocated_gb": peak_4k_gb},
    })
    return model, launches, probe


def _ssd_worst_terms(args, kw, ys, idx):
    """The SSD output element ``idx`` = (b, t, h, p) split into its terms as
    each form computes it, beside fp64: the intra-tile term (the tile's own
    rows, sum over s <= t of (C_t·B_s) exp(cum_t - cum_s) dt_s x_s), the
    inter-tile term (exp(cum_t) C_t·h_in, h_in the state entering the tile)
    and the skip term D x_t.  Tiles: the kernel's 64 rows for the kernel,
    the sequential fp32 scan and fp64; the plain chunked form's own chunk
    (``ops.ref_chunk``) for it, with fp64 at that split too.  Each form's
    h_in is its own: the kernel's and the plain form's final state over the
    rows before the tile, the sequential scan's state there.  The kernel's
    terms are read at its rounding points (``ref.ssd_tiled_ref``'s: the
    prefix of A·dt and the decays' arguments in fp64, M and h_in as two
    bf16 terms, the skip riding on M's diagonal, fp32 products); ``ys`` holds each form's y at the element as it returned it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import _bf16_terms, ssd_chunked_ref, ssd_ref
    from repro_torch.kernels.ssd_scan import TILE

    x, dt, A, Bm, Cm, D = (a.detach() for a in args[:6])
    b, t, h, p = idx
    g = h // (x.shape[2] // Bm.shape[2])
    chunk = ops.ref_chunk(x.shape[1], kw["chunk"])
    xs, dts = x[b, :, h, p], dt[b, :, h]  # (S,), (S,)
    Bs, Cs = Bm[b, :, g], Cm[b, :, g]  # (S, N)
    Dh = D[h]

    def prefix_state(form, t0):  # the form's state at row t0 (entering the tile), (N,) of row p
        if t0 == 0:
            return torch.zeros(Bm.shape[-1], dtype=torch.float64 if form == "fp64" else torch.float32,
                               device=x.device)
        sl = [a[b:b + 1, :t0] for a in (x, dt, Bm, Cm)]
        one = (sl[0], sl[1], A, sl[2], sl[3], D)
        with torch.no_grad():
            if form == "kernel":
                _, hf = ops.ssd_scan(*one, chunk=kw["chunk"])
            elif form == "plain":
                _, hf = ssd_chunked_ref(*one, chunk=chunk, return_state=True)
            else:
                _, hf = ssd_ref(*[a.double() if form == "fp64" else a for a in one], return_state=True)
        return hf[0, h, p]

    def seq_terms(t0, f):  # sequential in dtype f: from zero over the tile's rows, h_in decayed alongside
        h_in = prefix_state("fp64" if f == torch.float64 else "seq", t0).to(f)
        hi = torch.zeros_like(h_in)
        for r in range(t0, t + 1):
            decay = torch.exp(A[h].to(f) * dts[r].to(f))
            hi = hi * decay + dts[r].to(f) * (xs[r].to(f) * Bs[r].to(f))
            h_in = h_in * decay
        c = Cs[t].to(f)
        return {"intra": float((hi * c).sum()), "inter": float((h_in * c).sum()),
                "skip": float(Dh.to(f) * xs[t].to(f))}

    def tiled_terms(t0, form, cum64=False):  # the chunked forms: M over the tile, exp(cum_t) C_t·h_in
        f = torch.float32
        rows = slice(t0, t + 1)
        a = A[h].double() * dts[t0:t + 1].double() if cum64 else A[h] * dts[t0:t + 1].to(f)
        cum = torch.cumsum(a, 0)
        cb = (Cs[t].to(f)[None] * Bs[rows].to(f)).sum(-1)  # C_t·B_s, s in the tile up to t
        m = cb * torch.exp((cum[-1] - cum).to(f)) * dts[rows].to(f)
        h_in = prefix_state(form, t0)
        if form == "kernel":
            m_skip = m.clone()
            m_skip[-1] += Dh
            m_skip = _bf16_terms(m_skip, 2)
            intra_skip = float((m_skip * xs[rows].to(f)).sum())
            h_in = _bf16_terms(h_in, 2)
        inter = float(torch.exp(cum[-1].to(f)) * (Cs[t].to(f) * h_in).sum())
        out = {"intra": float((m * xs[rows].to(f)).sum()), "inter": inter, "skip": float(Dh * xs[t].to(f))}
        if form == "kernel":
            out["intra_with_skip_as_one_product"] = intra_skip
            out["y_fp32"] = intra_skip + inter
        return out

    t_tile, t_chunk = (t // TILE) * TILE, (t // chunk) * chunk
    with torch.no_grad():
        terms = {"kernel": tiled_terms(t_tile, "kernel", cum64=True),
                 "seq_fp32": seq_terms(t_tile, torch.float32),
                 "fp64": seq_terms(t_tile, torch.float64), "plain": tiled_terms(t_chunk, "plain"),
                 "fp64_at_plain_chunk": seq_terms(t_chunk, torch.float64)}
    for v in terms.values():
        v.setdefault("y_fp32", v["intra"] + v["inter"] + v["skip"])
    return {"element": {"b": b, "t": t, "h": h, "p": p}, "tile_start": t_tile, "chunk_start": t_chunk,
            "y": ys, "terms": terms, "x_t": float(xs[t]), "dt_t": float(dts[t]), "D": float(Dh)}


def phase_ssd_op(model, probe):
    """The SSD inputs every layer hands to ``ops.ssd_scan`` in one forward of
    a real training microbatch: the kernel against the sequential plain scan
    (the oracle), with the plain chunked form and an fp64 sequential scan
    beside them.  Where a form falls outside SSD_BF16_TOL of another or of
    fp64, its worst element is split into its terms (``_ssd_worst_terms``).
    All pairings are emitted before any check fails."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_ref

    ssd_op, captured = ops.ssd_scan, []

    def capture(*args, **kw):
        captured.append((args, kw))
        return ssd_op(*args, **kw)

    ops.ssd_scan = capture
    try:
        with torch.no_grad():
            model(torch.as_tensor(probe["tokens"][: TRAIN_BATCH // TRAIN_MICRO], device="cuda").long())
    finally:
        ops.ssd_scan = ssd_op
    check(len(captured) == model.cfg.n_layers, f"{len(captured)} SSD calls in one forward")

    def close(a, b):
        return bool(torch.allclose(a.float(), b.float(), **SSD_BF16_TOL))

    rows = []
    for args, kw in captured:
        with torch.no_grad():
            y, h = ssd_op(*args, **kw)
            py, ph = ssd_op(*args, **{**kw, "impl": "plain"})
            sy, sh = ssd_ref(*args, h0=kw.get("h0"), return_state=True)
            wide = [a.double() if torch.is_tensor(a) else a for a in args]
            dy, dh = ssd_ref(*wide, return_state=True)
        x, dt = args[0], args[1]
        worst = int((y.double() - dy).abs().argmax())
        rows.append({
            "kernel_vs_seq": (y.float() - sy.float()).abs().max().item(), "kernel_vs_plain":
                (y.float() - py.float()).abs().max().item(),
            "err_vs_fp64": {n: (v.double() - dy).abs().max().item() for n, v in (("kernel", y), ("plain", py),
                                                                                   ("seq", sy))},
            "outside_bf16_tol_vs_fp64": {n: int((~torch.isclose(v.double(), dy, **SSD_BF16_TOL)).sum())
                                         for n, v in (("kernel", y), ("plain", py), ("seq", sy))},
            "outside_bf16_tol_vs_seq": int((~torch.isclose(y.float(), sy.float(), **SSD_BF16_TOL)).sum()),
            "max_abs_out": dy.abs().max().item(), "max_abs_x": x.float().abs().max().item(),
            "max_dt": dt.max().item(),
            "worst": {"kernel": y.flatten()[worst].item(), "plain": py.flatten()[worst].item(),
                      "seq": sy.flatten()[worst].item(), "fp64": dy.flatten()[worst].item()},
            "h_rel": {"kernel_vs_seq": _rel(h, sh), "kernel_vs_plain": _rel(h, ph), "kernel_vs_fp64": _rel(h, dh)},
            "ok": {"y_vs_seq": close(y, sy), "y_vs_plain": close(y, py), "h": _rel(h, sh) <= SSD_H_REL},
        })
        # where a form falls outside the tolerance of another or of fp64: the worst element of each such
        # pairing, by its excess over the tolerance, split into its terms
        excess = {}
        for n, (a, ref) in {"kernel_vs_seq": (y, sy), "kernel_vs_fp64": (y, dy), "seq_vs_fp64": (sy, dy),
                            "plain_vs_fp64": (py, dy)}.items():
            ref = ref.double()
            excess[n] = (a.double() - ref).abs() / (SSD_BF16_TOL["atol"] + SSD_BF16_TOL["rtol"] * ref.abs())
        worst = {}
        for n, e in excess.items():
            if bool((e > 1).any()):
                idx = tuple(int(i) for i in np.unravel_index(int(e.argmax()), tuple(y.shape)))
                ys = {k: float(v[idx]) for k, v in (("kernel", y), ("plain", py), ("seq_fp32", sy), ("fp64", dy))}
                worst[n] = {**_ssd_worst_terms(args, kw, ys, idx),
                            "excess_over_tol": {k: float(x_[idx]) for k, x_ in excess.items()}}
        if worst:
            rows[-1]["worst_terms"] = worst
    emit({"phase": "ssd_op", "config": "mamba2-130m", "inputs": "one training microbatch (4 x 256), every layer",
          "layers": rows, "tolerance": SSD_BF16_TOL, "h_rel_tolerance": SSD_H_REL})
    for layer, r in enumerate(rows):
        check(r["ok"]["y_vs_seq"], f"bf16 SSD kernel disagrees with ssd_ref on layer {layer}'s training inputs")
        check(r["ok"]["h"], f"h_final kernel vs ssd_ref on layer {layer}: {r['h_rel']}")
    return max(r["kernel_vs_seq"] for r in rows)


def phase_decode_full_width(model):
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, compute_dtype="float32")  # params are fp32 already
    g = torch.Generator(device="cuda").manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size, (1, 108), generator=g, device="cuda")
    V = cfg.vocab_size  # the padded entries are -1e9 on every path and would swamp the norm
    with torch.no_grad():
        full = model(toks)[0][..., :V]
    last, cache = model.prefill(toks[:, :100])
    rels = [_rel(last[..., :V], full[:, 99])]
    for t in range(100, 108):
        logits, cache = model.decode_step(cache, toks[:, t], torch.tensor([t], device="cuda"))
        rels.append(_rel(logits[..., :V], full[:, t]))
    model.cfg = cfg
    check(max(rels) <= DECODE_FP32_REL, f"fp32 decode vs forward logits rel L2 {rels}")
    emit({"phase": "decode_full_width", "config": "mamba2-130m", "dtype": "float32, TF32 off",
          "prefill_len": 100, "decode_steps": 8, "logits_rel_l2": rels, "tolerance": DECODE_FP32_REL})


def _sdpa_heads(q, k, v):
    """q, k, v as SDPA takes them, (B, H, S, D) contiguous, K and V expanded
    to q's heads outside any timed call where the kernel reads them in place
    (GQA, MQA)."""
    G = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if G > 1:
        kh, vh = (t.repeat_interleave(G, dim=1) for t in (kh, vh))
    return qh, kh, vh


def _sdpa_backward_fns(q, k, v, do, **mask):
    """SDPA's backward (which the port never calls) on the (B, S, H, D)
    inputs, causal unless ``mask`` gives SDPA's own mask arguments
    (``is_causal``, a boolean ``attn_mask``), as three functions for
    ``time_interleaved``: its forward and backward together
    (``library_fwd_bwd``) and its forward alone (``library_fwd``), both
    replayed from a CUDA graph, so that their difference is the backward's
    device time; and the backward alone on a forward kept from outside
    (``library_eager``), which a graph cannot capture and which runs
    eagerly, host time and all.  The captured ones make their leaves inside
    the call, so that autograd runs on the capturing stream."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = mask or {"is_causal": True}
    qh, kh, vh = _sdpa_heads(q, k, v)
    doh = do.transpose(1, 2).contiguous()

    def leaves():
        return [t.detach().requires_grad_() for t in (qh, kh, vh)]

    def fwd_bwd():
        x = leaves()
        return torch.autograd.grad(sdpa(*x, **mask), x, doh)

    kept = leaves()
    oh = sdpa(*kept, **mask)
    return {"library_fwd_bwd": fwd_bwd, "library_fwd": lambda: sdpa(*leaves(), **mask),
            "library_eager": lambda: torch.autograd.grad(oh, kept, doh, retain_graph=True)}


def _sdpa_backward_ms(ms):
    """SDPA's backward ms from ``_sdpa_backward_fns``' readings: graph-replayed
    (forward and backward less the forward) and eager."""
    return {"library_ms": ms["library_fwd_bwd"]["median"] - ms["library_fwd"]["median"],
            "library_eager_ms": ms["library_eager"]["median"],
            "library_fwd_bwd_ms": ms["library_fwd_bwd"]["median"], "library_fwd_ms": ms["library_fwd"]["median"]}


def _bwd_timing(smi, shape, seed, by_kernel=False):
    """The bf16 backward at ``shape`` = (B, S, H, D), Hq = Hkv, causal: the
    tensor-core kernel and the SIMT one (``route="simt"``) held against the
    plain FA-2 backward, then timed beside it, its bound and SDPA's backward
    (graph-replayed and eager); with ``by_kernel`` also the device time of
    each route's three kernels over 10 calls."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_backward_ref

    B, S, H, D = shape
    check(fa.select_bwd_route(torch.bfloat16, D) == "wgmma", f"bf16 at head dim {D} takes the tensor-core backward")
    q, k, v, do = (randn((B, S, H, D), torch.bfloat16, seed + j) for j in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    want = flash_backward_ref(q, k, v, o, lse, do, causal=True)
    g = _grads_close(fa.flash_attention_backward(q, k, v, o, lse, do, causal=True), want)
    check(all(r["ok"] for r in g.values()), f"backward kernel disagrees at {shape}: {g}")
    simt = _grads_close(fa.flash_attention_backward(q, k, v, o, lse, do, causal=True, route="simt"), want)
    check(all(r["ok"] for r in simt.values()), f"SIMT backward kernel disagrees at {shape}: {simt}")
    del want
    ms = time_interleaved({
        "kernel": lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True),
        "simt": lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True, route="simt"),
        "plain": lambda: flash_backward_ref(q, k, v, o, lse, do, causal=True),
        **_sdpa_backward_fns(q, k, v, do),
    }, eager=("library_eager",))
    flops = fa.flash_flops(B, S, S, H, D, causal=True, backward=True)
    nbytes = fa.flash_bytes(B, S, S, H, H, D, 2, backward=True)
    bound_ms, bound_by = _bound(flops, nbytes, smi)
    timing = {"kernel_ms": ms["kernel"]["median"], "simt_ms": ms["simt"]["median"], "plain_ms": ms["plain"]["median"],
              **_sdpa_backward_ms(ms), "bound_ms": bound_ms, "bound_by": bound_by,
              "flops": flops, "bytes": nbytes, "kernel_tflops": flops / (ms["kernel"]["median"] * 1e-3) / 1e12,
              "simt_tflops": flops / (ms["simt"]["median"] * 1e-3) / 1e12,
              "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()}}
    if by_kernel:
        timing["device_us_by_kernel_10_calls"] = {
            route: device_breakdown(
                lambda route=route: [fa.flash_attention_backward(q, k, v, o, lse, do, causal=True, route=route)
                                     for _ in range(10)])
            for route in ("wgmma", "simt")
        }
        for route, by_kernel in timing["device_us_by_kernel_10_calls"].items():
            check(len(by_kernel) == fa.BWD_LAUNCHES,
                  f"a {route} backward call launched {sorted(by_kernel)}, not {fa.BWD_LAUNCHES} kernels")
    return g, simt, timing


def phase_flash_bwd_kernel(smi: str):
    """The tensor-core backward held against the plain FA-2 backward at
    BWD_EDGES (head dim 256 and MQA among them), then at BWD_TIMED and at
    gemma-7b's GEMMA_BWD_TIMED and GEMMA_BWD_SHORT, with the SIMT backward
    (``route="simt"``), and timed there beside its bound, the plain
    backward, the SIMT backward and SDPA's backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_backward_ref

    checks = {}
    for i, (B, Sq, Sk, Hq, Hkv, D, causal) in enumerate(BWD_EDGES):
        check(fa.select_bwd_route(torch.bfloat16, D) == "wgmma", f"bf16 at head dim {D} takes the tensor-core backward")
        q, do = (randn((B, Sq, Hq, D), torch.bfloat16, 500 + 10 * i + j) for j in range(2))
        k, v = (randn((B, Sk, Hkv, D), torch.bfloat16, 502 + 10 * i + j) for j in range(2))
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        g = _grads_close(fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal),
                         flash_backward_ref(q, k, v, o, lse, do, causal=causal))
        checks[f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} causal={causal}"] = g
        check(all(r["ok"] for r in g.values()), f"backward kernel disagrees at {(B, Sq, Sk, Hq, Hkv, D, causal)}: {g}")
    g, simt, timing = _bwd_timing(smi, BWD_TIMED, 400, by_kernel=True)
    d256 = {}
    for shape, seed in ((GEMMA_BWD_TIMED, 420), (GEMMA_BWD_SHORT, 440)):
        B, S, H, D = shape
        dg, dsimt, dt = _bwd_timing(smi, shape, seed, by_kernel=shape == GEMMA_BWD_TIMED)
        d256[f"B={B} S={S} Hq=Hkv={H} D={D} bf16 causal"] = {"check": dg, "simt_check": dsimt, "timing": dt}
    B, S, H, D = BWD_TIMED
    emit({"phase": "flash_bwd_kernel", "name": "flash_attention_backward",
          "shape": f"B={B} S={S} Hq=Hkv={H} D={D} bf16 causal", "route": fa.select_bwd_route(torch.bfloat16, D),
          "check": g, "simt_check": simt, "edge_checks": checks, "timing": timing, "d256": d256,
          "launches_per_call": fa.BWD_LAUNCHES, "bf16_terms": {"p": fa.BWD_P_TERMS, "ds": fa.BWD_DS_TERMS},
          "timing_note": f"median of {ROUNDS} readings of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) calls; kernel, "
                         "SIMT kernel and plain replayed from a CUDA graph; SDPA's backward graph-replayed as its "
                         "forward and backward less its forward (library_ms), and eagerly (library_eager_ms: "
                         "autograd.grad, retain_graph)"})
    fa.flash_attention.launches = fa.flash_attention_backward.launches = 0
    errs = [r["max_abs_err"] for c in (g, *checks.values(), *(x["check"] for x in d256.values()))
            for r in c.values()]
    return timing, {name: x["timing"] for name, x in d256.items()}, max(errs)


def phase_mla_bwd_kernel(smi: str, sass):
    """The backward at MLA's (q/k 192, v 128): bf16 on the tensor-core kernel
    (two warpgroups a dK/dV block, split by output) and fp32 on the SIMT one
    (32-row tiles) against the plain FA-2 backward at MLA_BWD_EDGES and on
    strided views of one wider projection, then at MLA_BWD_TIMED (B = 1, 16
    heads, causal), timed there: the bf16 kernel beside SDPA's backward at
    the same pair (graph-replayed and eager; its backend named by the
    kernels it launches), the SIMT kernel on fp32 and the plain version,
    each beside its bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_backward_ref

    H, DQK, DV = MLA_HEADS, MLA_DQK, MLA_DV
    routes = {str(dt): fa.select_bwd_route(dt, DQK, DV) for dt in (torch.bfloat16, torch.float32)}
    check(routes == {"torch.bfloat16": "wgmma", "torch.float32": "simt"}, f"(192, 128) backward routes {routes}")

    def inputs(B, Sq, Sk, Hq, Hkv, causal, dtype, seed, views=False):
        if views:  # q, k and v heads side by side in one projection, 64 columns to spare
            wide = randn((B, Sq, Hq * DQK + Hkv * (DQK + DV) + 64), dtype, seed)
            q = wide[..., :Hq * DQK].unflatten(-1, (Hq, DQK))
            k = wide[..., Hq * DQK:(Hq + Hkv) * DQK].unflatten(-1, (Hkv, DQK))
            v = wide[..., (Hq + Hkv) * DQK:(Hq + Hkv) * DQK + Hkv * DV].unflatten(-1, (Hkv, DV))
        else:
            q, k, v = (randn((B, Sq, Hq, DQK), dtype, seed), randn((B, Sk, Hkv, DQK), dtype, seed + 1),
                       randn((B, Sk, Hkv, DV), dtype, seed + 2))
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        return q, k, v, o, lse, randn(tuple(o.shape), dtype, seed + 3)

    def held(args, causal, dtype, what):
        got = fa.flash_attention_backward(*args, causal=causal)
        want = flash_backward_ref(*args, causal=causal)
        torch.cuda.synchronize()
        check([tuple(g.shape) for g in got] == [tuple(w.shape) for w in want] and got[2].shape[-1] == DV,
              f"(192, 128) gradient shapes {[tuple(g.shape) for g in got]} at {what}")
        g = _grads_close(got, want, BWD_ZERO_ATOL, fp32=dtype == torch.float32)
        check(all(r["ok"] for r in g.values()), f"(192, 128) {dtype} backward disagrees with plain at {what}: {g}")
        return g

    edges = {}
    for i, shape in enumerate(MLA_BWD_EDGES):
        for dtype in (torch.bfloat16, torch.float32):
            what = "B={} Sq={} Sk={} Hq={} Hkv={} causal={}".format(*shape)
            edges.setdefault(what, {})[str(dtype)] = held(inputs(*shape, dtype, 1400 + 10 * i), shape[-1], dtype, what)
    B, S, Hq, Hkv = MLA_BWD_VIEWS
    for dtype in (torch.bfloat16, torch.float32):
        args = inputs(B, S, S, Hq, Hkv, True, dtype, 1490, views=True)
        check(not args[0].is_contiguous() and args[0].stride(-1) == 1, "strided views")
        edges.setdefault(f"B={B} S={S} Hq={Hq} Hkv={Hkv} causal, views of one projection", {})[str(dtype)] = held(
            args, True, dtype, "views")

    rows = {}
    for i, S in enumerate(MLA_BWD_TIMED):
        args = inputs(1, S, S, H, H, True, torch.bfloat16, 1500 + 10 * i)
        fargs = inputs(1, S, S, H, H, True, torch.float32, 1500 + 10 * i)  # the same values before bf16 rounding
        check_bf16, check_fp32 = held(args, True, torch.bfloat16, f"S={S}"), held(fargs, True, torch.float32, f"S={S}")
        q, k, v, o, lse, do = args
        sdpa = _sdpa_backward_fns(q, k, v, do)
        sdpa_fp32 = _sdpa_backward_fns(*fargs[:3], fargs[5])
        ms = time_interleaved({
            "kernel": lambda: fa.flash_attention_backward(*args, causal=True),
            "simt": lambda: fa.flash_attention_backward(*fargs, causal=True),
            "plain": lambda: flash_backward_ref(*args, causal=True),
            "plain_fp32": lambda: flash_backward_ref(*fargs, causal=True),
            **sdpa, **{f"{name}_fp32": fn for name, fn in sdpa_fp32.items()},
        }, eager=("library_eager", "library_eager_fp32"))
        flops = fa.flash_flops(1, S, S, H, DQK, causal=True, backward=True, v_head_dim=DV)
        bound_ms, bound_by = _bound(flops, fa.flash_bytes(1, S, S, H, H, DQK, 2, backward=True, v_head_dim=DV), smi)
        simt_bound_ms, simt_bound_by = _bound(flops, fa.flash_bytes(1, S, S, H, H, DQK, 4, backward=True,
                                                                    v_head_dim=DV), smi, fp32=True)
        fp32_sdpa = _sdpa_backward_ms({name[:-5]: m for name, m in ms.items() if name.endswith("_fp32")})
        row = {"kernel_ms": ms["kernel"]["median"], "simt_fp32_ms": ms["simt"]["median"],
               "plain_ms": ms["plain"]["median"], "plain_fp32_ms": ms["plain_fp32"]["median"],
               **_sdpa_backward_ms(ms), **{f"{name}_fp32": t for name, t in fp32_sdpa.items()}, "bound_ms": bound_ms,
               "bound_by": bound_by, "simt_fp32_bound_ms": simt_bound_ms, "simt_fp32_bound_by": simt_bound_by,
               "flops": flops, "kernel_tflops": flops / (ms["kernel"]["median"] * 1e-3) / 1e12,
               "simt_fp32_tflops": flops / (ms["simt"]["median"] * 1e-3) / 1e12,
               "check": check_bf16, "simt_fp32_check": check_fp32,
               "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()}}
        if i == 0:
            # which SDPA backend takes (192, 128) backward: the kernels its forward and backward launch
            row["sdpa_kernels"] = sorted(device_breakdown(sdpa["library_fwd_bwd"]))
            row["device_us_by_kernel_10_calls"] = {
                route: device_breakdown(lambda a=a: [fa.flash_attention_backward(*a, causal=True) for _ in range(10)])
                for route, a in (("wgmma", args), ("simt", fargs))}
            for route, by_kernel in row["device_us_by_kernel_10_calls"].items():
                check(len(by_kernel) == fa.BWD_LAUNCHES,
                      f"a {route} (192, 128) backward call launched {sorted(by_kernel)}, not {fa.BWD_LAUNCHES} kernels")
        rows[str(S)] = row
        del args, fargs, sdpa, sdpa_fp32
    bwd_sass = {name: c for name, c in sass.items() if name.endswith(_dims_label(DQK, DV))}
    check(len(bwd_sass) == 2, f"the (192, 128) dK/dV and dQ kernels in the SASS: {sorted(bwd_sass)}")
    line = {"phase": "mla_bwd_kernel", "name": "flash_attention_backward",
            "shape": f"B=1 Hq=Hkv={H} Dqk={DQK} Dv={DV} causal, scale {DQK}^-0.5; bf16 route wgmma, fp32 route simt",
            "routes": routes, "edge_checks": edges, "timing": rows, "sass": bwd_sass,
            "max_abs_err": {dt: max([e[dt][n]["max_abs_err"] for e in edges.values() for n in e[dt]]
                                    + [r[c][n]["max_abs_err"] for r in rows.values()
                                       for c in (("check",) if dt == "torch.bfloat16" else ("simt_fp32_check",))
                                       for n in r[c]])
                            for dt in ("torch.bfloat16", "torch.float32")},
            "tolerances": {"bfloat16": {"rtol": BWD_RTOL, "atol_of_max": BWD_ATOL_OF_MAX}, "float32": BWD_FP32_TOL},
            "bf16_terms": {"p": fa.BWD_P_TERMS, "ds": fa.BWD_DS_TERMS},
            "timing_note": f"median of {ROUNDS} readings of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) calls; the "
                           "bf16 kernel, the SIMT kernel on fp32 inputs and the plain version (bf16; plain_fp32_ms "
                           "on the fp32 inputs) replayed from a CUDA graph; SDPA's backward (same pair; bf16, and "
                           "fp32 as *_fp32) graph-replayed as its forward and backward less its forward "
                           "(library_ms), and eagerly (library_eager_ms); bound_ms at the bf16 peak, "
                           "simt_fp32_bound_ms at the fp32 one with 4-byte elements"}
    emit(line)
    fa.flash_attention.launches = fa.flash_attention_backward.launches = 0
    return line


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def phase_routes(smi: str, served_lens):
    """The kernels' routes off the bf16 main path, each checked against and
    timed beside its plain version, its bound and the PyTorch call that
    computes the same function: the fp32 flash forward (SIMT; at every head
    dim, causal and not, GQA and MQA, with its lse; timed at FP32_FWD_TIMED:
    32 heads of 128, 64 and 32 at S = 512, gemma-7b's 16 heads of 256 at
    the longest served prompt and dense_parity's attention, beside SDPA in
    fp32) and backward (SIMT; fp32 is dense_parity's type;
    beside SDPA's fp32 backward, graph-replayed and eager), the fp32 SSD
    scan (SIMT; at SSD_SHAPES and the full width with and without h0; timed
    at SSD_TIMED with its three kernels' device time) and the fold kernel
    behind ``running_sum`` (the compiled sweep's).  bf16 at head dim 256
    backward runs the tensor-core kernel and is timed in flash_bwd_kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_scatter as ss
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import attention_lse_ref, flash_backward_ref, running_sum_ref, ssd_ref

    rows = {}

    def row(name, shape, fns, flops, nbytes, fp32, eager=()):
        ms = time_interleaved(fns, eager=eager)
        bound_ms, bound_by = _bound(flops, nbytes, smi, fp32=fp32)
        times = _sdpa_backward_ms(ms) if "library_fwd_bwd" in ms else {f"{k}_ms": m["median"] for k, m in ms.items()}
        rows[name] = {"shape": shape, "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"],
                      "library_ms": None, **times, "bound_ms": bound_ms, "bound_by": bound_by,
                      "spread_ms": {k: [m["min"], m["max"]] for k, m in ms.items()}}

    # fp32 forward: every head dim, causal and not, GQA and MQA, against the plain version; then timed at
    # FP32_FWD_TIMED
    fwd_err = 0.0
    for i, (B, S, Hq, Hkv, D) in enumerate(FP32_FWD_SHAPES):
        check(fa.select_route(torch.float32, D) == "simt", f"fp32 at head dim {D} takes the SIMT forward")
        q, k, v = (randn(sh, torch.float32, 640 + 4 * i + j) for j, sh in
                   enumerate(((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))))
        for causal in (True, False):
            out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
            want = ops.flash_attention(q, k, v, causal=causal, impl="plain")
            torch.cuda.synchronize()
            fwd_err = max(fwd_err, (out - want).abs().max().item())
            check(torch.allclose(out, want, **FP32_TOL), f"fp32 forward disagrees at {(B, S, Hq, Hkv, D)} causal={causal}")
            check(torch.allclose(lse, attention_lse_ref(q, k, v, causal=causal), **LSE_TOL),
                  f"fp32 forward lse disagrees at {(B, S, Hq, Hkv, D)} causal={causal}")
    for name, (B, S, H, D) in FP32_FWD_TIMED.items():
        S = S or max(served_lens)
        q, k, v = (randn((B, S, H, D), torch.float32, 600 + j) for j in range(3))
        check(torch.allclose(fa.flash_attention(q, k, v), ops.flash_attention(q, k, v, impl="plain"), **FP32_TOL),
              f"fp32 forward disagrees at {(B, S, H, D)}")
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row(name, f"B={B} S={S} Hq=Hkv={H} D={D} fp32 causal",
            {"kernel": lambda: fa.flash_attention(q, k, v, causal=True),
             "plain": lambda: ops.flash_attention(q, k, v, causal=True, impl="plain"),
             "library": lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True)},
            fa.flash_flops(B, S, S, H, D, causal=True), fa.flash_bytes(B, S, S, H, H, D, 4), fp32=True)
    rows["flash_forward_fp32"]["max_abs_err"] = fwd_err
    del q, k, v, qh, kh, vh

    # fp32 backward at BWD_TIMED
    B, S, H, D = BWD_TIMED
    check(fa.select_bwd_route(torch.float32, D) == "simt", "fp32 takes the SIMT backward")
    q, k, v, do = (randn((B, S, H, D), torch.float32, 610 + j) for j in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    want = flash_backward_ref(q, k, v, o, lse, do, causal=True)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
    g = _grads_close(got, want)
    check(all(r["ok"] for r in g.values()), f"fp32 backward disagrees: {g}")
    fp32_err = max(r["max_abs_err"] for r in g.values())
    fp32_ok = all(torch.allclose(x, w, **BWD_FP32_TOL) for x, w in zip(got, want))
    check(fp32_ok, f"fp32 backward outside {BWD_FP32_TOL}: {g}")
    del want, got
    row("flash_backward_fp32", f"B={B} S={S} Hq=Hkv={H} D={D} float32 causal",
        {"kernel": lambda: fa.flash_attention_backward(q, k, v, o, lse, do, causal=True),
         "plain": lambda: flash_backward_ref(q, k, v, o, lse, do, causal=True),
         **_sdpa_backward_fns(q, k, v, do)},
        fa.flash_flops(B, S, S, H, D, causal=True, backward=True),
        fa.flash_bytes(B, S, S, H, H, D, 4, backward=True), fp32=True, eager=("library_eager",))
    rows["flash_backward_fp32"].update(
        max_abs_err=fp32_err, tolerance=BWD_FP32_TOL,
        device_us_by_kernel_10_calls=device_breakdown(
            lambda: [fa.flash_attention_backward(q, k, v, o, lse, do, causal=True) for _ in range(10)]))
    del q, k, v, do, o, lse

    # fp32 SSD: SSD_SHAPES and the full width (with and without h0) against the sequential scan; then timed at
    # the training microbatch (B=4, S=256) and at train_4k's length (B=1, S=4096), with its kernels' device time
    H, P, N, G = SSD_WIDTH
    check(sk.select_route(torch.float32) == "simt", "fp32 takes the SIMT SSD kernel")
    ssd_err = 0.0
    for i, shape in enumerate([*SSD_SHAPES, (4, 256, H, P, N, G), (1, 1000, H, P, N, G)]):
        for with_h0 in (False, True):
            x, dt, A, Bm, Cm, Dm, h0 = _ssd_inputs(*shape, torch.float32, 630 + i, with_h0)
            y, h = sk.ssd_scan(x, dt, A, Bm, Cm, Dm, h0, chunk=32)
            want_y, want_h = ssd_ref(x, dt, A, Bm, Cm, Dm, h0, return_state=True)
            torch.cuda.synchronize()
            ssd_err = max(ssd_err, (y - want_y).abs().max().item(), (h - want_h).abs().max().item())
            check(torch.allclose(y, want_y, **SSD_FP32_TOL) and torch.allclose(h, want_h, **SSD_FP32_TOL),
                  f"fp32 SSD disagrees with ssd_ref at {shape} h0={with_h0}")
    for B, S in SSD_TIMED:
        name = "ssd_scan_fp32" if (B, S) == SSD_TIMED[0] else f"ssd_scan_fp32_B{B}_S{S}"
        x, dt, A, Bm, Cm, Dm, _ = _ssd_inputs(B, S, H, P, N, G, torch.float32, 620 + S)
        y, h = sk.ssd_scan(x, dt, A, Bm, Cm, Dm, chunk=256)
        yr, hr = ops.ssd_scan(x, dt, A, Bm, Cm, Dm, chunk=256, impl="plain")
        check(torch.allclose(y, yr, **SSD_FP32_TOL) and torch.allclose(h, hr, **SSD_FP32_TOL),
              f"fp32 SSD disagrees with the plain form at B={B} S={S}")
        row(name, f"B={B} S={S} H={H} P={P} N={N} G={G} fp32",
            {"kernel": lambda: sk.ssd_scan(x, dt, A, Bm, Cm, Dm, chunk=256),
             "plain": lambda: ops.ssd_scan(x, dt, A, Bm, Cm, Dm, chunk=256, impl="plain")},
            sk.ssd_flops(B, S, H, P, N, G), sk.ssd_bytes(B, S, H, P, N, G, 4), fp32=True)
        by_kernel = rows[name]["device_us_by_kernel"] = device_breakdown(
            lambda: sk.ssd_scan(x, dt, A, Bm, Cm, Dm, chunk=256))
        check(len(by_kernel) == sk.KERNELS_PER_CALL,
              f"an fp32 SSD call launched {sorted(by_kernel)}, not {sk.KERNELS_PER_CALL} kernels")
        rows[name]["kernels_per_call"] = len(by_kernel)
    rows["ssd_scan_fp32"].update(max_abs_err=ssd_err, tolerance=SSD_FP32_TOL)
    del x, dt, A, Bm, Cm, Dm, y, h, yr, hr

    # the fold at a 2-d shape phase_segment_kernel checks bit for bit; the plain fold launches two
    # ops a row, so it runs eagerly
    vals = torch.from_numpy(np.random.default_rng(0).standard_normal((300, 9))).cuda()
    check(torch.equal(ss.running_sum(vals), running_sum_ref(vals)), "fold kernel differs")
    # "empty": a kernel that does nothing (a spin of 0 cycles), the floor of one launch beside the byte bound
    row("running_sum_fold", "(300, 9) float64",
        {"kernel": lambda: ss.running_sum(vals), "plain": lambda: running_sum_ref(vals),
         "library": lambda: torch.cumsum(vals, 0), "empty": lambda: torch.cuda._sleep(0)},
        vals.numel(), 2 * 8 * vals.numel(), fp32=True, eager=("plain",))
    emit({"phase": "routes", "rows": rows,
          "bound_note": "fp32 FLOPs over the fp32 rate outside the tensor cores (67 TFLOP/s SXM), bf16 over 989; "
                        "bytes over 3.35 TB/s; the fold counts one add a value",
          "timing_note": f"median of {ROUNDS} readings of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) calls; SDPA's "
                         "backward graph-replayed as its forward and backward less its forward (library_ms) and "
                         "eagerly (library_eager_ms)"})
    fa.flash_attention.launches = fa.flash_attention_backward.launches = 0
    sk.ssd_scan.launches = ss.running_sum.launches = 0
    return rows


def _step1_gaps(metrics, model, opt, want):
    """A first train step against the CPU's (``want``: its metrics, first
    moments and parameters after the step, and the start): the relative
    gaps of loss and grad norm, and the largest per-leaf relative L2 gap of
    the gradient (AdamW's first moment) and of the parameter change."""
    params = dict(model.named_parameters())
    return {
        "loss": abs(float(metrics["loss"]) / want["loss"] - 1),
        "grad_norm": abs(float(metrics["grad_norm"]) / want["grad_norm"] - 1),
        "grad": max(_rel(opt["m"][n].cpu(), m) for n, m in want["m"].items()),
        "change": max(_rel(params[n].detach().cpu() - x0, want["params"][n] - x0) for n, x0 in want["start"].items()),
    }


def _step1_ok(g, gnorm_rtol=DENSE_STEP1_RTOL) -> bool:
    return (g["loss"] <= DENSE_STEP1_RTOL and g["grad_norm"] <= gnorm_rtol
            and g["grad"] <= DENSE_GRAD_REL and g["change"] <= DENSE_STEP1_CHANGE_REL)


def _train_parity(cfg, route_trace=False, data=None):
    """``cfg`` (an fp32 smoke config) trained 3 steps on the CPU and on the
    card from the same weights, then one card step with the plain attention
    and one each with the backward kernel's gradients zeroed and negated.
    Returns the per-step (card, CPU) loss and grad norm, the first step's
    gaps (``_step1_gaps``), the plain attention's and the controls', the largest per-leaf gap of the changes over three steps,
    the three card steps' flash launches (forward, backward), the train
    config and, with ``route_trace``, each step's router calls on each
    device: (expert indices, the smallest gap of the top-(k+1) probabilities)
    per token.  ``data`` adds ``DataConfig`` fields (an enc-dec config's
    ``enc_len``, a VLM's ``vision_tokens``, with ``d_model``)."""
    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import ScheduleConfig, adamw_init
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    tcfg = TrainConfig(schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10), microbatches=2)
    cpu_model, cpu_opt = init_train_state(cfg, tcfg, device="cpu")
    start_model = copy.deepcopy(cpu_model)
    start = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}

    def card_run():
        model = copy.deepcopy(start_model).to("cuda")
        return model, adamw_init(dict(model.named_parameters())), make_train_step(model, tcfg)

    gpu_model, gpu_opt, gpu_step = card_run()
    it = make_train_iter(DataConfig(global_batch=4, seq_len=64, vocab_size=cfg.vocab_size, seed=5, **(data or {})))
    batches = [next(it) for _ in range(3)]
    it.close()
    cpu_step = make_train_step(cpu_model, tcfg)
    routes = {"cpu": [], "cuda": []}
    real_router = moe_mod.router_topk

    def traced(params, x, moe):  # records into routes[dev][-1]
        w, idx, aux = real_router(params, x, moe)
        more = dataclasses.replace(moe, top_k=min(moe.top_k + 1, moe.n_experts), router_scale=False)
        top = real_router(params, x, more)[0].detach().float()
        routes[x.device.type][-1].append((idx.cpu(), (top[..., :-1] - top[..., 1:]).min(-1).values.cpu()))
        return w, idx, aux

    before = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
    rows, step1 = [], None
    if route_trace:
        moe_mod.router_topk = traced
    try:
        for i, b in enumerate(batches):
            routes["cpu"].append([])
            routes["cuda"].append([])
            cpu_opt, cm = cpu_step(cpu_opt, b)
            gpu_opt, gm = gpu_step(gpu_opt, b)
            rows.append({k: (float(gm[k]), float(cm[k])) for k in ("loss", "grad_norm", "aux")})
            if i == 0:
                want = {"loss": float(cm["loss"]), "grad_norm": float(cm["grad_norm"]), "start": start,
                        "m": {n: m.clone() for n, m in cpu_opt["m"].items()},
                        "params": {n: p.detach().clone() for n, p in cpu_model.named_parameters()}}
                step1 = _step1_gaps(gm, gpu_model, gpu_opt, want)
    finally:
        moe_mod.router_topk = real_router
    launches = (fa.flash_attention.launches - before[0], fa.flash_attention_backward.launches - before[1])
    cpu_params = dict(cpu_model.named_parameters())
    change = max(_rel(p.detach().cpu() - start[n], cpu_params[n].detach() - start[n])
                 for n, p in gpu_model.named_parameters())

    # the same first step with the plain attention on the card: the attention kernels' share of the gap
    flash = ops.flash_attention
    model, opt, step = card_run()
    ops.flash_attention = lambda *a, **kw: flash(*a, **{**kw, "impl": "plain"})
    try:
        opt, m = step(opt, batches[0])
    finally:
        ops.flash_attention = flash
    plain = _step1_gaps(m, model, opt, want)
    del model, opt, step

    # the control: the same first step with the backward kernel's gradients scaled
    backward, controls = ops.flash_attention_backward, {}
    for label, factor in (("zeroed", 0.0), ("negated", -1.0)):
        model, opt, step = card_run()
        ops.flash_attention_backward = lambda *a, f=factor, **kw: tuple(f * t for t in backward(*a, **kw))
        try:
            opt, m = step(opt, batches[0])
        finally:
            ops.flash_attention_backward = backward
        controls[label] = _step1_gaps(m, model, opt, want)
        del model, opt, step
    return rows, step1, plain, controls, change, launches, tcfg, (routes if route_trace else None)


def _parity_line(phase, config, rows, step1, plain, change, controls, launches, **extra):
    return {"phase": phase, "config": config, "dtype": "float32, TF32 off",
            "steps": [{k: {"card": v[0], "cpu": v[1]} for k, v in r.items()} for r in rows],
            "step1_gaps": step1, "change_rel_over_3_steps": change,
            "plain_attention_step1_gaps": plain, "control_step1_gaps": controls,
            "flash_launches": {"forward": launches[0], "backward": launches[1]}, **extra}


def phase_dense_parity():
    """The deepseek-7b smoke config (fp32, head dim 32: the SIMT kernels
    forward and backward) trained 3 steps on the card and on the CPU from the
    same weights; then the control: one card step with the backward
    kernel's gradients zeroed, and one with them negated, must fail the
    first step's checks."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("deepseek-7b")
    check(cfg.compute_dtype == "float32" and cfg.remat == "none", "deepseek-7b smoke is fp32 without remat")
    rows, step1, plain, controls, change, launches, tcfg, _ = _train_parity(cfg)
    emit(_parity_line("dense_parity", "deepseek-7b SMOKE", rows, step1, plain, change, controls, launches,
                      tolerances={"step1_rtol": DENSE_STEP1_RTOL, "step1_grad_rel": DENSE_GRAD_REL,
                                  "step1_change_rel": DENSE_STEP1_CHANGE_REL, "loss_rtol": DENSE_LOSS_RTOL,
                                  "grad_norm_rtol": DENSE_GNORM_RTOL, "change_rel": DENSE_CHANGE_REL}))
    check(_step1_ok(step1), f"step 1 card vs CPU: {step1}")
    for i, r in enumerate(rows[1:], start=1):
        (gl, cl), (gg, cg) = r["loss"], r["grad_norm"]
        check(abs(gl - cl) <= DENSE_LOSS_RTOL * abs(cl), f"step {i}: loss card {gl} vs CPU {cl}")
        check(abs(gg - cg) <= DENSE_GNORM_RTOL * abs(cg), f"step {i}: grad norm card {gg} vs CPU {cg}")
    check(change <= DENSE_CHANGE_REL, f"parameter changes over three steps, card vs CPU: {change}")
    for label, g in controls.items():
        check(not _step1_ok(g), f"the {label} control passes the first step's checks: {g}")
    # no remat: one forward and one backward per layer and microbatch
    want_launches = len(rows) * tcfg.microbatches * cfg.n_layers
    check(launches == (want_launches, want_launches),
          f"flash launches in 3 smoke steps: {launches}, want {want_launches} each")


def phase_moe_train_parity():
    """deepseek-v2-lite's smoke config at deepseek-v2's published MLA head
    dims (q/k 128 + 64, v 128; fp32: the SIMT flash kernels forward and
    backward at (192, 128)) trained 3 steps on the card and on the CPU from
    the same weights.  Step 1's experts first, call by call (a token routed
    to other experts must be a top-k tie, TIE_EPS), then step 1 held to
    dense_parity's tolerances (the grad norm to MOE_STEP1_GNORM_RTOL), its
    gaps with the plain attention on the card printed beside; the later
    steps are printed with the tokens each routed differently, not held (see
    MOE_STEP1_GNORM_RTOL); then the control: one card step with the backward
    kernel's gradients zeroed, and one with them negated, must fail the
    first step's checks."""
    from repro_torch.configs import MLAConfig, get_smoke_config
    from repro_torch.kernels import flash_attention as fa

    published = MLAConfig(kv_lora_rank=32, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"), mla=published)
    check(cfg.compute_dtype == "float32" and cfg.remat == "none" and cfg.moe is not None,
          "deepseek-v2-lite smoke is fp32 MoE without remat")
    check(fa.select_bwd_route(torch.float32, MLA_DQK, MLA_DV) == "simt", "fp32 (192, 128) takes the SIMT backward")
    rows, step1, plain, controls, change, launches, tcfg, routes = _train_parity(cfg, route_trace=True)
    flipped = _routed_differently(routes)
    emit(_parity_line("moe_train_parity", "deepseek-v2-lite-16b SMOKE at the published MLA head dims", rows, step1,
                      plain, change, controls, launches, mla=dataclasses.asdict(published),
                      moe=dataclasses.asdict(cfg.moe), routed_differently=flipped, tie_eps=TIE_EPS,
                      tolerances={"step1_rtol": DENSE_STEP1_RTOL, "step1_grad_norm_rtol": MOE_STEP1_GNORM_RTOL,
                                  "step1_grad_rel": DENSE_GRAD_REL, "step1_change_rel": DENSE_STEP1_CHANGE_REL}))
    check(_step1_ok(step1, MOE_STEP1_GNORM_RTOL), f"step 1 card vs CPU: {step1}")
    check(all(np.isfinite(v) for r in rows for pair in r.values() for v in pair), f"non-finite metrics {rows}")
    for label, g in controls.items():
        check(not _step1_ok(g, MOE_STEP1_GNORM_RTOL), f"the {label} control passes the first step's checks: {g}")
    want_launches = len(rows) * tcfg.microbatches * cfg.n_layers  # every layer is MLA; no remat
    check(launches == (want_launches, want_launches),
          f"flash launches in 3 smoke steps: {launches}, want {want_launches} each")


def _routed_differently(routes):
    """Per step of ``_train_parity``'s route trace: the tokens the card and
    the CPU routed to different experts, of those routed, and their largest
    top-k margin; at step 1 (the same weights) each must be a tie (a margin
    under TIE_EPS)."""
    flipped = []
    for step, (cpu_calls, gpu_calls) in enumerate(zip(routes["cpu"], routes["cuda"])):
        check(len(cpu_calls) == len(gpu_calls) > 0, f"step {step + 1}: {len(cpu_calls)} CPU router calls, "
                                                    f"{len(gpu_calls)} on the card")
        n, margin = 0, 0.0
        for call, ((ci, cg), (gi, gg)) in enumerate(zip(cpu_calls, gpu_calls)):
            for t in torch.nonzero((ci != gi).any(-1)).flatten().tolist():
                m = max(cg[t].item(), gg[t].item())
                n, margin = n + 1, max(margin, m)
                if step == 0:
                    check(m < TIE_EPS, f"step 1, router call {call}, token {t}: experts {ci[t].tolist()} on the "
                                       f"CPU and {gi[t].tolist()} on the card with a top-k margin of {m}")
        flipped.append({"tokens": n, "routed": sum(len(c[0]) for c in cpu_calls), "max_margin": margin})
    return flipped


def _train_only(model, tcfg, batch, names, steps, grad_factor=1.0):
    """``steps`` AdamW steps (``tcfg``'s schedule and settings) on the
    parameters ``names`` alone, the rest frozen, on one repeated batch, their
    gradients scaled by ``grad_factor`` and, with ``tcfg.compress_grads``,
    then int8-compressed with error feedback as the train step compresses
    them (``ef_compress``, one scale a reference leaf): the loss before each
    step and after the last."""
    from repro_torch.configs import torch_dtype
    from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, ef_compress, ef_state_init
    from repro_torch.optim import learning_rate
    from repro_torch.train import compress_groups, make_loss_fn

    params = dict(model.named_parameters())
    leaves = {n: params[n] for n in names}
    opt = adamw_init(leaves, torch_dtype(model.cfg.opt_state_dtype))
    loss_fn, losses = make_loss_fn(model, tcfg), []
    ef = ef_state_init(leaves) if tcfg.compress_grads else None
    groups = compress_groups(model.cfg, leaves) if ef is not None else None
    for _ in range(steps):
        total, metrics = loss_fn(batch)
        grads = torch.autograd.grad(total, list(leaves.values()))
        losses.append(float(metrics["loss"].detach()))
        grads = {n: grad_factor * g.float() for n, g in zip(leaves, grads)}
        if ef is not None:
            grads = ef_compress(grads, ef, groups)[0]
        grads, _ = clip_by_global_norm(grads, tcfg.adamw.grad_clip)
        opt = adamw_update(grads, opt, leaves, learning_rate(int(opt["step"]), tcfg.schedule), tcfg.adamw)
    with torch.no_grad():
        losses.append(float(loss_fn(batch)[1]["loss"]))
    return losses


def attention_shapes(cfg, seq: int, enc_len: int = 0):
    """Each flash call of one forward pass of ``cfg`` over rows of ``seq``
    text tokens (and ``enc_len`` frame embeddings), in call order, as
    ``(Sq, Sk, causal, prefix_len)``: an enc-dec model's encoder layers
    (non-causal over the frames), then each decoder layer's causal
    self-attention and its cross-attention over the frames; a VLM's layers
    over its vision tokens and the text, with them as the prefix under
    ``prefix_lm``; any other model's attention layers, causal."""
    n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
    if cfg.encdec:
        return [(enc_len, enc_len, False, 0)] * cfg.n_enc_layers + [(seq, seq, True, 0),
                                                                    (seq, enc_len, False, 0)] * n_attn
    S = seq + cfg.vision_tokens
    return [(S, S, True, cfg.vision_tokens if cfg.prefix_lm else 0)] * n_attn


def _mask_label(Sq, Sk, causal, prefix_len) -> str:
    mask = "causal" if causal else "non-causal"
    return f"{Sq}x{Sk} {mask}" + (f" prefix {prefix_len}" if prefix_len else "")


def attention_inputs(model, loss_fn, batch):
    """Every attention call's real q, k, v, its mask and its upstream dO on
    ``batch``, captured from ``ops.flash_attention`` during one forward and
    backward of ``loss_fn`` (remat recomputes the forward and calls the op
    again, but only the first forward's outputs receive a gradient); the
    calls and their masks must be those ``attention_shapes`` gives."""
    from repro_torch.kernels import ops

    flash, calls = ops.flash_attention, []

    def capture(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        if out.requires_grad:
            rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(), "kw": kw}
            out.register_hook(lambda g, rec=rec: rec.__setitem__("do", g))
            calls.append(rec)
        return out

    ops.flash_attention = capture
    try:
        total, _ = loss_fn(batch)
        torch.autograd.grad(total, list(model.parameters()))
    finally:
        ops.flash_attention = flash
    del total
    enc = batch.get("enc_embeds")
    want = attention_shapes(model.cfg, np.asarray(batch["tokens"]).shape[1], 0 if enc is None else enc.shape[1])
    layers = [c for c in calls if "do" in c]
    check(len(layers) == len(want) and len(calls) == 2 * len(want),
          f"{len(layers)} of {len(calls)} attention calls got a gradient, want {len(want)} of {2 * len(want)}")
    for c, (Sq, Sk, causal, prefix_len) in zip(layers, want):
        got = (c["q"].shape[1], c["k"].shape[1], c["kw"].get("causal", True), c["kw"].get("prefix_len", 0))
        check(got == (Sq, Sk, causal, prefix_len) and c["do"].dtype == torch.bfloat16,
              f"an attention call at {got} in {c['do'].dtype}, want {(Sq, Sk, causal, prefix_len)} in bf16")
    return layers


def cut_config(cut: TrainCut):
    """``cut``'s config at its published widths, cut to its depth."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(cut.config), n_layers=cut.layers)


def full_width_run(cfg, steps: int, eval_every: int, *, batch: int = DENSE_BATCH, seq: int = DENSE_SEQ,
                   micro: int = DENSE_MICRO, enc_len: int = 0, compress_grads: bool = False,
                   accum_dtype: str = "float32", seed: int = 0):
    """Train ``cfg`` on the card through ``Trainer``'s entry point for
    ``steps`` steps with an eval every ``eval_every``, at the full-width
    phases' settings (``batch`` x ``seq`` in ``micro`` microbatches, with
    the data pipeline's seeded stub frame embeddings (``enc_len`` a row) or
    patch embeddings (``cfg.vision_tokens``), AdamW, peak lr DENSE_LR after
    2 warm-up steps; ``compress_grads`` and ``accum_dtype`` as
    ``TrainConfig`` takes them; ``seed`` added to the weights' seed and the
    training batches'), counting the flash launches and each
    backward call's route.  Returns the run's state and readings: the trainer, model and
    optimizer state, the history, the held-out loss on one fixed batch
    (``probe``) before and after, the flash and SSD launches, the routes,
    the peak device memory over the steps and the parameter count."""
    from types import SimpleNamespace

    from repro_torch.data import DataConfig, make_train_iter
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import TrainConfig, Trainer, make_loss_fn

    tcfg = TrainConfig(adamw=AdamWConfig(weight_decay=0.1, grad_clip=1.0),
                       schedule=ScheduleConfig(peak_lr=DENSE_LR, warmup_steps=2, decay_steps=steps),
                       microbatches=micro, compress_grads=compress_grads, accum_dtype=accum_dtype)
    tcfg = dataclasses.replace(tcfg, seed=tcfg.seed + seed)
    dcfg = DataConfig(global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                      enc_len=enc_len, vision_tokens=cfg.vision_tokens)
    train_it = make_train_iter(dataclasses.replace(dcfg, seed=dcfg.seed + seed))
    eval_it = make_train_iter(dataclasses.replace(dcfg, seed=99))
    probe_it = make_train_iter(dataclasses.replace(dcfg, seed=7))
    probe = next(probe_it)  # one fixed held-out batch
    probe_it.close()
    trainer = Trainer(cfg, tcfg, train_it, eval_iter=eval_it, eval_every=eval_every, device="cuda")
    t0 = time.perf_counter()
    model, opt = trainer.restore_or_init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held_out = make_loss_fn(model, tcfg)
    with torch.no_grad():
        before = float(held_out(probe)[1]["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the route of every backward call, as the wrapper picks it (no caller passes one); the trainer's cost
    # count runs one step on fake tensors, which launches nothing and takes no route
    backward, routes = ops.flash_attention_backward, {}

    def routed(*a, **kw):
        if not fa.is_fake(a[0]):
            route = kw.get("route") or fa.select_bwd_route(a[0].dtype, a[0].shape[-1], a[2].shape[-1])
            routes[route] = routes.get(route, 0) + 1
        return backward(*a, **kw)

    ops.flash_attention_backward = routed
    fa.flash_attention.launches = fa.flash_attention_backward.launches = sk.ssd_scan.launches = 0
    try:
        model, opt, hist = trainer.run(model, opt, steps)
        torch.cuda.synchronize()
        fwd, bwd, ssd = fa.flash_attention.launches, fa.flash_attention_backward.launches, sk.ssd_scan.launches
    finally:
        ops.flash_attention_backward = backward
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_it.close()
    eval_it.close()
    with torch.no_grad():
        after = float(held_out(probe)[1]["loss"])
    return SimpleNamespace(trainer=trainer, tcfg=tcfg, model=model, opt=opt, hist=hist, probe=probe,
                           held_out=held_out, held_out_before=before, held_out_after=after, fwd=fwd, bwd=bwd,
                           ssd=ssd, routes=routes, peak_gb=peak_gb, init_s=init_s,
                           n_params=sum(p.numel() for p in model.parameters()))


def _train_full_width(cut: TrainCut, cfg, after=None, trained=None):
    """Train ``cfg`` (``cut``'s config at its published widths, cut in depth
    only; dense, MoE with MLA, enc-dec or prefix-LM) on the card
    (``full_width_run`` at ``cut``'s batch) for ``cut.steps`` steps with an
    eval every ``cut.eval_every``, and check it: the parameter count, the
    exact forward and backward flash launches (every backward on the
    tensor-core route, at the widths ``flash_widths`` gives), the flash FLOPs
    of the step cost at each launch's own shape and mask
    (``attention_shapes``), the train and eval lanes, the held-out loss
    (``cut.held_out``), a peak under the card's 80 GB; one step traced for
    the device's idle share and time by kernel, and its flash
    launches by shape; every attention call's real q, k, v and dO through
    both flash kernels, at its own mask, against the plain versions; the
    attention-only and FFN-only checks beside their zeroed and negated
    controls (ATTN_ONLY_DROP).  ``after(model)``, where given, runs on the
    trained model before the line is printed and its dict joins the line
    under ``"after_training"``; ``trained(run)``, where given, runs right
    after the training run, before anything else touches its weights.
    Prints the phase's line and returns the launches, the largest gradient
    error and the line."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_lse_ref, flash_backward_ref
    from repro_torch.train import flash_widths, make_train_step

    from repro_torch.configs import get_config

    L, steps = cfg.n_layers, cut.steps
    _, D, Dv = flash_widths(cfg)
    check(L == cut.layers, f"{cfg.name} at {L} layers, not {cut.layers}")
    check((cfg.param_dtype, cfg.compute_dtype, cfg.opt_state_dtype)
          == ("bfloat16", "bfloat16", get_config(cut.config).opt_state_dtype) and cfg.remat in ("full", "dots"),
          f"{cfg.name}'s own dtypes (its published moment dtype) and remat")
    check(fa.select_bwd_route(torch.bfloat16, D, Dv) == "wgmma",
          f"bf16 at {_dims_label(D, Dv)} takes the tensor-core backward")
    run = full_width_run(cfg, steps, cut.eval_every, batch=cut.batch, seq=cut.seq, micro=cut.micro,
                         enc_len=cut.enc_len, compress_grads=cut.compress_grads, accum_dtype=cut.accum_dtype)
    if trained is not None:
        trained(run)
    trainer, tcfg, model, opt, hist, probe = run.trainer, run.tcfg, run.model, run.opt, run.hist, run.probe
    fwd, bwd = run.fwd, run.bwd

    losses = [h["loss"] for h in hist]
    n_evals = steps // cut.eval_every
    train, evals = trainer.stats.summary(trainer.train_stream), trainer.stats.summary(trainer.eval_stream)
    # an SSM layer runs the SSD kernel in each microbatch's forward and remat recompute, and once an eval
    n_ssm = sum(not cfg.layer_is_attn(i) for i in range(L)) if cfg.ssm is not None else 0
    want_ssd = steps * cut.micro * 2 * n_ssm + n_evals * n_ssm
    # a step: each attention call of each microbatch runs the forward kernel twice (forward, remat
    # recompute) and the backward once; an eval runs the forward once per call
    shapes = attention_shapes(cfg, cut.seq, cut.enc_len)
    A = len(shapes)
    want_fwd = steps * cut.micro * 2 * A + n_evals * A
    want_bwd = steps * cut.micro * A
    B = cut.batch // cut.micro
    want_flops = {name: cut.micro * n * sum(fa.flash_flops(B, Sq, Sk, cfg.n_heads, D, causal=causal,
                                                            backward=backward, v_head_dim=Dv, prefix_len=prefix)
                                            for Sq, Sk, causal, prefix in shapes)
                  for name, n, backward in (("flash_forward", 2, False), ("flash_backward", 1, True))}
    parts, cost = trainer.cost_parts, trainer.step_cost
    later = [  # judged after the phase's line is printed
        (all(np.isfinite(losses)) and all(np.isfinite(e["loss"]) for e in trainer.eval_history), "non-finite loss"),
        (run.n_params == cut.params, f"{run.n_params} parameters, want {cut.params}"),
        (run.peak_gb < 80, f"peak device memory {run.peak_gb} GB, not under the card's 80"),
        (train["steps"] == steps == len(hist), f"train lane steps {train['steps']}"),
        (evals["steps"] == n_evals == len(trainer.eval_history), f"eval lane steps {evals['steps']}"),
        (train["tokens"] == steps * cut.batch * cut.seq, f"train lane tokens {train['tokens']}"),
        ((fwd, bwd) == (want_fwd, want_bwd), f"flash launches {fwd}, {bwd}; want {want_fwd}, {want_bwd}"),
        (run.routes == ({"wgmma": want_bwd} if want_bwd else {}),
         f"backward calls by route {run.routes}; want {want_bwd} on wgmma"),
        (run.ssd == want_ssd, f"SSD launches {run.ssd}, want {want_ssd}"),
        (all(parts.get(name, 0.0) == float(want) for name, want in want_flops.items()),
         f"flash FLOPs in the step cost {parts}, want {want_flops}"),
        (abs(train["flops"] - steps * cost.flops) <= 1e-9 * train["flops"], "train lane FLOPs"),
        (cost.hbm_bytes > 0 and abs(train["hbm_bytes"] - steps * cost.hbm_bytes) <= 1e-9 * train["hbm_bytes"],
         f"train lane bytes {train['hbm_bytes']}"),
        (evals["flops"] == 0 and evals["hbm_bytes"] == 0, "the eval lane carries no cost"),
    ]
    if cut.held_out == "falls":
        later.append((run.held_out_after < run.held_out_before,
                      f"held-out loss does not fall: {run.held_out_before} -> {run.held_out_after}"))
    step_ms = [r.seconds * 1e3 for r in trainer.stats.records if r.stream_id == trainer.train_stream]
    steady_ms = statistics.median(step_ms[2:])

    # one step traced for the device's busy time (idle share against the unprofiled median step) and its
    # kernels, device events only (recording the host's ops too took a trace of 24,000 kernels 13.7 s, against
    # 4.5, on the H100's host), and its flash launches by shape and mask as the wrappers record them
    from torch.profiler import ProfilerActivity, profile

    step = make_train_step(model, tcfg)
    shapes_before = (fa.flash_attention.shapes.copy(), fa.flash_attention_backward.shapes.copy())
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        opt, _ = step(opt, probe)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t1
    by_shape = {direction: {f"{_mask_label(r.Sq, r.Sk, r.causal, r.prefix_len)}, B={r.B} Hq={r.Hq} Hkv={r.Hkv} "
                            f"{_dims_label(r.D, r.Dv)}": n for r, n in (now - was).items()}
                for direction, now, was in (("forward", fa.flash_attention.shapes, shapes_before[0]),
                                            ("backward", fa.flash_attention_backward.shapes, shapes_before[1]))}
    del opt, step  # the checks below keep their own optimizer states
    run.opt = None
    torch.cuda.empty_cache()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name = {}
    for e in kernels:
        name = re.sub(r"\(.*", "", e.name.replace("(anonymous namespace)::", ""))[:48]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    kernel_ms = lambda *keys: sum(ms for n, ms in by_name.items() if any(key in n for key in keys))
    named = {"fp32 GEMMs (the unembedding; the MoE router)": kernel_ms("f32f32", "sgemm"),
             "multi-tensor kernels (AdamW, gradient accumulation)": kernel_ms("multi_tensor_apply"),
             "flash kernels": kernel_ms("flash")}
    idle = {"device_busy_ms": busy_s * 1e3, "kernel_launches": len(kernels), "step_ms_median": steady_ms,
            "idle_share": max(0.0, 1.0 - busy_s * 1e3 / steady_ms) if kernels else "not measured",
            "traced_step_ms": traced_s * 1e3, "profiler_s": time.perf_counter() - t0, "device_ms_named": named,
            "device_ms_by_kernel": top,
            "flash_device_ms": {n: ms for n, ms in by_name.items() if "flash" in n}}
    del prof
    later.append((by_shape["backward"] == {k: cut.micro * n for k, n in _shape_counts(shapes, B, cfg).items()}
                  and by_shape["forward"] == {k: 2 * cut.micro * n for k, n in _shape_counts(shapes, B, cfg).items()},
                  f"one step's flash launches by shape {by_shape}"))

    micro = {k: v[: cut.batch // cut.micro] for k, v in probe.items()}
    ssm = _ssm_train_checks(model, run.held_out, micro, cut, busy_s * 1e3) if n_ssm else None
    if ssm is not None:
        later += ssm.pop("checks")
    layers = attention_inputs(model, run.held_out, micro)
    rows = []
    for c in layers:
        q, k, v, do = c["q"], c["k"], c["v"], c["do"]
        check((q.shape[-1], v.shape[-1]) == (D, Dv), f"attention at {_dims_label(q.shape[-1], v.shape[-1])}")
        mask = dict(causal=c["kw"].get("causal", True), scale=c["kw"].get("scale"),
                    prefix_len=c["kw"].get("prefix_len", 0))
        o, lse = fa.flash_attention(q, k, v, **mask, return_lse=True)
        lse_ref = attention_lse_ref(q, k, v, **mask)
        g = _grads_close(fa.flash_attention_backward(q, k, v, o, lse, do, **mask),
                         flash_backward_ref(q, k, v, o, lse, do, **mask))
        lse_max = lse_ref.abs().max().item()
        lse_ok = ((lse - lse_ref).abs() <= _lse_train_tol(lse_ref)) | (lse == lse_ref)
        g["lse"] = {"max_abs_err": (lse - lse_ref).abs().max().item(), "max_abs": lse_max, "ok": bool(lse_ok.all())}
        g["mask"] = _mask_label(q.shape[1], k.shape[1], mask["causal"], mask["prefix_len"])
        rows.append(g)
        del o, lse, lse_ref
    del layers

    # the attention-only and FFN-only checks and their controls, each from the same weights, over the
    # reference's stack (see ATTN_ONLY_DROP): the projections into q, k and v (MLA: q, the latent and rope
    # key, and the latent's expansions into K and V; enc-dec: the decoder's self- and cross-attention's,
    # not the encoder's: those move whisper's loss by +-0.05 a step with the gradient and negated alike at
    # every learning rate tried, scripts/encdec_prefix_train_checks.py attention, and its calls are held on
    # their real inputs below), the controls scaling the backward kernel's dq, dk, dv; the MLP weights (a
    # MoE layer's router, routed and shared experts; enc-dec: the encoder's too), the controls scaling their
    # gradients
    qkv = ("wq", "w_dkv", "w_uk", "w_uv") if cfg.mla is not None else ("wq", "wk", "wv")
    stack = range(cut.stack_from, L)
    params = dict(model.named_parameters())
    mixers = ("attn", "cross") if cfg.encdec else ("attn",)
    enc_layers = range(cfg.n_enc_layers if cfg.encdec else 0)
    attn_layers = [i for i in stack if cfg.layer_is_attn(i)]
    groups = {"attention_only": [f"layers.{i}.{m}.{w}" for i in attn_layers for m in mixers for w in qkv],
              "ffn_only": [n for n in params if any(n.startswith(f"layers.{i}.{m}.") for i in stack
                                                     for m in ("ffn", "moe"))
                           or any(n.startswith(f"encoder.layers.{j}.ffn.") for j in enc_layers)],
              # an SSM layer's weights (projections, conv taps, A, D, dt bias, gate norm, out): their gradients
              # come through the SSD scan's backward (autograd through the chunked form), the controls scaling them
              "ssm_only": [n for n in params if any(n.startswith(f"layers.{i}.ssm.") for i in stack)]}
    groups = {g: names for g, names in groups.items() if names}
    check(all(n in params for n in groups.get("attention_only", [])), f"every layer has attn.{', attn.'.join(qkv)}")
    check(len(groups["ffn_only"]) >= 3 * len(stack), f"the stack's MLP weights: {groups['ffn_only']}")
    check(("attention_only" in groups) == bool(attn_layers) and ("ssm_only" in groups) == bool(n_ssm),
          f"the checks {sorted(groups)} for {len(attn_layers)} attention and {n_ssm} SSM layers")
    alone_cfg = dataclasses.replace(tcfg, schedule=dataclasses.replace(tcfg.schedule, decay_steps=ATTN_ONLY_STEPS))
    backward, alone = ops.flash_attention_backward, {}
    for group, names in groups.items():
        saved, losses_by = {n: params[n].detach().clone() for n in names}, {}
        for label, factor in (("gradient", 1.0), ("zeroed", 0.0), ("negated", -1.0)):
            if group == "attention_only" and factor != 1.0:
                ops.flash_attention_backward = lambda *a, f=factor, **kw: tuple(
                    f * t for t in backward(*a, **kw))
            try:
                losses_by[label] = _train_only(model, alone_cfg, micro, names, ATTN_ONLY_STEPS,
                                               grad_factor=1.0 if group == "attention_only" else factor)
            finally:
                ops.flash_attention_backward = backward
                with torch.no_grad():
                    for n in names:
                        params[n].copy_(saved[n])
        del saved
        drops = {label: ls[0] - ls[-1] for label, ls in losses_by.items()}
        alone[group] = {"losses": losses_by, "drops": drops, "min_drop": ATTN_ONLY_DROP, "steps": ATTN_ONLY_STEPS,
                        "batch": f"the probe's first microbatch ({B} x {cut.seq}), repeated",
                        "trained": f"layers {cut.stack_from}-{L - 1}"
                                   + (f" (and encoder layers 0-{len(enc_layers) - 1})" if enc_layers and
                                      group == "ffn_only" else "")
                                   + f": {sorted({n.split('.', 2)[2] for n in names if n.startswith('layers.')})}",
                        "controls": "the backward kernel's dq, dk, dv scaled" if group == "attention_only"
                                    else "the trained weights' gradients scaled"}
        if group == "ssm_only":
            alone[group]["trained"] = f"layers {cut.stack_from}-{L - 1}: the SSM layers' weights"
        later += [
            (drops["gradient"] >= ATTN_ONLY_DROP, f"{group}: the loss fell by {drops['gradient']}, "
                                                  f"want {ATTN_ONLY_DROP}"),
            (drops["zeroed"] < ATTN_ONLY_DROP and drops["negated"] < ATTN_ONLY_DROP,
             f"{group}: a control passes the check: {drops}"),
        ]
    del params
    after_training = after(model) if after is not None else None
    if after_training is not None:
        later += after_training.pop("checks")
    line = {
        "phase": cut.phase, "config": cfg.name, "n_layers": L, "depth": cut.depth, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": D, "v_head_dim": Dv, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "hidden_act": cfg.hidden_act, "tie_embeddings": cfg.tie_embeddings,
        "scale_embedding": cfg.scale_embedding,
        "mla": dataclasses.asdict(cfg.mla) if cfg.mla is not None else None,
        "moe": dataclasses.asdict(cfg.moe) if cfg.moe is not None else None,
        "n_enc_layers": cfg.n_enc_layers if cfg.encdec else 0, "enc_len": cut.enc_len,
        "vision_tokens": cfg.vision_tokens, "prefix_lm": cfg.prefix_lm,
        "dtype": {"params": cfg.param_dtype, "compute": cfg.compute_dtype, "moments": cfg.opt_state_dtype},
        "remat": cfg.remat, "params": run.n_params, "init_s": run.init_s,
        "compress_grads": cut.compress_grads, "accum_dtype": cut.accum_dtype,
        "batch": cut.batch, "seq": cut.seq, "microbatches": cut.micro, "steps": steps,
        "peak_lr": DENSE_LR, "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
        "aux_losses": [h["aux"] for h in hist],
        "held_out_loss": {"before": run.held_out_before, "after": run.held_out_after, "held": cut.held_out},
        **alone,
        "eval_losses": [e["loss"] for e in trainer.eval_history],
        "lanes": {"train": train, "eval": evals}, "step_cost": parts, "count_s": trainer.count_s,
        "flash_launches": {"forward": fwd, "backward": bwd, "forward_expected": want_fwd,
                           "backward_expected": want_bwd, "backward_by_route": run.routes,
                           "kernels_per_backward": fa.BWD_LAUNCHES, "one_step_by_shape": by_shape},
        "ssd_launches": {"calls": run.ssd, "expected": want_ssd}, "ssm": ssm,
        "tokens_per_s": train["tokens_per_s"], "tokens_per_s_steady": cut.batch * cut.seq / steady_ms * 1e3,
        "step_ms_median": steady_ms, "step_ms_first": step_ms[0],
        "max_memory_allocated_gb": run.peak_gb, "device_idle": idle,
        "attention_op_bf16": {"layers": rows, "inputs": f"one probe microbatch ({B} x {cut.seq}), every attention "
                                                        "call's q, k, v and dO at its own mask",
                              "tolerance": {"rtol": BWD_RTOL, "atol_of_max": BWD_ATOL_OF_MAX,
                                            "lse": {"atol": LSE_TRAIN_ATOL,
                                                    "fp32_spacings": LSE_TRAIN_SPACINGS}}},
        "after_training": after_training,
    }
    emit(line)
    for cond, what in later:
        check(cond, what)
    for layer, r in enumerate(rows):
        check(all(r[n]["ok"] for n in ("dq", "dk", "dv", "lse")),
              f"attention call {layer} ({r['mask']}): the kernels disagree with the plain versions on the training "
              f"inputs: {r}")
    return fwd, bwd, max((r[n]["max_abs_err"] for r in rows for n in ("dq", "dk", "dv")), default=0.0), line


def _ssm_train_checks(model, held_out, micro, cut: TrainCut, step_busy_ms: float):
    """A full-width training cut's SSM layers on one probe microbatch: every
    SSD call's real inputs through the kernel against the sequential plain
    scan (y by relative L2 within REAL_INPUT_REL, the final state within
    SSD_H_REL), and the device time of one call's forward (the kernel) and
    of its backward (``SSDScan.backward``: autograd through the chunked
    form, ``ssd_chunked_ref``, recomputed from the saved inputs), each by
    ``device_breakdown``, with their shares of the traced step's busy time at
    a step's calls (forward and remat recompute, backward once, per layer and
    microbatch).  Returns the line's dict with its checks under "checks"."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import ssd_chunked_ref, ssd_ref

    ssd_op, captured = ops.ssd_scan, []

    def capture(*args, **kw):
        captured.append((args, kw))
        return ssd_op(*args, **kw)

    ops.ssd_scan = capture
    try:
        with torch.no_grad():
            held_out(micro)
    finally:
        ops.ssd_scan = ssd_op
    rows = []
    for args, kw in captured:
        with torch.no_grad():
            y, h = ssd_op(*args, **kw)
            sy, sh = ssd_ref(*args, h0=kw.get("h0"), return_state=True)
        rows.append({"y_rel_l2": _rel(y, sy), "h_rel_l2": _rel(h, sh), "max_abs_out": sy.float().abs().max().item(),
                     "outside_bf16_tol": int((~torch.isclose(y.float(), sy.float(), **SSD_BF16_TOL)).sum())})
        del y, h, sy, sh
    args, kw = captured[0]
    x, dt, A, Bm, Cm, D = args[:6]
    chunk = ops.ref_chunk(x.shape[1], kw["chunk"])
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    with torch.no_grad():
        y, h = ssd_op(*args, **kw)
    g = torch.Generator(device="cuda").manual_seed(41)
    gy = torch.randn(y.shape, generator=g, device="cuda").to(y.dtype)
    gh = torch.zeros_like(h)

    def backward():  # what SSDScan.backward computes
        with torch.enable_grad():
            out = ssd_chunked_ref(*leaves, chunk=chunk, return_state=True)
            return torch.autograd.grad(out, leaves, (gy, gh))

    fwd_us = device_breakdown(lambda: ssd_op(*args, **kw))
    bwd_us = device_breakdown(backward)
    n_calls = len(captured)
    fwd_ms, bwd_ms = sum(fwd_us.values()) / 1e3, sum(bwd_us.values()) / 1e3
    per_step = {"forward_ms": 2 * cut.micro * n_calls * fwd_ms, "backward_ms": cut.micro * n_calls * bwd_ms}
    del captured, leaves, y, h, gy, gh
    out = {
        "ssd_calls_a_forward": n_calls, "shape": f"B={x.shape[0]} S={x.shape[1]} H={x.shape[2]} P={x.shape[3]} "
                                                 f"N={Bm.shape[3]} G={Bm.shape[2]} {str(x.dtype)[6:]}",
        "route": sk.select_route(x.dtype), "chunk_of_the_backward": chunk,
        "ssd_op_bf16": {"layers": rows, "y_rel_tolerance": REAL_INPUT_REL, "h_rel_tolerance": SSD_H_REL},
        "one_call_device_ms": {"forward_kernel": fwd_ms, "backward_autograd_chunked": bwd_ms},
        "backward_top_kernels_us": dict(sorted(bwd_us.items(), key=lambda kv: -kv[1])[:TOP_OPS]),
        "per_step_device_ms": per_step, "step_device_busy_ms": step_busy_ms,
        "share_of_step_busy": {k.replace("_ms", ""): v / step_busy_ms for k, v in per_step.items()},
        "checks": [(r["y_rel_l2"] <= REAL_INPUT_REL and r["h_rel_l2"] <= SSD_H_REL,
                    f"bf16 SSD kernel vs ssd_ref on SSM call {i}'s training inputs: {r}") for i, r in enumerate(rows)],
    }
    return out


def _stack_layers(model):
    """The model's layers as one tree of stacked tensors, ``(L, ...)`` a
    leaf, keyed as a layer's parameters are (``{"attn": {"wq": ...}, ...}``)."""
    per = [dict(layer.named_parameters()) for layer in model.layers]
    out = {}
    for name in per[0]:
        *parents, last = name.split(".")
        cur = out
        for key in parents:
            cur = cur.setdefault(key, {})
        cur[last] = torch.stack([layer[name].detach() for layer in per])
    return out


def _dist_mesh_and_pipeline(cfg):
    """On the one-rank NCCL group: deepseek-7b's plan at train_4k on the tiny
    mesh at (data 1, model 1), a DIST_PIPE_LAYERS-layer full-width cut's
    parameters distributed by its placements and gathered back (bit for
    bit), and the one-stage pipeline over the cut's stacked layers against
    the sequential stack (bit for bit), its flash launches counted."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.configs import SHAPES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_tiny_mesh, mesh_axis_sizes
    from repro_torch.launch.shardings import make_plan
    from repro_torch.models import Transformer
    from repro_torch.models.layers import embed_apply
    from repro_torch.models.params import iter_leaves
    from repro_torch.train.pipeline import pipeline_forward, split_stages
    from torch.utils._pytree import tree_map

    pcfg = dataclasses.replace(cfg, n_layers=DIST_PIPE_LAYERS)
    t0 = time.perf_counter()
    mesh = make_tiny_mesh(data=1, model=1)
    check(mesh.device_type == "cuda" and mesh_axis_sizes(mesh) == {"data": 1, "model": 1}, f"the mesh {mesh}")
    plan = make_plan(pcfg, SHAPES["train_4k"], mesh)
    specs = {path.replace("/", "."): spec for path, spec in iter_leaves(plan.param_specs)}
    placements = {path.replace("/", "."): pl for path, pl in iter_leaves(plan.placements(plan.param_specs))}
    model = Transformer(pcfg, device="cuda", seed=DIST_PIPE_LAYERS)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    check(sorted(placements) == sorted(n for n, _ in model.named_parameters()), "a placement for every parameter")
    t0 = time.perf_counter()
    sharded, unequal = 0, []
    for name, p in model.named_parameters():
        d = distribute_tensor(p.detach(), mesh, placements[name])
        sharded += any(isinstance(pl, Shard) for pl in d.placements)
        if not (d.to_local().shape == p.shape and torch.equal(d.full_tensor(), p.detach())):
            unequal.append(name)
        del d
    torch.cuda.synchronize()
    round_trip_s = time.perf_counter() - t0
    check(not unequal, f"distribute_tensor then full_tensor() changed {unequal}")
    check(sharded > 0, "no parameter's placements shard it")

    # the one-stage pipeline: DIST_PIPE_MICRO microbatches of one DENSE_SEQ-token row, the cut's layers stacked
    stacked = _stack_layers(model)
    stage_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, pcfg.vocab_size, (DIST_PIPE_MICRO, DENSE_SEQ), generator=g, device="cuda")
    positions = torch.arange(DENSE_SEQ, device="cuda")[None]
    layer_fn = lambda lp, x: model._layer(lp, x, positions)[0]  # noqa: E731
    check(fa.select_route(torch.bfloat16, pcfg.resolved_head_dim) == "wgmma", "bf16 at D = 128 on wgmma")
    with torch.no_grad():
        xs = embed_apply(model.embed, tokens, pcfg)[:, None]  # (M, 1, S, d_model)
        torch.cuda.synchronize()
        before = fa.flash_attention.launches
        t0 = time.perf_counter()
        out = pipeline_forward(split_stages(stacked, 1), xs, layer_fn, stage_mesh, "stage")
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        launches = fa.flash_attention.launches - before
        t0 = time.perf_counter()
        want = []
        for x in xs:
            for i in range(DIST_PIPE_LAYERS):
                x = layer_fn(tree_map(lambda t: t[i], stacked), x)
            want.append(x)
        want = torch.stack(want)
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
    equal = torch.equal(out, want)
    gap = (out.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(out).all())
    del model, stacked, xs, out, want
    torch.cuda.empty_cache()
    check(launches == DIST_PIPE_MICRO * DIST_PIPE_LAYERS,
          f"{launches} flash launches in the pipeline, want {DIST_PIPE_MICRO * DIST_PIPE_LAYERS}")
    check(equal and finite, f"the one-stage pipeline differs from the sequential stack by {gap}")
    return {"mesh": {"shape": [1, 1], "axes": list(mesh.mesh_dim_names), "backend": "nccl", "device": "cuda",
                     "plan": "deepseek-7b train_4k", "layers": DIST_PIPE_LAYERS,
                     "params": sum(1 for _ in specs), "sharded_specs": sharded,
                     "specs_by_placement": {str(s): sum(1 for v in specs.values() if v == s)
                                            for s in sorted(set(specs.values()), key=str)},
                     "round_trip_bit_equal": True, "mesh_and_init_s": mesh_s, "round_trip_s": round_trip_s},
            "pipeline": {"stages": 1, "microbatches": DIST_PIPE_MICRO, "tokens_a_microbatch": DENSE_SEQ,
                         "layers": DIST_PIPE_LAYERS, "flash_launches": launches, "bit_equal_to_sequential": equal,
                         "max_abs_gap": gap, "pipeline_ms": pipe_ms, "sequential_ms": seq_ms}}


def phase_dist_full_width(plain):
    """Distribution on the card: a one-rank NCCL group (an in-process
    HashStore), the tiny mesh, the plan's placements and the one-stage
    pipeline (``_dist_mesh_and_pipeline``), then DIST_CUT trained with int8
    compression and a bf16 accumulator through ``_train_full_width`` (its
    checks and controls), beside ``plain``, dense_train_full_width's line:
    the same cut without compression, trained earlier in the run, whose
    held-out change the compressed run's must match within
    DIST_HELD_OUT_GAP.  The
    group is destroyed when it ends.  Returns the compressed run's flash
    launches and largest gradient error, and the pipeline's flash
    launches."""
    import torch.distributed as dist

    from repro_torch.optim import wire_bytes
    from repro_torch.train import compress_groups

    cfg = cut_config(DIST_CUT)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
          == (4096, 32, 32, 128, 11008, 102400), "deepseek-7b's published width")
    same = {k: plain[k] for k in ("config", "n_layers", "batch", "seq", "microbatches", "steps", "peak_lr")}
    check(same == {"config": cfg.name, "n_layers": DIST_CUT.layers, "batch": DIST_CUT.batch, "seq": DIST_CUT.seq,
                   "microbatches": DIST_CUT.micro, "steps": DIST_CUT.steps, "peak_lr": DENSE_LR}
          and not plain["compress_grads"], f"dense_train_full_width is not this cut uncompressed: {same}")
    uncompressed = {"phase": plain["phase"], **same, "accum_dtype": plain["accum_dtype"],
                    **{k: plain[k] for k in ("tokens_per_s_steady", "step_ms_median", "max_memory_allocated_gb",
                                             "held_out_loss", "losses")},
                    **{k: plain["device_idle"][k] for k in ("idle_share", "device_busy_ms", "device_ms_by_kernel")}}
    plain_held = plain["held_out_loss"]
    held = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "a one-rank NCCL group")
        parts = _dist_mesh_and_pipeline(cfg)

        def trained(run):
            held.update(before=run.held_out_before, change=run.held_out_after - run.held_out_before)

        def after(model):
            params = dict(model.named_parameters())
            groups = compress_groups(cfg, params)
            n = sum(p.numel() for p in params.values())
            plain_change = plain_held["after"] - plain_held["before"]
            gap = held["change"] - plain_change
            checks = [(held["before"] == plain_held["before"],
                       f"the held-out loss starts at {held['before']}, the uncompressed cut's at "
                       f"{plain_held['before']}: not the same weights and probe"),
                      (abs(gap) <= DIST_HELD_OUT_GAP,
                       f"held-out change {held['change']} against the uncompressed cut's {plain_change}: "
                       f"{gap} apart, more than {DIST_HELD_OUT_GAP}")]
            return {"checks": checks, **parts, "uncompressed_same_cut": uncompressed,
                    "held_out_change": held["change"], "uncompressed_held_out_change": plain_change,
                    "held_out_gap": gap, "held_out_gap_bound": DIST_HELD_OUT_GAP,
                    "wire_bytes": wire_bytes(params, groups), "bf16_gradient_bytes": 2 * n,
                    "int8_scales": len(set(groups.values())), "error_feedback_bytes": 4 * n}

        fwd, bwd, err, _ = _train_full_width(DIST_CUT, cfg, after=after, trained=trained)
    finally:
        dist.destroy_process_group()
    return fwd, bwd, err, parts["pipeline"]["flash_launches"]


def _shape_counts(shapes, B, cfg):
    """One forward pass's flash launches by ``_train_full_width``'s shape label."""
    from repro_torch.train import flash_widths

    Hkv, D, Dv = flash_widths(cfg)
    out = {}
    for Sq, Sk, causal, prefix in shapes:
        key = f"{_mask_label(Sq, Sk, causal, prefix)}, B={B} Hq={cfg.n_heads} Hkv={Hkv} {_dims_label(D, Dv)}"
        out[key] = out.get(key, 0) + 1
    return out


def phase_dense_train_full_width():
    """deepseek-7b at its published width, cut to DENSE_LAYERS layers, trained
    on the card (head dim 128)."""
    cfg = cut_config(DENSE_CUT)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
          == (4096, 32, 32, 128, 11008, 102400), "deepseek-7b's published width")
    return _train_full_width(DENSE_CUT, cfg, after=_adamw_peak)


def _adamw_peak(model):
    """The device memory one AdamW update takes above what it starts from, on
    the trained cut's weights with fresh moments (its config's dtype) and
    fp32 gradients of zeros (after every check of the phase: it moves the
    weights), slice by slice as the trainer runs it
    (``optim.adamw.CHUNK_ELEMS``): held under one slice's fp32 temporaries,
    20 bytes an element (p, m and v in fp32, ``denom``, ``delta``)."""
    from repro_torch.configs import torch_dtype
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import CHUNK_ELEMS

    params = dict(model.named_parameters())
    opt = adamw_init(params, torch_dtype(model.cfg.opt_state_dtype))
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_update(grads, opt, params, 1e-6, AdamWConfig())
    torch.cuda.synchronize()
    above, bound = (torch.cuda.max_memory_allocated() - base) / 1e9, 20 * CHUNK_ELEMS / 1e9
    del opt, grads, params
    torch.cuda.empty_cache()
    return {"adamw_update_peak_above_start_gb": above, "start_gb": base / 1e9, "chunk_elems": CHUNK_ELEMS,
            "checks": [(above <= bound, f"AdamW's update peaks {above} GB above its start, over one slice's "
                                        f"fp32 temporaries ({bound} GB)")]}


def phase_gemma_train_full_width():
    """gemma-7b at its published width, cut to GEMMA_LAYERS layers (the only
    cut; see GEMMA_LAYERS), trained on the card: its 16 heads of 256 run the
    tensor-core flash backward at D = 256, forward and backward, and its
    GeGLU, tied and scaled embedding go through the trainer's own entry
    point."""
    cfg = cut_config(GEMMA_CUT)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
          == (3072, GEMMA_HEADS, GEMMA_HEADS, GEMMA_HEAD_DIM, 24576, 256000), "gemma-7b's published width")
    check((cfg.hidden_act, cfg.tie_embeddings, cfg.scale_embedding) == ("gelu", True, True),
          "gemma-7b's GeGLU, tied and scaled embedding")
    return _train_full_width(GEMMA_CUT, cfg)[:3]


def phase_moe_train_full_width():
    """deepseek-v2-lite at its published widths, cut to MOE_TRAIN_LAYERS
    layers (the only cut; see there), trained on the card: every layer's MLA
    attention runs the tensor-core flash kernels at (192, 128) forward and
    backward, and its MoE layers (the router, the sort-based dispatch, the
    experts' ``bmm``s, the combine) go through autograd in the trainer's own
    entry point."""
    cfg = cut_config(MOE_CUT)
    m, moe = cfg.mla, cfg.moe
    check((cfg.d_model, cfg.n_heads, m.kv_lora_rank, m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim, cfg.d_ff,
           cfg.vocab_size, cfg.tie_embeddings)
          == (2048, MLA_HEADS, 512, MLA_DQK, MLA_DV, 10944, 102400, False), "deepseek-v2-lite's published widths")
    check((moe.n_experts, moe.top_k, moe.expert_d_ff, moe.n_shared, moe.first_k_dense) == (64, 6, 1408, 2, 1),
          "deepseek-v2-lite's published experts")
    # the repeat: the same cut trained once more from the same seed on the same batches, its weights, losses
    # and held-out losses bit for bit the phase's run's, each run's weights taken right after its last step
    # (the phase's model takes a traced step and the weight-alone checks after that)
    runs = []

    def keep(run):
        runs.append(({n: p.detach().cpu() for n, p in run.model.named_parameters()}, [h["loss"] for h in run.hist],
                     (run.held_out_before, run.held_out_after)))

    fwd, bwd, err, line = _train_full_width(MOE_CUT, cfg, trained=keep)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = full_width_run(cfg, MOE_CUT.steps, MOE_CUT.eval_every)
    keep(run)
    del run
    wall = time.perf_counter() - t0
    (first, losses, held), (second, losses2, held2) = runs
    differ = [n for n in first if not torch.equal(first[n], second[n])]
    same = not differ and losses == losses2 and held == held2
    emit({"phase": "moe_train_repeat", "config": cfg.name, "n_layers": cfg.n_layers, "steps": MOE_CUT.steps,
          "losses": [losses, losses2], "held_out_loss": [held, held2], "leaves": len(first),
          "leaves_differing": len(differ), "bit_identical": same, "wall_s": wall})
    check(same, f"two runs of one seed differ: {len(differ)} leaves (first {differ[:3]}), losses {losses} and "
                f"{losses2}, held-out {held} and {held2}")
    del runs, first, second
    torch.cuda.empty_cache()
    return fwd, bwd, err


def phase_qwen2_train_full_width():
    """qwen2-72b's published widths cut to 3 layers (QWEN2_CUT), trained
    with bf16 AdamW moments through ``_train_full_width``."""
    from repro_torch.kernels import flash_attention as fa

    cfg = cut_config(QWEN2_CUT)
    check(cfg.qkv_bias and cfg.opt_state_dtype == "bfloat16" and (cfg.n_heads, cfg.n_kv_heads) == (64, 8),
          "qwen2-72b: QKV bias, bf16 moments, 64 heads on 8")
    fwd, bwd, err, line = _train_full_width(QWEN2_CUT, cfg)
    fa.flash_attention.launches = fa.flash_attention_backward.launches = 0
    return fwd, bwd, err, line


def phase_jamba_train_full_width():
    """jamba-1.5-large's published widths cut to its first layer (JAMBA_CUT:
    SSM + dense FFN), trained with bf16 AdamW moments through
    ``_train_full_width``: the SSD kernel's launches, its real inputs, and
    the SSD backward's share of the step's device time."""
    from repro_torch.kernels import ssd_scan as sk

    cfg = cut_config(JAMBA_CUT)
    s = cfg.ssm
    check((s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.n_groups) == JAMBA_SSD_WIDTH
          and not cfg.layer_is_attn(0) and not cfg.layer_is_moe(0) and cfg.opt_state_dtype == "bfloat16",
          "jamba's first layer: SSM at its published width and a dense FFN, bf16 moments")
    fwd, bwd, err, line = _train_full_width(JAMBA_CUT, cfg)
    sk.ssd_scan.launches = 0
    return line


def _greedy(model, toks, kw, steps: int, enc_len: int):
    """``prefill`` of ``toks`` (with ``kw``'s stub embeddings), then ``steps``
    greedy ``decode_step``s from a cache of the prompt's length plus
    ``steps``, each timed to the device: the prefill's ms and flash launches,
    the decode's ms and launches, every step's logits and token, the cache's
    GB."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve.cache_utils import transplant

    rows, n0 = toks.shape[0], model.cfg.vision_tokens + toks.shape[1]
    torch.cuda.synchronize()
    before, t0 = fa.flash_attention.launches, time.perf_counter()
    logits, small = model.prefill(toks, **kw)
    torch.cuda.synchronize()
    prefill_s, prefill_launches = time.perf_counter() - t0, fa.flash_attention.launches - before
    cache = transplant(model.init_cache(rows, n0 + steps, enc_len=enc_len), small)
    cache_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
    del small
    step_logits, tokens = [logits], [logits.argmax(-1)]
    pos = torch.full((rows,), n0, dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    before, t0 = fa.flash_attention.launches, time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode_step(cache, tokens[-1], pos)
        step_logits.append(logits)
        tokens.append(logits.argmax(-1))
        pos = pos + 1
    torch.cuda.synchronize()
    return (prefill_s, prefill_launches, time.perf_counter() - t0, fa.flash_attention.launches - before,
            step_logits, tokens, cache_gb)


def _against_forward(model, toks, kw, step_logits, tokens):
    """Each step's logits (prefill, then decode) against one teacher-forced
    forward over the prompt and the generated tokens: relative L2 over the
    real vocabulary (the padded entries are -1e9 on every path), and the
    share of steps whose greedy token the forward's argmax repeats."""
    P, V = toks.shape[1], model.cfg.vocab_size
    with torch.no_grad():
        full = model(torch.cat([toks, torch.stack(tokens[:-1], 1)], 1), **kw)[0]
    rels = [_rel(x[:, :V].float(), full[:, P - 1 + t, :V].float()) for t, x in enumerate(step_logits)]
    agree = statistics.mean(float((full[:, P - 1 + t].argmax(-1) == tok).float().mean())
                            for t, tok in enumerate(tokens))
    return rels, agree


def _generation(rows: int, prompt_len: int, steps: int, enc_len: int, seed: int):
    """``after`` for ``_train_full_width``: from the trained weights, ``prefill``
    of ``rows`` seeded prompts of ``prompt_len`` tokens (with ``enc_len``
    stub frame embeddings, or the config's stub vision embeddings, a row),
    timed after one warm-up, then ``steps`` greedy ``decode_step``s (a VLM's
    positions after its vision tokens; an enc-dec model's over its cross
    cache), timed; all in bf16, then once more in fp32 compute.  Checked:
    the bf16 prefill's flash launches (every attention call,
    ``attention_shapes``) and none in decode, finite logits, tokens in the
    vocabulary, and, in fp32, each step's logits against one teacher-forced
    forward over the prompt and the generated tokens (relative L2 within
    DECODE_FP32_REL).  The bf16 run's gap to its forward is printed: the two
    round at other places (decode attends in fp32 over the bf16 cache, the
    forward runs the bf16 flash kernel), and the reference's init amplifies
    that rounding through the stack."""

    def run(model):
        cfg = model.cfg
        g = torch.Generator(device="cuda").manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (rows, prompt_len), generator=g, device="cuda")
        kw = {}
        if enc_len:
            kw["enc_embeds"] = torch.randn((rows, enc_len, cfg.d_model), generator=g, device="cuda")
        if cfg.vision_tokens:
            kw["vision_embeds"] = torch.randn((rows, cfg.vision_tokens, cfg.d_model), generator=g, device="cuda")
        model.prefill(toks, **kw)  # warm-up
        prefill_s, prefill_launches, decode_s, decode_launches, step_logits, tokens, cache_gb = _greedy(
            model, toks, kw, steps, enc_len)
        finite = all(bool(torch.isfinite(x).all()) for x in step_logits)
        rels, agree = _against_forward(model, toks, kw, step_logits, tokens)
        gen = torch.stack(tokens, 1)
        model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
        try:
            step32, tokens32 = _greedy(model, toks, kw, steps, enc_len)[4:6]
            rels32, agree32 = _against_forward(model, toks, kw, step32, tokens32)
        finally:
            model.cfg = cfg
        del step_logits, step32
        A = len(attention_shapes(cfg, prompt_len, enc_len))
        run.result = {
            "rows": rows, "prompt_tokens": prompt_len, "vision_tokens": cfg.vision_tokens, "enc_len": enc_len,
            "decode_steps": steps, "cache_gb": cache_gb, "prefill_ms": prefill_s * 1e3,
            "prefill_tokens_per_s": rows * (cfg.vision_tokens + prompt_len) / prefill_s,
            "prefill_frames_per_s": rows * enc_len / prefill_s if enc_len else None,
            "decode_ms_per_step": decode_s * 1e3 / steps, "decode_tokens_per_s": rows * steps / decode_s,
            "prefill_flash_launches": prefill_launches, "decode_flash_launches": decode_launches,
            "bf16_logits_rel_l2_vs_teacher_forced": {"max": max(rels), "mean": statistics.mean(rels),
                                                     "greedy_agreement": agree},
            "fp32_logits_rel_l2_vs_teacher_forced": {"max": max(rels32), "mean": statistics.mean(rels32),
                                                     "greedy_agreement": agree32, "tolerance": DECODE_FP32_REL},
            "tokens_row0": gen[0].tolist(),
            "checks": [
                (prefill_launches == A, f"the prefill launched {prefill_launches} flash kernels, want {A}"),
                (decode_launches == 0, f"decode launched {decode_launches} flash kernels"),
                (finite, "non-finite prefill or decode logits"),
                (bool(((gen >= 0) & (gen < cfg.vocab_size)).all()), "a generated token outside the vocabulary"),
                (max(rels32) <= DECODE_FP32_REL,
                 f"fp32 decode logits against the teacher-forced forward, rel L2 {rels32}"),
            ],
        }
        return dict(run.result)

    return run


def phase_encdec_full_width():
    """whisper-medium at its published size, uncut, trained on the card
    (``_train_full_width`` at ENCDEC_CUT: 1,500 stub frames and 448 tokens
    a row; every encoder, decoder and cross-attention call on the
    tensor-core kernels, forward and backward), then served from the trained
    weights through the model's entry points: a prefill of ENCDEC_DECODE's
    rows and greedy decode steps over the cross cache.  Returns the
    training's launches and largest gradient error, and the serving
    readings."""
    cfg = cut_config(ENCDEC_CUT)
    gen = _generation(*ENCDEC_DECODE, ENCDEC_CUT.enc_len, seed=41)
    check((cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
           cfg.vocab_size, cfg.padded_vocab, cfg.use_rope, cfg.remat)
          == (24, 24, 1024, 16, 16, 64, 4096, 51865, 51968, False, "dots"), "whisper-medium's published size")
    return (*_train_full_width(ENCDEC_CUT, cfg, after=gen)[:3], gen.result)


def phase_prefix_lm_full_width():
    """paligemma-3b at its published size, uncut, trained on the card
    (``_train_full_width`` at PREFIX_CUT: 256 stub patch embeddings and 256
    tokens a row, attention at S = 512 with a prefix of 256 on the
    tensor-core kernels at D = 256, MQA, forward and backward), then served
    from the trained weights: a prefill of PREFIX_DECODE's rows and greedy
    decode steps at positions after the prefix.  Returns as
    ``phase_encdec_full_width`` does."""
    cfg = cut_config(PREFIX_CUT)
    gen = _generation(*PREFIX_DECODE, 0, seed=43)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
           cfg.padded_vocab, cfg.hidden_act, cfg.tie_embeddings, cfg.scale_embedding, cfg.vision_tokens, cfg.prefix_lm,
           cfg.remat)
          == (18, 2048, 8, 1, 256, 16384, 257216, 257280, "gelu", True, True, 256, True, "full"),
          "paligemma-3b's published size")
    return (*_train_full_width(PREFIX_CUT, cfg, after=gen)[:3], gen.result)


def _model_errors(cpu, gpu, cfg, toks, kw, enc_len):
    """``gpu`` (the card) against ``cpu`` from the same weights: the largest
    logits gap of the forward, the prefill and 8 greedy decode steps (the
    CPU's tokens fed to both), each cache leaf's gap relative to its largest
    entry, and whether the card's greedy tokens were the CPU's."""
    from repro_torch.serve.cache_utils import transplant

    gkw = {n: t.cuda() for n, t in kw.items()}
    with torch.no_grad():
        err = {"forward_logits": (gpu(toks.cuda(), **gkw)[0].cpu() - cpu(toks, **kw)[0]).abs().max().item()}
    c_logits, c_small = cpu.prefill(toks, **kw)
    g_logits, g_small = gpu.prefill(toks.cuda(), **gkw)
    err["prefill_logits"] = (g_logits.cpu() - c_logits).abs().max().item()
    check(sorted(g_small) == sorted(c_small), f"cache leaves {sorted(g_small)} vs {sorted(c_small)}")
    err["cache_rel"] = {k: (g_small[k].cpu() - v).abs().max().item() / v.abs().max().item() for k, v in c_small.items()}
    n0, steps = toks.shape[1] + cfg.vision_tokens, 8
    c_cache = transplant(cpu.init_cache(2, n0 + steps, enc_len=enc_len), c_small)
    g_cache = transplant(gpu.init_cache(2, n0 + steps, enc_len=enc_len), g_small)
    pos, tokens, same, decode_err = torch.full((2,), n0, dtype=torch.long), [], True, 0.0
    for _ in range(steps):
        tok = c_logits.argmax(-1)
        same = same and torch.equal(g_logits.argmax(-1).cpu(), tok)
        tokens.append(tok.tolist())
        c_logits, _ = cpu.decode_step(c_cache, tok, pos)
        g_logits, _ = gpu.decode_step(g_cache, tok.cuda(), pos.cuda())
        decode_err = max(decode_err, (g_logits.cpu() - c_logits).abs().max().item())
        pos = pos + 1
    err["decode_logits"] = decode_err
    return err, tokens, same


def _within_noise(got, plain, floor):
    """Each of ``got``'s gaps (card against CPU, with the kernels) within the
    larger of ``floor`` and SMOKE_NOISE_FACTOR times the same gap with the
    plain attention on the card (``plain``): the kernels may add at most that
    much to the card's own fp32 noise."""
    if isinstance(got, dict):
        return all(_within_noise(got[k], plain[k], floor[k] if isinstance(floor, dict) else floor) for k in got)
    return got <= max(floor, SMOKE_NOISE_FACTOR * plain)


def _smoke_parity(phase: str, cfg, enc_len: int, note: str, later_held: bool, later_note: str = ""):
    """``cfg`` (an fp32 smoke config) on the card and on the CPU from the same
    weights: forward logits, prefill logits and every cache leaf, 8 greedy
    decode steps (tokens equal); then three train steps (``_train_parity``;
    a MoE config's step-1 experts first, a token routed differently a tie
    within TIE_EPS), the zeroed and negated backward controls beside them.
    Every flash call runs on the kernels, and each reading is also taken
    with the plain attention on the card: the kernels' gaps must
    stay within the larger of dense_parity's tolerances (SMOKE_LOGITS_ATOL,
    SMOKE_CACHE_REL, DENSE_STEP1_*) and SMOKE_NOISE_FACTOR times that card's
    own fp32 gap to the CPU, which the controls must fail.  The later steps
    are held to DENSE_LOSS_RTOL and DENSE_GNORM_RTOL where ``later_held``,
    else printed (``later_note`` says why)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer

    check(cfg.compute_dtype == "float32" and cfg.remat == "none", f"{cfg.name} smoke is fp32 without remat")
    cpu = Transformer(cfg, device="cpu", seed=17)
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(17)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)), dtype=torch.long)
    kw = {}
    if enc_len:
        kw["enc_embeds"] = torch.as_tensor(rng.standard_normal((2, enc_len, cfg.d_model)), dtype=torch.float32)
    if cfg.vision_tokens:
        kw["vision_embeds"] = torch.as_tensor(rng.standard_normal((2, cfg.vision_tokens, cfg.d_model)),
                                              dtype=torch.float32)
    before = fa.flash_attention.launches
    err, tokens, same = _model_errors(cpu, gpu, cfg, toks, kw, enc_len)
    model_launches = fa.flash_attention.launches - before
    flash = ops.flash_attention
    ops.flash_attention = lambda *a, **k: flash(*a, **{**k, "impl": "plain"})
    try:
        plain_err, _, plain_same = _model_errors(cpu, gpu, cfg, toks, kw, enc_len)
    finally:
        ops.flash_attention = flash
    del cpu, gpu

    data = {"d_model": cfg.d_model, "enc_len": enc_len, "vision_tokens": cfg.vision_tokens}
    rows, step1, plain, controls, change, launches, tcfg, routes = _train_parity(
        cfg, route_trace=cfg.moe is not None, data=data)
    flipped = _routed_differently(routes) if routes is not None else None
    step1_floor = {"loss": DENSE_STEP1_RTOL, "grad_norm": DENSE_STEP1_RTOL, "grad": DENSE_GRAD_REL,
                   "change": DENSE_STEP1_CHANGE_REL}
    A, A_train = len(attention_shapes(cfg, toks.shape[1], enc_len)), len(attention_shapes(cfg, 64, enc_len))
    want_launches = len(rows) * tcfg.microbatches * A_train  # no remat: one forward and one backward per call
    emit(_parity_line(phase, f"{cfg.name} SMOKE, {note}", rows, step1, plain, change, controls, launches,
                      model_errors=err, plain_attention_model_errors=plain_err, decode_tokens=tokens,
                      greedy_tokens_equal=same, model_flash_launches=model_launches, n_heads=cfg.n_heads,
                      head_dim=cfg.resolved_head_dim, enc_len=enc_len, vision_tokens=cfg.vision_tokens,
                      later_steps="held" if later_held else f"printed: {later_note}", routed_differently=flipped,
                      tolerances={"logits_atol": SMOKE_LOGITS_ATOL, "cache_rel": SMOKE_CACHE_REL,
                                  "noise_factor": SMOKE_NOISE_FACTOR, "step1": step1_floor,
                                  "loss_rtol": DENSE_LOSS_RTOL, "grad_norm_rtol": DENSE_GNORM_RTOL}))
    check(same and plain_same, "greedy tokens differ between card and CPU")
    floor = {"forward_logits": SMOKE_LOGITS_ATOL, "prefill_logits": SMOKE_LOGITS_ATOL,
             "decode_logits": SMOKE_LOGITS_ATOL, "cache_rel": SMOKE_CACHE_REL}
    check(_within_noise(err, plain_err, floor), f"card vs CPU with the kernels {err}, with plain attention {plain_err}")
    check(model_launches == 2 * A, f"forward and prefill launched {model_launches} flash kernels, want {2 * A}")
    check(_within_noise(step1, plain, step1_floor), f"step 1 card vs CPU: {step1}, with plain attention {plain}")
    check(all(np.isfinite(v) for r in rows for pair in r.values() for v in pair), f"non-finite metrics {rows}")
    if later_held:
        for i, r in enumerate(rows[1:], start=1):
            (gl, cl), (gg, cg) = r["loss"], r["grad_norm"]
            check(abs(gl - cl) <= DENSE_LOSS_RTOL * abs(cl), f"step {i}: loss card {gl} vs CPU {cl}")
            check(abs(gg - cg) <= DENSE_GNORM_RTOL * abs(cg), f"step {i}: grad norm card {gg} vs CPU {cg}")
    for label, g in controls.items():
        check(not _within_noise(g, plain, step1_floor), f"the {label} control passes the first step's checks: {g}")
    check(launches == (want_launches, want_launches),
          f"flash launches in 3 smoke steps: {launches}, want {want_launches} each")


def phase_encdec_parity():
    """whisper's smoke config on the card and on the CPU (``_smoke_parity``)
    at its own 4 heads of 16: the kernels run at 32 on zero-padded copies
    (``flash_attention.PAD_D16``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa

    cfg = get_smoke_config("whisper-medium")
    check(cfg.resolved_head_dim == 16 and fa.PAD_D16 == 32, "whisper's smoke head dim is 16")
    _smoke_parity("encdec_parity", cfg, ENCDEC_PARITY_FRAMES,
                  "4 heads of 16, the SIMT kernels at 32 on zero-padded copies forward and backward: encoder "
                  "non-causal, decoder causal, cross non-causal at (Sq, S_enc)", later_held=False,
                  later_note="step 1's gradients differ card vs CPU by ~2e-3 of each leaf with the kernels and with "
                             "the plain attention alike (the reference's init draws this 64-wide model's layers at "
                             "std 2^-0.5), and AdamW turns that into whole steps after it (PERF.md)")


def phase_qwen2_parity():
    """qwen2-72b's smoke config (QKV bias, 8 heads of 16 on 2 kv heads, rope
    theta 1e6) on the card and on the CPU (``_smoke_parity``): the SIMT
    kernels at 32 on zero-padded copies forward and backward."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("qwen2-72b")
    check(cfg.qkv_bias and cfg.resolved_head_dim == 16 and cfg.n_kv_heads == 2, "qwen2's smoke: QKV bias, D = 16")
    _smoke_parity("qwen2_parity", cfg, 0, "QKV bias, 8 heads of 16 on 2 kv heads; the SIMT kernels at 32 on "
                                          "zero-padded copies forward and backward", later_held=True)


def phase_hybrid_train_parity():
    """jamba's smoke config (8 layers: attention at position 4, MoE at the odd
    positions, SSD layers at P = 32 on the fp32 SIMT kernel) on the card and
    on the CPU (``_smoke_parity``): serving, then three train steps, step 1's
    experts first, with the zeroed and negated backward controls."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("jamba-1.5-large-398b")
    check(cfg.n_layers == 8 and cfg.moe is not None and cfg.ssm is not None, "jamba's smoke: the hybrid")
    _smoke_parity("hybrid_train_parity", cfg, 0, "attention at 4, MoE at odd positions, SSD at P = 32: the SIMT "
                                                  "flash and SSD kernels", later_held=False,
                  later_note="after step 1 the two runs' weights differ by AdamW's amplified fp32 noise and the "
                             "router sends the tokens whose top-k margin sits below it to other experts "
                             "(routed_differently), as in moe_train_parity")


def phase_prefix_lm_parity():
    """paligemma's smoke config (MQA, head dim 32, 16 vision tokens as the
    prefix) on the card and on the CPU (``_smoke_parity``)."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("paligemma-3b")
    _smoke_parity("prefix_lm_parity", cfg, 0, f"the SIMT kernels forward and backward with a prefix of "
                                              f"{cfg.vision_tokens}", later_held=True)


def _prefix_timing(smi, name, B, Sq, Sk, Hq, Hkv, D, dtype, causal, prefix_len, seed):
    """One shape of ``prefix_kernel``'s timing: the forward and the backward
    kernel beside their plain versions and SDPA (a boolean mask where a
    prefix needs one; K and V expanded to q's heads outside the call),
    graph-replayed, and their bounds; each checked against the plain
    version first."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref, flash_backward_ref

    fp32 = dtype == torch.float32
    q, do = randn((B, Sq, Hq, D), dtype, seed), randn((B, Sq, Hq, D), dtype, seed + 1)
    k, v = randn((B, Sk, Hkv, D), dtype, seed + 2), randn((B, Sk, Hkv, D), dtype, seed + 3)
    kw = dict(causal=causal, prefix_len=prefix_len)
    o, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    want = attention_ref(q, k, v, **kw)
    check(torch.allclose(o.float(), want.float(), **(FP32_TOL if fp32 else BF16_TOL)),
          f"{name}: forward disagrees with plain")
    del want
    g = _grads_close(fa.flash_attention_backward(q, k, v, o, lse, do, **kw),
                     flash_backward_ref(q, k, v, o, lse, do, **kw), fp32=fp32)
    check(all(r["ok"] for r in g.values()), f"{name}: backward disagrees with plain: {g}")
    if prefix_len:
        cols = torch.arange(Sk, device="cuda")
        mask = {"attn_mask": (cols[None, :] <= torch.arange(Sq, device="cuda")[:, None]) | (cols[None, :] < prefix_len)}
    else:
        mask = {"is_causal": causal}
    qh, kh, vh = _sdpa_heads(q, k, v)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, **mask)
    fwd = time_interleaved({"kernel": lambda: fa.flash_attention(q, k, v, **kw),
                            "plain": lambda: attention_ref(q, k, v, **kw), "library": sdpa})
    bwd = time_interleaved({"kernel": lambda: fa.flash_attention_backward(q, k, v, o, lse, do, **kw),
                            "plain": lambda: flash_backward_ref(q, k, v, o, lse, do, **kw),
                            **_sdpa_backward_fns(q, k, v, do, **mask)}, eager=("library_eager",))
    esize = q.element_size()
    out = {"shape": f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} {str(dtype)[6:]} {_mask_label(Sq, Sk, causal, prefix_len)}",
           "route": fa.select_route(dtype, D), "backward_max_abs_err": {n: r["max_abs_err"] for n, r in g.items()},
           "sdpa_kernels": sorted(device_breakdown(sdpa))}
    for direction, ms, backward in (("forward", fwd, False), ("backward", bwd, True)):
        flops = fa.flash_flops(B, Sq, Sk, Hq, D, causal=causal, backward=backward, prefix_len=prefix_len)
        nbytes = fa.flash_bytes(B, Sq, Sk, Hq, Hkv, D, esize, backward=backward)
        bound_ms, bound_by = _bound(flops, nbytes, smi, fp32=fp32)
        row = {"kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"], "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "kernel_tflops": flops / (ms["kernel"]["median"] * 1e-3) / 1e12,
               "spread_ms": {n: [m["min"], m["max"]] for n, m in ms.items()}}
        row.update(_sdpa_backward_ms(ms) if backward else {"library_ms": ms["library"]["median"]})
        out[direction] = row
    return out


def phase_prefix_kernel(smi: str):
    """The four flash kernels with a prefix-LM prefix, against their plain
    versions at both dtypes (bf16: the tensor-core forward and backward;
    fp32: the SIMT ones) at PREFIX_EDGES (S off the 64-row tile, MQA at D =
    256) and the prefixes PREFIX_LENS and one past S; a prefix of 0 bit for
    bit the causal call and one of S or more the non-causal one, in both
    directions.  Then timed beside the plain versions, their bounds and
    SDPA: at paligemma's training shape (PREFIX_TIMED, both dtypes), and at
    whisper's two new shapes, its encoder's non-causal 1,500 x 1,500 and its
    cross-attention's 448 x 1,500 (ENCDEC_TIMED, bf16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_lse_ref, attention_ref, flash_backward_ref

    err, n = {}, 0
    for i, (B, S, Hq, Hkv, D) in enumerate(PREFIX_EDGES):
        for P in (*PREFIX_LENS, S + 7):
            for dtype in (torch.bfloat16, torch.float32):
                fp32 = dtype == torch.float32
                q, do = randn((B, S, Hq, D), dtype, 1000 + 10 * i), randn((B, S, Hq, D), dtype, 1001 + 10 * i)
                k, v = randn((B, S, Hkv, D), dtype, 1002 + 10 * i), randn((B, S, Hkv, D), dtype, 1003 + 10 * i)
                o, lse = fa.flash_attention(q, k, v, causal=True, prefix_len=P, return_lse=True)
                want = attention_ref(q, k, v, causal=True, prefix_len=P)
                e = (o.float() - want.float()).abs().max().item()
                check(torch.allclose(o.float(), want.float(), **(FP32_TOL if fp32 else BF16_TOL)),
                      f"prefix forward {dtype} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} prefix {P}: {e}")
                check(torch.allclose(lse, attention_lse_ref(q, k, v, causal=True, prefix_len=P), **LSE_TOL),
                      f"prefix lse {dtype} S={S} D={D} prefix {P}")
                got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True, prefix_len=P)
                g = _grads_close(got, flash_backward_ref(q, k, v, o, lse, do, causal=True, prefix_len=P), fp32=fp32)
                check(all(r["ok"] for r in g.values()), f"prefix backward {dtype} S={S} D={D} prefix {P}: {g}")
                key = str(dtype)[6:]
                err[key] = max(err.get(key, 0.0), e, *(r["max_abs_err"] for r in g.values()))
                if P == 0 or P >= S:  # bit for bit the causal call, or the non-causal one
                    causal = P == 0
                    o2, lse2 = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
                    same = torch.equal(o, o2) and torch.equal(lse, lse2) and all(
                        torch.equal(a, b) for a, b in zip(got, fa.flash_attention_backward(q, k, v, o, lse, do,
                                                                                           causal=causal)))
                    check(same, f"prefix {P} at S={S} {dtype} is not bit for bit the causal={causal} call")
                n += 1
    B, S, Hq, Hkv, D, P = PREFIX_TIMED
    timing = {f"prefix_{str(dt)[6:]}": _prefix_timing(smi, "paligemma", B, S, S, Hq, Hkv, D, dt, True, P, 1100)
              for dt in (torch.bfloat16, torch.float32)}
    for name, (B, Sq, Sk, H, D) in ENCDEC_TIMED.items():
        timing[name] = _prefix_timing(smi, name, B, Sq, Sk, H, H, D, torch.bfloat16, False, 0, 1200)
    line = {"phase": "prefix_kernel", "checked": n, "edges": [list(e) for e in PREFIX_EDGES],
            "prefix_lens": [*PREFIX_LENS, "S + 7"], "max_abs_err": err,
            "tolerances": {"bfloat16": BF16_TOL, "float32": FP32_TOL,
                           "backward": {"rtol": BWD_RTOL, "atol_of_max": BWD_ATOL_OF_MAX, "float32": BWD_FP32_TOL}},
            "timing": timing,
            "timing_note": f"median of {ROUNDS} readings, each the mean of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) "
                           "back-to-back calls replayed from one CUDA graph; kernel, plain and SDPA alternate; "
                           "inputs warm in L2; SDPA's "
                           "backward is its forward and backward less its forward"}
    emit(line)
    fa.flash_attention.launches = fa.flash_attention_backward.launches = 0
    return line


def phase_d16_kernel(smi: str):
    """The four flash kernels at head dim 16, each run at 32 on zero-padded
    copies by its wrapper: held against the plain versions in both
    directions and both dtypes at D16_EDGES, one launch a call recorded at
    the true width; then timed, copies included, at D16_TIMED beside the
    plain versions and SDPA (``_prefix_timing``, which holds them against
    the plain versions first)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_lse_ref, attention_ref, flash_backward_ref

    check(fa.PAD_D16 == 32, "head dim 16 runs at 32")
    err, n = {}, 0
    for i, (B, Sq, Sk, Hq, Hkv, causal) in enumerate(D16_EDGES):
        for dtype in (torch.bfloat16, torch.float32):
            fp32 = dtype == torch.float32
            q, do = randn((B, Sq, Hq, 16), dtype, 1300 + 10 * i), randn((B, Sq, Hq, 16), dtype, 1301 + 10 * i)
            k, v = randn((B, Sk, Hkv, 16), dtype, 1302 + 10 * i), randn((B, Sk, Hkv, 16), dtype, 1303 + 10 * i)
            launches = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
            o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
            got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
            torch.cuda.synchronize()
            check((fa.flash_attention.launches, fa.flash_attention_backward.launches)
                  == (launches[0] + 1, launches[1] + 1), "one launch a call in each direction")
            want = attention_ref(q, k, v, causal=causal)
            e = (o.float() - want.float()).abs().max().item()
            label = f"D=16 {str(dtype)[6:]} B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} causal={causal}"
            check(o.shape == want.shape and torch.allclose(o.float(), want.float(), **(FP32_TOL if fp32 else BF16_TOL)),
                  f"{label}: forward {e}")
            check(torch.allclose(lse, attention_lse_ref(q, k, v, causal=causal), **LSE_TOL), f"{label}: lse")
            g = _grads_close(got, flash_backward_ref(q, k, v, o, lse, do, causal=causal), fp32=fp32)
            check(all(r["ok"] for r in g.values()) and all(t.is_contiguous() for t in got), f"{label}: backward {g}")
            key = str(dtype)[6:]
            err[key] = max(err.get(key, 0.0), e, *(r["max_abs_err"] for r in g.values()))
            n += 1
    timing = {name: _prefix_timing(smi, name, B, S, S, Hq, Hkv, 16, dtype, True, 0, 1400)
              for name, (B, S, Hq, Hkv, dtype) in D16_TIMED.items()}
    line = {"phase": "d16_kernel", "checked": n, "edges": [list(e) for e in D16_EDGES], "max_abs_err": err,
            "padded_to": fa.PAD_D16,
            "tolerances": {"bfloat16": BF16_TOL, "float32": FP32_TOL,
                           "backward": {"rtol": BWD_RTOL, "atol_of_max": BWD_ATOL_OF_MAX, "float32": BWD_FP32_TOL}},
            "timing": timing,
            "timing_note": f"median of {ROUNDS} readings, each the mean of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) "
                           "back-to-back calls replayed from one CUDA graph, the wrapper's zero-padded copies and "
                           "its slice of the outputs included; bound at the true width (16); SDPA at 16"}
    emit(line)
    fa.flash_attention.launches = fa.flash_attention_backward.launches = 0
    return line


def _u64_on_card(a: np.ndarray) -> torch.Tensor:
    """A numpy int64 or uint64 array on the card as int64 storage (the same bits)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64, copy=False)).cuda()


def _sim_jobs(draws, engine, backend):
    from repro_torch.sim.batch import BatchJob

    return [BatchJob.make(d["scenario"], d["params"], engine=engine, config=dict(array_backend=backend))
            for d in draws]


class _OpCalls:
    """Wraps an array-ops object's methods in place for one run: counts the
    calls that hand a kernel work (non-empty input), sums their host wall,
    and, when asked to, keeps each ``segment_scatter`` call's inputs and the
    largest ``scatter_add_u64`` call's (the buffer before and after) among
    the calls made from outside the wrapped methods: NumpyOps lands its
    segment scatter through its own ``scatter_add_u64``, which is not a
    stats flush."""

    NON_EMPTY = {
        "segment_scatter": lambda seg, lin, cnt, n_segs, row_size: len(seg) > 0 and n_segs > 0,
        "scatter_add_u64": lambda dense, lin, cnt: len(lin) > 0,
        "running_sum": lambda values: np.asarray(values).size > 0,
        "sorted_membership": lambda values, table: False,  # torch.searchsorted, no kernel of ours
    }

    def __init__(self, ops, keep_inputs: bool = False):
        self.ops, self.keep_inputs = ops, keep_inputs
        self.calls = {n: 0 for n in self.NON_EMPTY}
        self.kernel_calls = {n: 0 for n in self.NON_EMPTY}
        self.wall_s = {n: 0.0 for n in self.NON_EMPTY}
        self.landings = []  # (seg, lin, cnt, n_segs, row_size, table) of each segment_scatter call
        self.largest_flush = None  # (dense before, lin, cnt, dense after) of the largest scatter_add_u64 call
        self.flush_events = 0  # events the scatter_add_u64 calls made from outside landed
        self._depth = 0  # wrapped calls in progress

    def __enter__(self):
        for name, non_empty in self.NON_EMPTY.items():
            method = getattr(self.ops, name)

            def counted(*args, _name=name, _method=method, _non_empty=non_empty):
                before = None
                if _name == "scatter_add_u64" and self.keep_inputs and self._depth == 0 and len(args[1]) > (
                        len(self.largest_flush[1]) if self.largest_flush else 0):
                    before = args[0].copy()
                t0 = time.perf_counter()
                self._depth += 1
                try:
                    out = _method(*args)
                finally:
                    self._depth -= 1
                self.wall_s[_name] += time.perf_counter() - t0
                if before is not None:
                    self.largest_flush = (before, args[1].copy(), args[2].copy(), args[0].copy())
                if _name == "scatter_add_u64" and self._depth == 0:
                    self.flush_events += len(args[1])
                self.calls[_name] += 1
                self.kernel_calls[_name] += int(_non_empty(*args))
                if _name == "segment_scatter" and self.keep_inputs:
                    self.landings.append((*args, out))
                return out

            setattr(self.ops, name, counted)
        return self

    def __exit__(self, *exc):
        for name in self.NON_EMPTY:
            delattr(self.ops, name)  # the class's method shows through again


def phase_segment_kernel(smi: str):
    """The segment kernel, its accumulate entry and the fold kernel against
    their plain versions on the card, bit for bit, on test shapes and on the
    real landing inputs of the sweep, captured from the port's NumpyOps;
    then the segment kernel timed at the 64- and 2-draw landing shapes."""
    from repro_torch.core.array_ops import get_backend
    from repro_torch.kernels import segment_scatter as ss
    from repro_torch.kernels.ref import running_sum_ref, scatter_add_ref, segment_scatter_ref
    from repro_torch.perf.hw import chip_for
    from repro_torch.sim.batch import BatchRunner
    from repro_torch.sim.scenarios import divergent_draws

    # the real landings: the sweeps on the NumPy reference, their scatter inputs kept
    sweeps = {}
    for k in (SIM_DRAWS, SIM_SMALL_DRAWS):
        jobs = _sim_jobs(divergent_draws(k, seed=SIM_SEED), "event", "numpy")
        with _OpCalls(get_backend("numpy"), keep_inputs=True) as rec:
            t0 = time.perf_counter()
            result = BatchRunner(jobs, backend="batched").run()
            wall = time.perf_counter() - t0
        check(result.failures() == [] and rec.landings, f"numpy sweep at {k} draws: {result.failures()[:3]}")
        sweeps[k] = {"result": result, "wall_s": wall, "landings": rec.landings, "flush": rec.largest_flush}

    rng = np.random.default_rng(0)
    cases = []  # (label, seg, lin, cnt uint64, n_segs, row_size, numpy's table or None)
    for n, n_segs, row_size in SEG_SHAPES:
        r = np.random.default_rng(n_segs * row_size)
        cases.append((f"E{n}_({n_segs},{row_size})", r.integers(0, n_segs + 2, n), r.integers(0, row_size, n),
                      r.integers(1, 50, n).astype(np.uint64), n_segs, row_size, None))
    cases.append(("all_overflow", np.full(64, 9), np.zeros(64, np.int64), np.ones(64, np.uint64), 4, 16, None))
    cases.append(("empty", np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.uint64), 3, 5, None))
    big = np.where(rng.random(5000) < 0.5, np.uint64((1 << 64) - 1000), np.uint64((1 << 63) - 10))
    cases.append(("wraps_2^64", rng.integers(0, 5, 5000), rng.integers(0, 6, 5000), big, 4, 6, None))
    for k, sw in sweeps.items():
        for i, (seg, lin, cnt, n_segs, row_size, table) in enumerate(sw["landings"]):
            cases.append((f"sweep{k}_call{i}", seg, lin, cnt, n_segs, row_size, table))

    rows, max_err = [], 0
    for label, seg, lin, cnt, n_segs, row_size, np_table in cases:
        args = (_u64_on_card(seg), _u64_on_card(lin), _u64_on_card(cnt), n_segs, row_size)
        got, bad = ss.segment_scatter(*args)
        want, want_bad = segment_scatter_ref(*args)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        equal = bool(torch.equal(got, want)) and bad.item() == want_bad.item() == 0
        if np_table is not None:
            equal = equal and np.array_equal(got.cpu().numpy().view(np.uint64), np_table)
        max_err = max(max_err, err)
        rows.append({"case": label, "events": len(seg), "table": [n_segs, row_size], "equal": equal,
                     "nonzero_cells": int(torch.count_nonzero(want))})
        check(equal, f"segment kernel differs from segment_scatter_ref (and NumPy) on {label}")

    # the accumulate entry into a caller's buffer, and the fold kernel
    lin = rng.integers(0, 100_000, 400_000)
    cnt = np.where(rng.random(400_000) < 0.5, np.uint64((1 << 64) - 3), rng.integers(1, 9, 400_000).astype(np.uint64))
    base = _u64_on_card(rng.integers(0, 1 << 62, 100_000))
    dense, want = base.clone(), base.clone()
    bad = ss.scatter_add(dense, _u64_on_card(lin), _u64_on_card(cnt))
    scatter_add_ref(want, _u64_on_card(lin), _u64_on_card(cnt))
    check(torch.equal(dense, want) and bad.item() == 0, "accumulate entry differs from scatter_add_ref")
    fold = []
    for shape in ((7367,), (300, 9), (64, 3), (1,)):
        vals = rng.uniform(-1.0, 1.0, size=shape) * (10.0 ** rng.integers(-8, 8, size=shape))
        ints = rng.integers(-(1 << 62), 1 << 62, size=shape)
        for a in (vals, ints):
            got = ss.running_sum(torch.from_numpy(a).cuda())
            equal = torch.equal(got, running_sum_ref(torch.from_numpy(a).cuda()))
            equal = equal and np.array_equal(got.cpu().numpy(), np.add.accumulate(a, axis=0))
            fold.append({"shape": list(shape), "dtype": str(a.dtype), "equal": bool(equal)})
            check(equal, f"fold kernel differs from running_sum_ref / np.add.accumulate at {shape} {a.dtype}")

    # timing at the landing shapes of the 64- and 2-draw sweeps (their largest call: the cumulative table)
    chip = chip_for(smi)
    torch_ops, numpy_ops = get_backend("torch"), get_backend("numpy")
    timings = {}
    for k, sw in sweeps.items():
        seg, lin, cnt, n_segs, row_size, np_table = max(sw["landings"], key=lambda c: len(c[0]))
        seg_d, lin_d, cnt_d = _u64_on_card(seg), _u64_on_card(lin), _u64_on_card(cnt)
        keep = seg < n_segs
        flat_d, kept_d = _u64_on_card(seg[keep] * row_size + lin[keep]), _u64_on_card(cnt[keep])
        size = n_segs * row_size

        def library():
            return torch.zeros(size, dtype=torch.int64, device="cuda").index_add_(0, flat_d, kept_d)

        check(np.array_equal(library().cpu().numpy().view(np.uint64), np_table.reshape(-1)),
              f"index_add_ does not compute the landing at {k} draws")
        ms = time_interleaved({
            "kernel": lambda: ss.segment_scatter(seg_d, lin_d, cnt_d, n_segs, row_size),
            "plain": lambda: segment_scatter_ref(seg_d, lin_d, cnt_d, n_segs, row_size),
            "library": library,
        }, eager=("plain",))
        host = {"torch": [], "numpy": []}
        for _ in range(HOST_ROUNDS):
            for name, o in (("torch", torch_ops), ("numpy", numpy_ops)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = o.segment_scatter(seg, lin, cnt, n_segs, row_size)
                host[name].append((time.perf_counter() - t0) * 1e3)
                check(np.array_equal(out, np_table), f"{name} op differs from numpy's landing at {k} draws")
        nbytes = 24 * len(seg) + 8 * size
        t_bytes = nbytes / chip.hbm_bw * 1e3
        flat = seg[keep] * row_size + lin[keep]
        per_cell = np.bincount(np.unique(flat, return_inverse=True)[1])
        timings[f"draws{k}"] = {
            "events": len(seg), "n_segs": n_segs, "row_size": row_size, "table_bytes": 8 * size,
            "touched_cells": int(per_cell.size), "busiest_cell_events": int(per_cell.max()),
            "share_of_unit_counts": float((cnt == 1).mean()),
            "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"],
            "library_ms": ms["library"]["median"], "bound_ms": t_bytes, "bound_by": "bytes", "bytes": nbytes,
            "op_wall_ms_with_copies": statistics.median(host["torch"]),
            "numpy_op_wall_ms_host": statistics.median(host["numpy"]),
            "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()},
            "host_readings_ms": host,
        }
        del seg_d, lin_d, cnt_d, flat_d, kept_d

    # the accumulate entry on the largest stats flush of the SIM_DRAWS sweep, beside index_add_
    before, lin, cnt, after = sweeps[SIM_DRAWS]["flush"]
    lin_d, cnt_d, base = _u64_on_card(lin), _u64_on_card(cnt), _u64_on_card(before)
    got, lib_out = base.clone(), base.clone()
    bad = ss.scatter_add(got, lin_d, cnt_d)
    lib_out.index_add_(0, lin_d, cnt_d)
    for name, out in (("accumulate entry", got), ("index_add_", lib_out)):
        check(np.array_equal(out.cpu().numpy().view(np.uint64), after), f"{name} differs from numpy's largest flush")
    check(bad.item() == 0, "accumulate entry counted out-of-buffer indices on the largest flush")
    dense_k, dense_p, dense_l = base.clone(), base.clone(), base.clone()
    ms = time_interleaved({
        "kernel": lambda: ss.scatter_add(dense_k, lin_d, cnt_d),
        "plain": lambda: scatter_add_ref(dense_p, lin_d, cnt_d),
        "library": lambda: dense_l.index_add_(0, lin_d, cnt_d),
    }, eager=("plain",))
    touched = int(np.unique(lin).size)
    nbytes = 16 * len(lin) + 16 * touched
    accumulate = {
        "events": len(lin), "buffer_cells": int(before.size), "touched_cells": touched,
        "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"], "library_ms": ms["library"]["median"],
        "bound_ms": nbytes / chip.hbm_bw * 1e3, "bound_by": "bytes", "bytes": nbytes,
        "spread_ms": {name: [m["min"], m["max"]] for name, m in ms.items()},
    }
    del lin_d, cnt_d, base, got, lib_out, dense_k, dense_p, dense_l
    emit({"phase": "segment_kernel", "name": "segment_scatter", "cases": rows, "max_abs_err": max_err,
          "accumulate_entry_equal": True, "fold": fold, "tolerance": "exact equality (uint64 mod 2^64)",
          "peaks": {"hbm_bytes_s": chip.hbm_bw, "source": f"{chip.name} datasheet (repro_torch.perf.hw)"},
          "bound": "(24 bytes per event + 8 per table cell, the zero fill included) / HBM rate",
          "timing": timings, "accumulate_entry": accumulate,
          "timing_note": f"median of {ROUNDS} readings of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) calls each "
                         "between CUDA events; kernel and index_add_ (zero fill + one index_add_ of the kept events' "
                         "precomputed flat index) replayed from a CUDA graph, the plain version (its boolean mask "
                         f"syncs) run eagerly; inputs warm in L2; op walls are host-clock medians of {HOST_ROUNDS} "
                         "calls of TorchOps / NumpyOps.segment_scatter, numpy in and out; the accumulate entry and "
                         f"index_add_ add the {SIM_DRAWS}-draw sweep's largest flush into their own copy of its "
                         "buffer, in place, call after call (bound: 16 bytes an event + 16 a touched cell)",
          "numpy_sweep_wall_s": {str(k): sw["wall_s"] for k, sw in sweeps.items()}})
    ss.segment_scatter.launches = ss.scatter_add.launches = ss.running_sum.launches = 0
    return max_err, timings, accumulate, sweeps[SIM_DRAWS]


#: step_cost: deepseek-7b at its published size, uncut (30 layers, d_model 4096, 32 heads of 128, bf16,
#: 6.91 B parameters, ~13.8 GB of weights), a prefill and a decode cell from ``launch.steps.build_cell`` on
#: the one-rank (data 1, model 1) mesh.  The production SHAPES are sized for 256 chips (prefill_32k: 32 rows
#: of 32,768 tokens; decode_32k: 128 rows against a 32,768-token cache), which one card holds neither of, so
#: the cells keep their kinds at 4 rows of 2,048 tokens (prefill) and 4 rows against a 2,048-token cache
#: (decode).  Weights, tokens and the cache from STEP_COST_SEED (``launch.steps.materialize``).
STEP_COST_ARCH, STEP_COST_SEED = "deepseek-7b", 7
STEP_COST_SHAPES = (("prefill_2k", 2048, 4, "prefill"), ("decode_2k", 2048, 4, "decode"))
#: the counted prefill replayed as simulator kernels (``sim.hlo_costs.kernels_from_summary``) on concurrent
#: streams, as benchmarks/fig5_deepbench.py replays the reference's compiled step
STEP_COST_KERNELS, STEP_COST_STREAMS, STEP_COST_REPEATS = 8, 2, 8
#: the replay's cycle cap: the counted prefill is ~1.0e14 FLOPs, ~4.9e8 cycles of the simulated chip's
#: compute per stream, past SimConfig's default cap of 5e7; the event engine jumps from event to event, so
#: the cap costs nothing, and each kernel still lands at most SimConfig.max_synth_beats beats
STEP_COST_MAX_CYCLES = 10**11
#: top kernels of a step's device profile printed
STEP_COST_TOP = 8


def _sim_replay(kernels, backend):
    """``deepbench_like_workload`` of ``kernels`` on STEP_COST_STREAMS streams
    with ``array_backend=backend``: the result, its host wall, and the
    array-ops calls that handed a kernel work (``_OpCalls``)."""
    from repro_torch.core.array_ops import get_backend
    from repro_torch.sim import SimConfig, deepbench_like_workload

    with _OpCalls(get_backend(backend), keep_inputs=backend == "numpy") as rec:
        t0 = time.perf_counter()
        res = deepbench_like_workload(kernels, n_streams=STEP_COST_STREAMS, repeats=STEP_COST_REPEATS,
                                      config=SimConfig(array_backend=backend, max_cycles=STEP_COST_MAX_CYCLES))
        wall = time.perf_counter() - t0
    return res, wall, rec


def _fig5_checks(res):
    """What benchmarks/fig5_deepbench.py checks of a multi-stream replay."""
    agg = res.stats.aggregate()
    per_stream = {s: int(res.stats.stream_matrix(s).sum()) for s in res.stats.streams()}
    return per_stream, {
        "sum_tip>=clean": bool(np.all(agg.astype(np.int64) >= res.clean.matrix().astype(np.int64))),
        "per_stream_sums_to_agg": sum(per_stream.values()) == int(agg.sum()),
        "all_streams_tracked": len(per_stream) == STEP_COST_STREAMS,
        "overlap_tracked": res.timeline.overlap_cycles(*list(per_stream)[:2]) > 0,
    }


def phase_step_cost(smi: str):
    """deepseek-7b's full-width prefill and decode cells from ``build_cell``
    on a one-rank NCCL mesh: each counted by ``perf.cost`` on fake card
    tensors and on fake CPU tensors (equal), run once as the main path
    (every prefill attention on the bf16 ``wgmma`` flash kernel), profiled
    warm (``perf.cost.device_profile``) and put on the roofline of the card
    nvidia-smi names; the flash kernel held against its plain version and
    timed beside SDPA at the prefill's shape; then the counted prefill
    replayed as simulator kernels on two streams, the landings on the CUDA
    segment scatter and on NumPy (fig5's checks, the same counts, launches
    equal to calls), and the accumulate entry timed at the replay's largest
    flush beside ``index_add_``.  Returns the prefill's flash launches, the
    phase's kernel rows and the replay's scatter launches."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_scatter as ss
    from repro_torch.kernels.ref import scatter_add_ref
    from repro_torch.launch.mesh import make_tiny_mesh
    from repro_torch.launch.steps import build_cell, materialize
    from repro_torch.perf import chip_for, count_cell, device_profile, roofline_from_summary
    from repro_torch.sim import SimConfig, kernels_from_summary

    cfg = get_config(STEP_COST_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
          == (30, 4096, 32, 32, 128, 11008, 102400), "deepseek-7b's published size")
    chip = chip_for(smi)
    cells, summaries = {}, {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_tiny_mesh(data=1, model=1)
        for name, seq, batch, kind in STEP_COST_SHAPES:
            shape = ShapeConfig(name, seq, batch, kind)
            cell = build_cell(STEP_COST_ARCH, cfg, shape, mesh)
            check(cell.step_name == {"prefill": "prefill_step", "decode": "serve_step"}[kind] and cell.chips == 1,
                  f"{name}: {cell.step_name} on {cell.chips} chips")
            args = materialize(cell, "cuda", STEP_COST_SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = count_cell(cell, args=args)
            count_s = time.perf_counter() - t0
            host = count_cell(cell, device="cpu")
            same = (card.to_dict() == host.to_dict() and card.parts == host.parts
                    and card.launches == host.launches)
            check(same, f"{name}: the fake card count {card.to_dict()} {card.parts} differs from the fake CPU "
                        f"count {host.to_dict()} {host.parts}")

            # the main path: one call of the cell's step, its launches counted from 0
            fa.flash_attention.launches = 0
            fa.flash_attention.shapes.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cell.fn(*args)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            launches, shapes = fa.flash_attention.launches, dict(fa.flash_attention.shapes)
            logits = out[0]
            V = cfg.padded_vocab
            check(logits.shape == (batch, V) and bool(torch.isfinite(logits).all()),
                  f"{name}: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
            if kind == "prefill":
                cache = out[1]
                check({k: tuple(v.shape) for k, v in cache.items()}
                      == {k: (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim) for k in ("k", "v")}
                      and all(bool(torch.isfinite(v).all()) for v in cache.values()), f"{name}: prefill cache")
                want = fa.FlashLaunch(batch, seq, seq, cfg.n_heads, cfg.n_kv_heads, 128, 128, True, 0, 2)
                check(launches == cfg.n_layers and shapes == {want: cfg.n_layers}
                      and fa.select_route(torch.bfloat16, 128) == "wgmma",
                      f"{name}: flash launches {launches} by shape {shapes}; want {cfg.n_layers} bf16 at {want}")
                check(card.launches["flash_forward"] == {want: cfg.n_layers},
                      f"{name}: the count's flash launches {card.launches['flash_forward']}")
            else:
                check(launches == 0, f"{name}: a decode step launched the flash kernel {launches} times")
            del out, logits

            try:
                prof = device_profile(lambda: cell.fn(*args), wall_rounds=HOST_ROUNDS)
            except RuntimeError as err:
                raise CheckFailed(f"{name}: {err}") from err
            BREAKDOWN_LEAD_MS.append(prof["lead_ms"])
            BREAKDOWN_RETAKEN.extend(prof["retaken_margins_s"])
            fa.flash_attention.launches = 0  # the profile's calls are not the main path's
            fa.flash_attention.shapes.clear()
            wall_s = prof["wall_ms"] / 1e3
            roof = roofline_from_summary(card, arch=STEP_COST_ARCH, shape=name, mesh="1x1", chips=1,
                                         model_flops_total=cell.model_flops, chip=chip)
            top = sorted(prof["us_by_kernel"].items(), key=lambda kv: -kv[1])[:STEP_COST_TOP]
            cells[name] = {
                "step": cell.step_name, "rows": batch, "seq": seq, "tokens": shape.tokens,
                "count_s": count_s, "counted": {**card.to_dict(), "parts": card.parts},
                "fake_card_count_equals_fake_cpu_count": True,
                "flash_forward_launches": launches,
                "flash_routes": {"wgmma": launches} if launches else {},
                "first_call_ms": first_ms, "step_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
                "idle_share": prof["idle_share"], "device_events": prof["device_events"],
                "top_kernels_ms": {k: v / 1e3 for k, v in top},
                "roofline": {**roof.to_dict(), "chip": chip.name,
                             "model_flops_over_peak_times_step": cell.model_flops
                             / (chip.peak_bf16_flops * wall_s)},
                "model_flops": cell.model_flops,
                "counted_over_2N_tokens": card.flops_per_device / cell.model_flops,
            }
            summaries[name] = card
            del args
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # the flash forward at the prefill's shape: held against its plain version, timed beside SDPA
    _, seq, batch, _ = STEP_COST_SHAPES[0]
    H, D = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = (randn((batch, seq, H, D), torch.bfloat16, 700 + j) for j in range(3))
    got, want = ops.flash_attention(q, k, v, causal=True), ops.flash_attention(q, k, v, causal=True, impl="plain")
    torch.cuda.synchronize()
    flash_err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), **BF16_TOL), f"flash kernel disagrees with plain at {q.shape}")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = time_interleaved({
        "kernel": lambda: ops.flash_attention(q, k, v, causal=True),
        "plain": lambda: ops.flash_attention(q, k, v, causal=True, impl="plain"),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
    }, eager=("plain",))  # the plain version's 2 GB of fp32 scores a call, eager: not 50 of them in one graph
    flops, nbytes = fa.flash_flops(batch, seq, seq, H, D, causal=True), fa.flash_bytes(batch, seq, seq, H, H, D, 2)
    bound_ms, bound_by = _bound(flops, nbytes, smi)
    flash_row = {"shape": f"B={batch} S={seq} Hq=Hkv={H} D={D} bf16 causal (the prefill cell's)", "route": "wgmma",
                 "max_abs_err": flash_err, "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"],
                 "library_ms": ms["library"]["median"], "bound_ms": bound_ms, "bound_by": bound_by,
                 "kernel_tflops": flops / (ms["kernel"]["median"] * 1e-3) / 1e12,
                 "spread_ms": {n: [m["min"], m["max"]] for n, m in ms.items()}}
    fa.flash_attention.launches = 0
    fa.flash_attention.shapes.clear()
    del q, k, v, qh, kh, vh, got, want

    # the counted prefill replayed on two simulated streams: CUDA landings, then NumPy's
    kernels = kernels_from_summary(summaries["prefill_2k"], "deepseek7b_prefill", n_kernels=STEP_COST_KERNELS)
    ss.segment_scatter.launches = ss.scatter_add.launches = 0
    res, wall, rec = _sim_replay(kernels, "torch")
    scatter = {"segment_scatter": ss.segment_scatter.launches, "scatter_add_u64": ss.scatter_add.launches}
    calls = {n: rec.kernel_calls[n] for n in scatter}
    check(scatter == calls and scatter["scatter_add_u64"] >= 1, f"replay: launches {scatter}, calls {calls}")
    np_res, np_wall, np_rec = _sim_replay(kernels, "numpy")
    # each synthesized kernel lands at most max_synth_beats (+ one partial beat of each kind) beats, each
    # an event on the tip and on the clean view, however many bytes it stands for
    beat_bound = 2 * STEP_COST_KERNELS * (SimConfig().max_synth_beats + 3)
    check(rec.flush_events == np_rec.flush_events <= beat_bound,
          f"replay landed {rec.flush_events} / {np_rec.flush_events} events, bound {beat_bound}")
    per_stream, checks = _fig5_checks(res)
    np_per_stream, _ = _fig5_checks(np_res)
    check(all(checks.values()), f"replay on the card fails fig5's checks: {checks}")
    check(res.signature() == np_res.signature() and per_stream == np_per_stream
          and np.array_equal(res.stats.aggregate(), np_res.stats.aggregate()),
          f"replay: the card's counts {per_stream} differ from NumPy's {np_per_stream}")
    replay = {"kernels": STEP_COST_KERNELS, "streams": STEP_COST_STREAMS, "repeats": STEP_COST_REPEATS,
              "cycles": res.cycles, "per_stream_accesses": {str(s): n for s, n in per_stream.items()},
              "checks": checks, "numpy_counts_equal": True, "launches": scatter, "calls": calls,
              "wall_s": wall, "numpy_wall_s": np_wall, "landed_events": rec.flush_events,
              "landed_events_bound": beat_bound,
              "kernel_hbm_rd_bytes": kernels[0].hbm_rd_bytes, "kernel_flops": kernels[0].flops}
    ss.segment_scatter.launches = ss.scatter_add.launches = 0

    # the accumulate entry (the replay's landing) at the replay's largest flush, beside index_add_
    before, lin, cnt, after = np_rec.largest_flush
    lin_d, cnt_d, base = _u64_on_card(lin), _u64_on_card(cnt), _u64_on_card(before)
    got = base.clone()
    bad = ss.scatter_add(got, lin_d, cnt_d)
    check(np.array_equal(got.cpu().numpy().view(np.uint64), after) and bad.item() == 0,
          "accumulate entry differs from NumPy's largest replay flush")
    dense_k, dense_p, dense_l = base.clone(), base.clone(), base.clone()
    ms = time_interleaved({
        "kernel": lambda: ss.scatter_add(dense_k, lin_d, cnt_d),
        "plain": lambda: scatter_add_ref(dense_p, lin_d, cnt_d),
        "library": lambda: dense_l.index_add_(0, lin_d, cnt_d),
    }, eager=("plain",))
    touched = int(np.unique(lin).size)
    nbytes = 16 * len(lin) + 16 * touched
    scatter_row = {"shape": f"{len(lin)} events into {before.size} cells (the replay's largest flush)",
                   "events": len(lin), "buffer_cells": int(before.size), "touched_cells": touched,
                   "max_abs_err": 0, "kernel_ms": ms["kernel"]["median"], "plain_ms": ms["plain"]["median"],
                   "library_ms": ms["library"]["median"], "bound_ms": nbytes / chip.hbm_bw * 1e3,
                   "bound_by": "bytes", "spread_ms": {n: [m["min"], m["max"]] for n, m in ms.items()}}
    ss.scatter_add.launches = 0
    del lin_d, cnt_d, base, got, dense_k, dense_p, dense_l
    emit({"phase": "step_cost", "config": STEP_COST_ARCH, "n_layers": cfg.n_layers, "mesh": "(data 1, model 1), "
          "one-rank NCCL", "seed": STEP_COST_SEED, "chip": chip.name, "cells": cells, "flash_at_prefill": flash_row,
          "replay": replay, "accumulate_at_replay_flush": scatter_row,
          "counted_by": summaries["prefill_2k"].counted_by,
          "timing_note": f"step_ms: host-clock median of {HOST_ROUNDS} warm calls, each synchronised; busy and "
                         "top kernels from one torch.profiler trace of a further call; kernel rows: median of "
                         f"{ROUNDS} readings of {LAUNCHES} ({PLAIN_LAUNCHES} plain or slow) calls replayed from a "
                         "CUDA graph (the plain versions eager), inputs warm in L2"})
    return cells["prefill_2k"]["flash_forward_launches"], flash_row, scatter_row, scatter


#: sharded_steps (and scripts/multi_card_dist.py's steps part, which reads this table): build_cell's steps with
#: their inputs placed as DTensors (``launch.steps.place``) on the
#: one-rank (data 1, model 1) NCCL mesh, each held against the same cell's plain-tensor step from the same
#: seed: deepseek-7b's step_cost cells uncut, its published width cut to 8 layers trained
#: one step of 4 rows of 2,048 tokens in 2 microbatches, and mamba2-130m's train cell at its published
#: widths at the same shape, cut to 12 of its 24 layers as train_full_width's, which keeps the phase near a
#: minute (its DTensor step is host-bound); deepseek-v2-lite's prefill and decode uncut (15.7 B parameters,
#: ~31 GB in bf16, served uncut since moe_full_width) and its train cell at moe_train_full_width's cut of 4
#: layers; llama4-scout's prefill and decode at its widths cut to 8 of 48 layers (~19.7 B parameters, ~39 GB);
#: whisper-medium (24 encoder and 24 decoder layers; its prefill and train cells' 2,048 frame embeddings) and
#: paligemma-3b (18 layers, MQA at head dim 256 after 256 vision tokens) uncut, all three cells; jamba's
#: prefill and decode at its widths cut to 5 layers, the shallowest cut with an SSM layer, two MoE layers and
#: the attention layer at position 4 (~24 B parameters, ~48 GB: the plain step and the DTensor step run one
#: after the other, the first freed before the second draws its inputs), and its train cell at
#: jamba_train_full_width's first layer (~146 GB of weights and states at 2).
#: The last field is the depth of the cell on four cards (scripts/multi_card_dist.py), where rank 0 also runs
#: the cell's one-card step in fp32, which must fit one card: deepseek-v2-lite at 8 layers (2 for training),
#: llama4-scout at 2 (~79 GB in fp32 at 8) and jamba's prefill and decode at 2 (an SSM layer and an MoE layer,
#: ~49 GB in fp32; ~96 GB at 5).  (arch, shape name, seq, rows, kind, layers or None for all, layers on four
#: cards or None for the same)
SHARDED_CELLS = (("deepseek-7b", "prefill_2k", 2048, 4, "prefill", None, None),
                 ("deepseek-7b", "decode_2k", 2048, 4, "decode", None, None),
                 ("deepseek-7b", "train_2k", 2048, 4, "train", 8, None),
                 ("mamba2-130m", "train_2k", 2048, 4, "train", 12, None),
                 ("deepseek-v2-lite-16b", "prefill_2k", 2048, 4, "prefill", None, 8),
                 ("deepseek-v2-lite-16b", "decode_2k", 2048, 4, "decode", None, 8),
                 ("deepseek-v2-lite-16b", "train_2k", 2048, 4, "train", 4, 2),
                 ("llama4-scout-17b-a16e", "prefill_2k", 2048, 4, "prefill", 8, 2),
                 ("llama4-scout-17b-a16e", "decode_2k", 2048, 4, "decode", 8, 2),
                 ("whisper-medium", "prefill_2k", 2048, 4, "prefill", None, None),
                 ("whisper-medium", "decode_2k", 2048, 4, "decode", None, None),
                 ("whisper-medium", "train_2k", 2048, 4, "train", None, None),
                 ("paligemma-3b", "prefill_2k", 2048, 4, "prefill", None, None),
                 ("paligemma-3b", "decode_2k", 2048, 4, "decode", None, None),
                 ("paligemma-3b", "train_2k", 2048, 4, "train", None, None),
                 ("jamba-1.5-large-398b", "prefill_2k", 2048, 4, "prefill", 5, 2),
                 ("jamba-1.5-large-398b", "decode_2k", 2048, 4, "decode", 5, 2),
                 ("jamba-1.5-large-398b", "train_2k", 2048, 4, "train", 1, None))
#: the cell whose MoE op runs once more under torch.cuda.set_sync_debug_mode("error")
SYNC_FREE_CELL = ("llama4-scout-17b-a16e", "decode_2k")
SHARDED_SEED, SHARDED_MICRO = 7, 2
#: the sharded steps' process is killed after this (it takes ~200 s, its start included)
SHARDED_TIMEOUT_S = 600
#: elements a digest reads at once (its int64 products: 512 MB)
DIGEST_CHUNK = 1 << 26


def _digest(t) -> int:
    """An exact fingerprint of a tensor's bits on the card: its words as
    int64, each times its index mod a prime plus one, summed mod 2**64
    (integer sums are exact in any order, so equal bits give equal digests
    and a changed word changes it)."""
    from repro_torch.launch.dtensors import local

    t = local(t).detach().contiguous().reshape(-1)
    words = t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for i in range(0, words.numel(), DIGEST_CHUNK):
        w = words[i:i + DIGEST_CHUNK].long()
        total += (w * (torch.arange(i, i + w.numel(), device=t.device) % 1_000_003 + 1)).sum()
    return int(total)


def _digests(tree, path=""):
    """``{path: digest}`` of every tensor leaf of nested dicts, tuples and
    lists (the leaves of a step's outputs), and Python numbers as they are."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _digests(sub, f"{path}.{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree) for k, v in _digests(sub, f"{path}[{i}]").items()}
    return {path: _digest(tree) if isinstance(tree, torch.Tensor) else float(tree)}


def expected_kernels(cfg, kind: str):
    """The kernels a cell of ``kind`` launches on the card: the flash forward
    where the config has an attention layer (an enc-dec model's encoder and
    cross attention too) and the backward where it trains; the SSD scan
    where it has an SSM layer; nothing in a decode step."""
    if kind == "decode":
        return ()
    attn = any(cfg.layer_is_attn(i) for i in range(cfg.n_layers)) or cfg.encdec
    ssm = cfg.ssm is not None and not all(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
    return (("flash_forward",) if attn else ()) + (("flash_backward",) if attn and kind == "train" else ()) + \
        (("ssd_scan",) if ssm else ())


def kernel_launches():
    """The flash forward, flash backward and SSD scan wrappers' launch counts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk

    return {"flash_forward": fa.flash_attention.launches, "flash_backward": fa.flash_attention_backward.launches,
            "ssd_scan": sk.ssd_scan.launches}


def launch_routes():
    """The flash forward, flash backward and SSD scan wrappers' launches by
    the route each launched, as its wrapper counted them at the launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk

    return {"flash_forward": dict(fa.flash_attention.routes),
            "flash_backward": dict(fa.flash_attention_backward.routes), "ssd_scan": dict(sk.ssd_scan.routes)}


def zero_launches():
    """Every count :func:`kernel_launches` and :func:`launch_routes` read set
    to 0 (and the flash wrappers' recorded shapes cleared)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk

    fa.flash_attention.launches = fa.flash_attention_backward.launches = sk.ssd_scan.launches = 0
    for counter in (fa.flash_attention.shapes, fa.flash_attention_backward.shapes, fa.flash_attention.routes,
                    fa.flash_attention_backward.routes, sk.ssd_scan.routes):
        counter.clear()


def _step_run(cell, args, smi):
    """One main-path call of ``cell``'s step on ``args`` (launches counted
    from 0, peak memory from a reset), then a warm profile of further calls
    (``perf.cost.device_profile``: the median of HOST_ROUNDS warm
    host-clock readings, busy ms, idle share);
    returns its numbers and the first call's output digests."""
    from repro_torch.launch.dtensors import local
    from repro_torch.perf import device_profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = cell.fn(*args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches, routes = kernel_launches(), launch_routes()
    digests = _digests(out)
    probe = out[2]["loss"] if cell.step_name == "train_step" else out[0]  # the loss, or the logits
    finite = bool(torch.isfinite(local(probe)).all())
    del out, probe
    try:
        prof = device_profile(lambda: cell.fn(*args), wall_rounds=HOST_ROUNDS)
    except RuntimeError as err:
        raise CheckFailed(f"sharded_steps {cell.step_name}: {err}") from err
    BREAKDOWN_LEAD_MS.append(prof["lead_ms"])
    BREAKDOWN_RETAKEN.extend(prof["retaken_margins_s"])
    zero_launches()  # the profile's calls are not the main path's
    return {"first_call_ms": first_ms, "step_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
            "idle_share": prof["idle_share"], "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "routes": routes, "finite": finite, "smi": smi}, digests


def _moe_makes_no_host_sync(cell, args):
    """One more call of ``cell``'s step with the MoE op's local part (the
    router and the dispatch and combine on the rank's shards) run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any op that
    waits on the device.  Returns how many local calls ran so."""
    from repro_torch.models import moe

    real = {name: getattr(moe, name) for name in ("router_topk", "_dispatch_combine")}
    calls = []

    def strict(fn):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            calls.append(fn.__name__)
            return out

        return run

    for name, fn in real.items():
        setattr(moe, name, strict(fn))
    try:
        cell.fn(*args)
        torch.cuda.synchronize()
    except RuntimeError as err:
        raise CheckFailed(f"sharded_steps {cell.arch} {cell.shape.name}: the MoE op synchronised: {err}") from err
    finally:
        for name, fn in real.items():
            setattr(moe, name, fn)
    return len(calls)


def phase_sharded_steps(smi: str):
    """build_cell's steps on a one-rank NCCL mesh with DTensor inputs
    (``launch.steps.place`` at ``cell.in_shardings``), each against the
    plain-tensor step of the same cell and seed: every output leaf (logits,
    cache, updated parameters and moments, metrics) bit for bit by an exact
    digest, the kernels' launches equal (the DTensor run launches each
    kernel on its local shard), and each run's first-call ms, warm step ms,
    busy ms, idle share and peak memory beside the card's name and power
    limit.  Returns the sharded runs' launches by kernel."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_tiny_mesh
    from repro_torch.launch.shardings import PlanOverrides
    from repro_torch.launch.steps import build_cell, materialize, place

    cells, total = {}, {"flash_forward": 0, "flash_backward": 0, "ssd_scan": 0}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_tiny_mesh(data=1, model=1)
        for arch, name, seq, rows, kind, layers, _ in SHARDED_CELLS:
            t0 = time.perf_counter()
            cfg = get_config(arch)
            if layers is not None:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            over = PlanOverrides(microbatches=SHARDED_MICRO) if kind == "train" else PlanOverrides()
            cell = build_cell(arch, cfg, ShapeConfig(name, seq, rows, kind), mesh, overrides=over)
            plain, plain_digests = _step_run(cell, materialize(cell, "cuda", SHARDED_SEED), smi)
            torch.cuda.empty_cache()
            placed = place(cell, materialize(cell, "cuda", SHARDED_SEED))
            sharded, digests = _step_run(cell, placed, smi)
            if (arch, name) == SYNC_FREE_CELL:
                sharded["sync_free_moe_calls"] = _moe_makes_no_host_sync(cell, placed)
                check(sharded["sync_free_moe_calls"] == 2 * cfg.n_layers,
                      f"sharded_steps {arch} {name}: {sharded['sync_free_moe_calls']} MoE calls ran sync-free, "
                      f"want {2 * cfg.n_layers}")
            del placed
            torch.cuda.empty_cache()
            differ = sorted(k for k in plain_digests if digests.get(k) != plain_digests[k])
            key = f"{arch} {name}" + (f" ({layers} layers)" if layers else "")
            check(sorted(digests) == sorted(plain_digests) and not differ,
                  f"sharded_steps {key}: the DTensor step differs from the plain one at {differ[:8]}")
            check(sharded["launches"] == plain["launches"] and sharded["finite"] and plain["finite"],
                  f"sharded_steps {key}: launches {sharded['launches']} against the plain step's "
                  f"{plain['launches']}; finite {sharded['finite']} / {plain['finite']}")
            want = expected_kernels(cfg, kind)
            check(all(sharded["launches"][k] > 0 for k in want) and all(
                sharded["launches"][k] == 0 for k in total if k not in want),
                  f"sharded_steps {key}: launches {sharded['launches']}, want {want} launched")
            check(sharded["routes"] == plain["routes"] and all(list(sharded["routes"][k]) == ["wgmma"] for k in want),
                  f"sharded_steps {key}: routes {sharded['routes']} (plain {plain['routes']}), want wgmma")
            for k in total:
                total[k] += sharded["launches"][k]
            cells[key] = {"step": cell.step_name, "rows": rows, "seq": seq, "n_layers": cfg.n_layers,
                          "microbatches": SHARDED_MICRO if kind == "train" else None,
                          "bit_for_bit": True, "leaves_compared": len(digests), "dtensor": sharded, "plain": plain,
                          "seconds": time.perf_counter() - t0}
    finally:
        dist.destroy_process_group()
    emit({"phase": "sharded_steps", "mesh": "(data 1, model 1), one-rank NCCL", "seed": SHARDED_SEED, "smi": smi,
          "cells": cells, "launches": total,
          "note": "each cell's step run twice from one seed: its inputs as plain tensors, then as DTensors placed "
                  "at cell.in_shardings; every output leaf compared by an exact digest of its bits; launches of "
                  "the first call of each (the main path's), then a warm profile (host-clock median of "
                  f"{HOST_ROUNDS} calls after a warm-up, and one torch.profiler trace); the DTensor run's kernels "
                  "launch on its local shards "
                  "(kernels/shards.py)"})
    return total


def phase_sharded_steps_apart(smi: str):
    """:func:`phase_sharded_steps` in a child process (this script with
    ``--sharded-steps``, its stdout read here, its stderr passed through),
    its phase line printed here and its launches returned.  The profiler's
    traces lose the events at the start of their window by more the longer
    the process has run (``perf.cost.device_profile`` retakes them at
    twice the margin): with its 36 traces (two a cell) second in this
    process, a later phase's trace lost them at every margin
    (``qwen2_full_width``, 339 s in), so the phase runs last, its traces
    in a fresh process, and every other phase runs earlier."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--sharded-steps", smi],
                          stdout=subprocess.PIPE, text=True, timeout=SHARDED_TIMEOUT_S)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    check(proc.returncode == 0 and lines and "sharded_steps_result" in lines[-1],
          f"sharded_steps: its process exited {proc.returncode}")
    for line in lines[:-1]:
        emit({**line, "parent_memory_reserved_gb": torch.cuda.memory_reserved() / 1e9})
    result = lines[-1]["sharded_steps_result"]
    BREAKDOWN_LEAD_MS.extend(result["lead_ms"])
    BREAKDOWN_RETAKEN.extend(result["retaken_margins_s"])
    return result["launches"]


def sharded_steps_child(smi: str) -> int:
    """The child of :func:`phase_sharded_steps_apart`: the phase's line,
    then its launches and the profiler's leads and retakes on the last."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = phase_sharded_steps(smi)
    print(json.dumps({"sharded_steps_result": {"launches": launches, "lead_ms": BREAKDOWN_LEAD_MS,
                                               "retaken_margins_s": BREAKDOWN_RETAKEN}}), flush=True)
    return 0


def phase_sim_sweep(numpy_sweep):
    """The simulator's batched divergent sweep over the full registry on the
    card, against the same jobs on NumPy; launches of each kernel equal the
    calls that handed it work.  Then the landing traced once for the device's
    busy time, and the compiled engine, whose running sums fold on the card."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.array_ops import get_backend
    from repro_torch.kernels import segment_scatter as ss
    import repro_torch.sim.batched as batched
    from repro_torch.sim.batch import BatchRunner
    from repro_torch.sim.compiled import TRACE_CACHE
    from repro_torch.sim.scenarios import divergent_draws, list_scenarios

    draws = divergent_draws(SIM_DRAWS, seed=SIM_SEED)
    ops = get_backend("torch")
    check(ops.device.type == "cuda", "array_backend='torch' must run on the card")
    land = batched._land
    timed = {}

    def timed_land(sims, o):
        t0 = time.perf_counter()
        land(sims, o)
        torch.cuda.synchronize()
        timed["land_s"] = time.perf_counter() - t0

    def traced_land(sims, o):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            land(sims, o)
            torch.cuda.synchronize()
            timed["traced_land_s"] = time.perf_counter() - t0
        timed["prof"] = prof

    def kernel_launches():
        return {"segment_scatter": ss.segment_scatter.launches, "scatter_add_u64": ss.scatter_add.launches,
                "running_sum": ss.running_sum.launches}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    jobs = _sim_jobs(draws, "event", "torch")
    batched._land = timed_land
    try:
        with _OpCalls(ops) as rec:
            ss.segment_scatter.launches = ss.scatter_add.launches = ss.running_sum.launches = 0
            t0 = time.perf_counter()
            result = BatchRunner(jobs, backend="batched").run()
            wall = time.perf_counter() - t0
            launches = kernel_launches()
    finally:
        batched._land = land
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(jobs) == SIM_DRAWS * len(list_scenarios()), f"{len(jobs)} jobs")
    check(result.failures() == [], f"failed jobs on the card: {result.failures()[:3]}")
    check(result.oracle_failures() == [], f"oracle failures: {result.oracle_failures()[:3]}")
    check(result.signature() == numpy_sweep["result"].signature(), "sweep on the card differs from NumPy's")
    want = {n: rec.kernel_calls[n] for n in ("segment_scatter", "scatter_add_u64", "running_sum")}
    check(launches == want, f"launches {launches} != calls that handed a kernel work {want}")
    check(launches["segment_scatter"] >= 1 and launches["scatter_add_u64"] >= 1, f"kernels not launched: {launches}")
    events = sum(len(c[0]) for c in numpy_sweep["landings"])

    # one more run of the same sweep, its landing traced (its launches are not counted above)
    batched._land = traced_land
    try:
        traced = BatchRunner(_sim_jobs(draws, "event", "torch"), backend="batched").run()
    finally:
        batched._land = land
    check(traced.failures() == [], "failed jobs in the traced sweep")
    prof = timed.pop("prof")
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = {}
    for e in dev:
        kind = "memcpy" if "Memcpy" in e.name else "memset" if "Memset" in e.name else e.name[:60]
        busy_us[kind] = busy_us.get(kind, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(busy_us.values()) / 1e3
    idle = {"device_busy_ms": busy_ms, "device_events": len(dev),
            "busy_ms_by_kind": {k: v / 1e3 for k, v in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]},
            "landing_wall_ms": timed["land_s"] * 1e3, "traced_landing_wall_ms": timed["traced_land_s"] * 1e3,
            "idle_share_of_landing": max(0.0, 1.0 - busy_ms / (timed["land_s"] * 1e3)) if dev else "not measured",
            "idle_share_of_sweep": max(0.0, 1.0 - busy_ms / (wall * 1e3)) if dev else "not measured"}

    # the compiled engine: its trace workloads fold bandwidth pointers through running_sum
    cdraws = divergent_draws(SIM_COMPILED_DRAWS, seed=SIM_SEED)
    compiled = {}
    for backend in ("torch", "numpy"):
        TRACE_CACHE.clear()  # both runs compile every shape
        with _OpCalls(ops) as crec:
            ss.segment_scatter.launches = ss.scatter_add.launches = ss.running_sum.launches = 0
            compiled[backend] = BatchRunner(_sim_jobs(cdraws, "compiled", backend), backend="batched").run()
            claunches = kernel_launches()
        if backend == "torch":
            ccalls = {n: crec.kernel_calls[n] for n in ("segment_scatter", "scatter_add_u64", "running_sum")}
            c_launches = claunches
    check(compiled["torch"].failures() == [] and compiled["torch"].oracle_failures() == [],
          "compiled-engine sweep on the card failed")
    check(compiled["torch"].signature() == compiled["numpy"].signature(), "compiled sweep: card differs from NumPy")
    check(c_launches == ccalls and c_launches["running_sum"] >= 1, f"compiled: launches {c_launches}, calls {ccalls}")

    emit({"phase": "sim_sweep", "draws": SIM_DRAWS, "seed": SIM_SEED, "jobs": len(jobs), "engine": "event",
          "array_backend": "torch", "scenarios": len(list_scenarios()), "signature_equal_numpy": True,
          "failed_jobs": 0, "oracle_failures": 0, "landing_events": events,
          "launches": launches, "calls": rec.calls, "op_wall_ms": {n: v * 1e3 for n, v in rec.wall_s.items()},
          "sweep_wall_s": wall, "numpy_sweep_wall_s": numpy_sweep["wall_s"],
          "landing_wall_s": timed["land_s"], "simulate_wall_s": wall - timed["land_s"],
          "max_memory_allocated_gb": peak_gb, "device_idle": idle,
          "compiled": {"draws": SIM_COMPILED_DRAWS, "jobs": len(cdraws), "signature_equal_numpy": True,
                       "launches": c_launches, "calls": ccalls}})
    ss.segment_scatter.launches = ss.scatter_add.launches = ss.running_sum.launches = 0
    return launches


def main() -> int:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_scatter as ss
    from repro_torch.kernels import ssd_scan as sk

    t_start = time.perf_counter()
    smi = phase_device()
    sass = phase_build()
    # first, in a fresh process: late in a long one the profiler loses whole sides of these phases' traces
    # (step_cost's prefill; jamba's SSD forward and backward, which lost them 4 times at 360 s in); the sharded
    # steps run last, in a fresh process of their own
    step_fwd, step_flash, step_scatter, replay_launches = phase_step_cost(smi)
    torch.cuda.empty_cache()
    jamba_train = phase_jamba_train_full_width()
    torch.cuda.empty_cache()
    bf16_err, timings, d256 = phase_kernel(smi, served_prompt_lens())
    mla = phase_mla_kernel(smi, served_prompt_lens(),
                           sass["flash_attention_wgmma"][f"flash_fwd_wgmma {_dims_label(MLA_DQK, MLA_DV)}"])
    phase_parity()
    phase_moe_parity()
    phase_hybrid_parity()
    launches, op_err = phase_full_width()
    torch.cuda.empty_cache()
    moe_full = phase_moe_full_width(smi)
    ssd_err, ssd_timings, p128 = phase_ssd_kernel(smi)
    hybrid_full = phase_hybrid_full_width(smi)
    qwen2_full = phase_qwen2_full_width(smi)
    phase_ssm_parity()
    model, ssd_launches, probe = phase_train_full_width()
    phase_decode_full_width(model)
    ssd_op_err = phase_ssd_op(model, probe)
    del model, probe
    bwd_timing, d256_bwd, bwd_err = phase_flash_bwd_kernel(smi)
    mla_bwd = phase_mla_bwd_kernel(smi, sass["flash_attention_bwd_wgmma"])
    prefix = phase_prefix_kernel(smi)
    d16 = phase_d16_kernel(smi)
    routes = phase_routes(smi, served_prompt_lens())
    phase_dense_parity()
    phase_moe_train_parity()
    phase_encdec_parity()
    phase_prefix_lm_parity()
    phase_qwen2_parity()
    phase_hybrid_train_parity()
    torch.cuda.empty_cache()
    dense_fwd, dense_bwd, dense_err, dense_line = phase_dense_train_full_width()
    torch.cuda.empty_cache()
    gemma_fwd, gemma_bwd, gemma_err = phase_gemma_train_full_width()
    torch.cuda.empty_cache()
    moe_fwd, moe_bwd, moe_err = phase_moe_train_full_width()
    torch.cuda.empty_cache()
    qwen2_fwd, qwen2_bwd, qwen2_err, _ = phase_qwen2_train_full_width()
    torch.cuda.empty_cache()
    encdec_fwd, encdec_bwd, encdec_err, encdec_serve = phase_encdec_full_width()
    torch.cuda.empty_cache()
    prefix_fwd, prefix_bwd, prefix_err, prefix_serve = phase_prefix_lm_full_width()
    torch.cuda.empty_cache()
    dist_fwd, dist_bwd, dist_err, pipe_fwd = phase_dist_full_width(dense_line)
    torch.cuda.empty_cache()
    seg_err, seg_timings, acc_timing, numpy_sweep = phase_segment_kernel(smi)
    seg_launches = phase_sim_sweep(numpy_sweep)
    torch.cuda.empty_cache()
    sharded = phase_sharded_steps_apart(smi)
    t = timings[512]
    mt = mla["timing"][str(max(served_prompt_lens()))]
    mla_launches = moe_full["flash_launches"]
    encdec_prefill, prefix_prefill = encdec_serve["prefill_flash_launches"], prefix_serve["prefill_flash_launches"]
    pt = prefix["timing"]

    def new_shapes(direction):  # the enc-dec and prefix-LM slice's rows, both dtypes at paligemma's shape
        keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        return {name: {"shape": pt[name]["shape"], "route": pt[name]["route"],
                       **{k: pt[name][direction][k] for k in keys}} for name in pt}

    def d16_rows(direction):  # head dim 16's rows: the kernels at 32 on zero-padded copies, copies included
        keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        return {"padded_to": d16["padded_to"],
                **{name: {"shape": r["shape"], "route": r["route"], **{k: r[direction][k] for k in keys}}
                   for name, r in d16["timing"].items()}}

    st = ssd_timings["B4_S256"]
    gt = seg_timings[f"draws{SIM_DRAWS}"]
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": fa.SOURCE, "replaces": fa.REPLACES,
        "design": "bf16 at every head dim (32-256): one warpgroup per 64-row query tile; S = Q K^T and O += P V "
                  "on wgmma (bf16 in, fp32 accumulate; P from registers as two bf16 terms, V read transposed); Q "
                  "and a 2-stage K/V ring by TMA with mbarriers, 128B swizzle; fp32 calls run the SIMT kernel "
                  f"({fa.SIMT_SOURCE}: 64-row tiles (32 at D = 256) of swizzled fp32 rows, K/V by cp.async in two "
                  "stages; S = Q K^T as 8 x 4 micro-tiles over two parts of D (eight at 256, one at D <= 64) summed "
                  "in one softmax pass (natural exp, as the plain version; P in shared memory), O += P V in 8 x 4 "
                  "register blocks), timed in fp32 as fp32",
        "launches": (launches + mla_launches + hybrid_full["flash_launches"] + qwen2_full["flash_launches"]
                     + dense_fwd + gemma_fwd + moe_fwd + qwen2_fwd + encdec_fwd + encdec_prefill + prefix_fwd
                     + prefix_prefill + dist_fwd + pipe_fwd + step_fwd + sharded["flash_forward"]),
        "launches_by_path": {"serving": launches, "moe_mla_serving": mla_launches,
                             "hybrid_serving": hybrid_full["flash_launches"],
                             "qwen2_serving": qwen2_full["flash_launches"], "qwen2_training": qwen2_fwd,
                             "dense_training": dense_fwd,
                             "gemma_training": gemma_fwd, "moe_mla_training": moe_fwd,
                             "encdec_training": encdec_fwd, "encdec_prefill": encdec_prefill,
                             "prefix_lm_training": prefix_fwd, "prefix_lm_prefill": prefix_prefill,
                             "compressed_training": dist_fwd, "pipeline": pipe_fwd, "step_cost_prefill": step_fwd,
                             "sharded_steps": sharded["flash_forward"]},
        "max_abs_err": max(bf16_err, op_err, *mla["max_abs_err"].values(), *d16["max_abs_err"].values(),
                           moe_full["attention_op_bf16"]["max_abs_err"], step_flash["max_abs_err"],
                           *(r["max_abs_err"] for r in qwen2_full["attention_op_bf16"]["layers"])),
        "d16": d16_rows("forward"),
        "step_cost_prefill": {k: step_flash[k] for k in ("shape", "route", "kernel_ms", "plain_ms", "library_ms",
                                                         "bound_ms", "bound_by", "kernel_tflops")},
        "prefix_lm_and_encdec": {"source": fa.SOURCE, "simt_source": fa.SIMT_SOURCE,
                                 "max_abs_err": prefix["max_abs_err"], "timing": new_shapes("forward")},
        "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": "B=1 S=512 Hq=Hkv=32 D=128 bf16 causal",
        "d256": {"route": "wgmma", "source": fa.SOURCE, "shape": d256["shape"], "max_abs_err": d256["max_abs_err"],
                 "timing": {S: {k: r[k] for k in ("kernel_ms", "simt_ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by")}
                            for S, r in d256["timing"].items()}},
        "fp32": {name: {k: routes[name][k] for k in ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by")}
                 for name in FP32_FWD_TIMED},
        "mla_192_128": {"route": "wgmma", "source": fa.SOURCE, "shape": mla["shape"], "launches": mla_launches,
                        "max_abs_err": mla["max_abs_err"], "sdpa_kernels": mla["sdpa_kernels"],
                        "timing": {S: {k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                                         "bound_by")}
                                   for S, r in mla["timing"].items()},
                        "fp32": mla["fp32"], "longest_served": {k: mt[k] for k in ("kernel_ms", "bound_ms")}},
    }, {
        "name": "flash_attention_backward", "route": "cuda", "source": fa.BWD_SOURCE, "replaces": fa.BWD_REPLACES,
        "design": "bf16 at every head dim (32-256): the FlashAttention-2 backward in three launches, no atomics: "
                  "D_i = rowsum(dO O) and lse log2(e), padded to the 64-row tile; dK/dV per (kv head, 64-row kv "
                  "tile, batch), K and V by TMA once and (Q, lse), (dO, D_i) through a 2-stage TMA ring over the "
                  "group's q heads and the q tiles from the diagonal: S^T = K Q^T, dP^T = V dO^T (ss), dV += P^T "
                  "dO, dK += dS^T Q (rs, A from the accumulator fragment); dQ per (q head, q tile, batch) with K/V "
                  "through the ring: S, dP (ss), dQ += dS K (rs); every product on wgmma, P and dS as two bf16 "
                  "terms, 128B swizzle; one warpgroup a block at D <= 128, two at D = 256, each owning half of D's "
                  "outputs and computing S and dP itself; fp32 runs the SIMT backward "
                  f"({fa.BWD_SIMT_SOURCE}: 8 x 4 score micro-tiles of S and dP, float4 reads of swizzled tiles, "
                  "cp.async double buffering), timed beside it as simt_ms",
        "launches": (dense_bwd + gemma_bwd + moe_bwd + qwen2_bwd + encdec_bwd + prefix_bwd + dist_bwd
                     + sharded["flash_backward"]),
        "launches_by_path": {"dense_training": dense_bwd, "gemma_training": gemma_bwd, "moe_mla_training": moe_bwd,
                             "qwen2_training": qwen2_bwd,
                             "encdec_training": encdec_bwd, "prefix_lm_training": prefix_bwd,
                             "compressed_training": dist_bwd, "pipeline": 0,
                             "sharded_steps": sharded["flash_backward"]},
        "kernels_per_launch": len(bwd_timing["device_us_by_kernel_10_calls"]["wgmma"]),
        "max_abs_err": max(bwd_err, dense_err, gemma_err, moe_err, qwen2_err, encdec_err, prefix_err, dist_err,
                           *mla_bwd["max_abs_err"].values()),
        "d16": d16_rows("backward"),
        "prefix_lm_and_encdec": {"source": fa.BWD_SOURCE, "simt_source": fa.BWD_SIMT_SOURCE,
                                 "timing": new_shapes("backward")},
        "ms": bwd_timing["kernel_ms"], "kernel_ms": bwd_timing["kernel_ms"], "plain_ms": bwd_timing["plain_ms"],
        "simt_ms": bwd_timing["simt_ms"],
        "bound_ms": bwd_timing["bound_ms"], "bound_by": bwd_timing["bound_by"],
        "library_ms": bwd_timing["library_ms"], "library_eager_ms": bwd_timing["library_eager_ms"],
        "library": "SDPA backward: its forward and backward replayed from a CUDA graph less its forward "
                   "(library_eager_ms: autograd through scaled_dot_product_attention, eager)",
        "d256": {shape: {k: r[k] for k in ("kernel_ms", "simt_ms", "plain_ms", "library_ms", "library_eager_ms",
                                           "bound_ms", "bound_by")}
                 for shape, r in d256_bwd.items()},
        "shape": "B=1 S=2048 Hq=Hkv=32 D=128 bf16 causal",
        "mla_192_128": {
            "route": "wgmma", "source": fa.BWD_SOURCE, "shape": mla_bwd["shape"], "launches": moe_bwd,
            "max_abs_err": mla_bwd["max_abs_err"], "sdpa_kernels": mla_bwd["timing"]["2048"]["sdpa_kernels"],
            "kernels_per_launch": len(mla_bwd["timing"]["2048"]["device_us_by_kernel_10_calls"]["wgmma"]),
            "timing": {S: {k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms", "library_eager_ms", "bound_ms",
                                             "bound_by")}
                       for S, r in mla_bwd["timing"].items()},
            "fp32": {"route": "simt", "source": fa.BWD_SIMT_SOURCE,
                     "timing": {S: {"kernel_ms": r["simt_fp32_ms"], "plain_ms": r["plain_fp32_ms"],
                                    "library_ms": r["library_ms_fp32"], "bound_ms": r["simt_fp32_bound_ms"],
                                    "bound_by": r["simt_fp32_bound_by"]} for S, r in mla_bwd["timing"].items()}},
        },
    }, {
        "name": "ssd_scan", "route": "cuda", "source": sk.SOURCE, "replaces": sk.REPLACES,
        "design": "bf16: the chunked-parallel form in three kernels; C B^T once per (batch, group, 64-row tile) "
                  "and each chunk's own state X^T (B w) in parallel, the states passed across chunks in fp32, "
                  "then per (batch, head, chunk) y = exp(cum) (C h^T) + M X; every product on wgmma (bf16 in, "
                  "fp32 accumulate; M, x w and the entering state as two bf16 terms), x/B/C tiles by TMA, 128B "
                  f"swizzle; fp32 calls run the SIMT kernels ({sk.SIMT_SOURCE}: the same three phases one 64-row "
                  "tile a chunk, C B^T once per group and tile, tile states passed in fp32, y = [exp(cum) C | M] "
                  "[h^T ; X] in 8 x 4 register blocks over half the depth a half-block; fp32 FMAs on float4 reads), "
                  "timed beside it in bf16 as simt_ms and in fp32 as fp32",
        "launches": (ssd_launches + hybrid_full["ssd_launches"] + jamba_train["ssd_launches"]["calls"]
                     + sharded["ssd_scan"]),
        "launches_by_path": {"ssm_training": ssd_launches, "hybrid_serving": hybrid_full["ssd_launches"],
                             "hybrid_training": jamba_train["ssd_launches"]["calls"],
                             "sharded_steps": sharded["ssd_scan"]},
        "max_abs_err": max(ssd_err, ssd_op_err),
        "kernels_per_launch": {"bfloat16": len(st["device_us_by_kernel"]),
                               "float32": routes["ssd_scan_fp32"]["kernels_per_call"]},
        "ms": st["kernel_ms"], "kernel_ms": st["kernel_ms"], "plain_ms": st["plain_ms"], "simt_ms": st["simt_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"], "library_ms": None,
        "shape": "B=4 S=256 H=24 P=64 N=128 G=1 bf16 (the training microbatch)",
        "long": {k: ssd_timings["B1_S4096"][k] for k in ("kernel_ms", "simt_ms", "plain_ms", "bound_ms")},
        "fp32": {name: {k: routes[name][k] for k in ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by")}
                 for name in ("ssd_scan_fp32", f"ssd_scan_fp32_B{SSD_TIMED[1][0]}_S{SSD_TIMED[1][1]}")},
        "hybrid_training": {k: jamba_train["ssm"][k] for k in ("shape", "route", "one_call_device_ms",
                                                                 "share_of_step_busy")},
        "p128": {"route": "wgmma", "source": sk.SOURCE, "shape": "B=1 H=128 P=128 N=128 G=1 bf16 (jamba's prefills)",
                 "launches": hybrid_full["ssd_launches"],
                 "max_abs_err": p128["bf16_max_abs_err"], "max_rel_l2_err": p128["bf16_max_rel_err"],
                 "h_final_rel_l2": p128["bf16_h_final_rel_l2"], "fp32_max_abs_err": p128["fp32_max_abs_err"],
                 "real_inputs_max_y_rel_l2": max(r["y_rel_l2"] for r in hybrid_full["ssd_op_bf16"]["layers"]),
                 "timing": {S: {k: r[k] for k in ("kernel_ms", "simt_ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "tiles_per_chunk")}
                            for S, r in p128["timing"].items()},
                 "fp32": {"route": "simt", "source": sk.SIMT_SOURCE,
                          "timing": {S: {k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                                           "bound_by")}
                                     for S, r in p128["fp32_timing"].items()}}},
    }, {
        "name": "segment_scatter", "route": "cuda", "source": ss.SOURCE, "replaces": ss.REPLACES,
        "design": "zero fill by cudaMemsetAsync; a warp takes 64 consecutive events (16-byte loads where "
                  "aligned), sums equal keys (__match_any_sync + a uint64 shuffle tree) and lands each key "
                  "with one 64-bit atomicAdd from its lowest lane; the accumulate entry (no seg column, no "
                  "fill) the same",
        "launches": seg_launches["segment_scatter"], "max_abs_err": seg_err,
        "ms": gt["kernel_ms"], "kernel_ms": gt["kernel_ms"], "plain_ms": gt["plain_ms"],
        "bound_ms": gt["bound_ms"], "bound_by": gt["bound_by"], "library_ms": gt["library_ms"],
        "shape": f"E={gt['events']} events into a ({gt['n_segs']}, {gt['row_size']}) uint64 table "
                 f"(the {SIM_DRAWS}-draw sweep's landing)",
        "accumulate_entry": {"launches": seg_launches["scatter_add_u64"],
                             **{k: acc_timing[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                                           "events", "buffer_cells")}},
        "step_cost_replay": {"launches": replay_launches,
                             **{k: step_scatter[k] for k in ("shape", "kernel_ms", "plain_ms", "library_ms",
                                                              "bound_ms", "bound_by")}},
    }]})
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s; profiler traces taken again at margins "
          f"{BREAKDOWN_RETAKEN} s; kept traces' first device event {min(BREAKDOWN_LEAD_MS):.3f} to "
          f"{max(BREAKDOWN_LEAD_MS):.3f} ms after their margin; seconds to each phase's line "
          f"{json.dumps({k: round(v, 1) for k, v in PHASE_S.items()})}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(sharded_steps_child(sys.argv[2]) if sys.argv[1:2] == ["--sharded-steps"] else main())
    except CheckFailed as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
