"""Training step + loop: microbatch accumulation, remat, AdamW, per-stream
telemetry, checkpoint/resume.

:func:`make_train_step` builds the step over a :class:`~repro_torch.models.Transformer`
(the parameters are updated in place); :class:`Trainer` owns the live loop
(data, checkpoints, per-stream instrumentation via :mod:`repro_torch.core`).
The math is the reference's (``train/trainer.py``): token-mean cross-entropy
with z-loss in fp32, gradients accumulated over microbatches in
``accum_dtype`` (fp32 by default), optionally int8-compressed with error
feedback on their way into the accumulator (``compress_grads``), clipped by
global norm, AdamW with the schedule's rate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, torch_dtype
from ..core import ReportSink, StepCost, StreamManager, StreamStats
from ..core.query import StatsFrame
from ..launch.dtensors import all_reduce_over, from_shard, is_dtensor, like, span, sum_over
from ..models import Transformer, param_tree
from ..models.convert import reference_leaf
from ..optim import (
    AdamWConfig,
    ScheduleConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    ef_compress,
    ef_state_init,
    learning_rate,
)
from ..perf.cost import count_step

__all__ = [
    "TrainConfig",
    "cross_entropy",
    "make_loss_fn",
    "make_train_step",
    "functional_train_step",
    "init_train_state",
    "flash_widths",
    "compress_groups",
    "Trainer",
]


@dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    microbatches: int = 1  # gradient-accumulation chunks per step
    compress_grads: bool = False  # int8 + error feedback on the accum path
    accum_dtype: str = "float32"  # grad accumulator (bf16 halves it)
    aux_weight: float = 0.01  # MoE load-balance loss weight
    z_loss: float = 1e-4  # logit-norm regulariser
    seed: int = 0


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 0.0):
    """Token-mean CE over valid (label >= 0) positions, fp32, with z-loss.
    Returns ``(loss, number of valid tokens)``.  DTensor logits (a step on a
    mesh, the vocabulary on ``model``) take :func:`sharded_cross_entropy`."""
    if is_dtensor(logits):
        return sharded_cross_entropy(logits, labels, z_loss)
    logits = logits.float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[..., None])[..., 0] - lse
    nll = -torch.where(valid, ll, 0.0)
    denom = valid.sum().clamp(min=1)
    loss = nll.sum() / denom
    if z_loss > 0:
        loss = loss + z_loss * torch.where(valid, lse, 0.0).square().sum() / denom
    return loss, denom


class _ShardedLogSumExp(torch.autograd.Function):
    """``logsumexp`` over the last dim of a local block of columns whose
    other blocks lie on the ranks of ``axes``: the row maximum and then the
    sum of exponentials all-reduced (torch's own ``logsumexp`` order: max,
    infinite maxima set to 0, ``sum(exp(x - max))``, log, plus max), the
    gradient ``g · exp(x - lse)`` on each block (torch's
    ``logsumexp_backward``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        m = all_reduce_over(x.amax(-1, keepdim=True), mesh, axes, torch.distributed.ReduceOp.MAX)
        m = m.masked_fill(m.abs() == float("inf"), 0)
        lse = all_reduce_over((x - m).exp().sum(-1), mesh, axes).log_().add_(m[..., 0])
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        x, lse = ctx.saved_tensors
        return grad[..., None] * (x - lse[..., None]).exp(), None, None


def sharded_cross_entropy(logits, labels, z_loss: float = 0.0):
    """:func:`cross_entropy` of DTensor ``logits`` on each rank's block,
    vocab-parallel where the vocabulary is sharded: the logsumexp's max and
    sum all-reduced over those mesh dims (:class:`_ShardedLogSumExp`), each
    label's logit taken on the rank whose columns hold it and all-reduced,
    then the token sums (loss, z-loss, valid count) all-reduced over the
    dims that shard the tokens.  Masked labels (< 0) and the z-loss as the
    plain function has them; the loss and count come back as plain tensors,
    alike on every rank.  On one rank it is the plain function's arithmetic,
    op for op."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    last = logits.ndim - 1
    want = [Replicate() if isinstance(p, Partial) else p for p in logits.placements]
    if list(logits.placements) != want:
        logits = logits.redistribute(mesh, want)
    vocab_axes = [i for i, p in enumerate(want) if isinstance(p, Shard) and p.dim == last]
    token_axes = [i for i, p in enumerate(want) if isinstance(p, Shard) and p.dim != last]
    label_place = [p if isinstance(p, Shard) and p.dim != last else Replicate() for p in want]
    labels = like(labels, logits)
    if list(labels.placements) != label_place:
        labels = labels.redistribute(mesh, label_place)
    labels = labels.to_local()
    first, width = span(logits, last)  # this rank's columns of the vocabulary
    # contiguous, so that the gradient handed back to the DTensor has the layout its metadata says
    x = logits.contiguous().to_local().float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    lse = _ShardedLogSumExp.apply(x, mesh, tuple(vocab_axes))
    at = safe - first
    mine = (at >= 0) & (at < width)
    picked = x.gather(-1, at.clamp(0, width - 1)[..., None])[..., 0]
    ll = sum_over(torch.where(mine, picked, 0.0), mesh, vocab_axes) - lse
    nll = -torch.where(valid, ll, 0.0)
    denom = all_reduce_over(valid.sum(), mesh, token_axes).clamp(min=1)
    loss = sum_over(nll.sum(), mesh, token_axes) / denom
    if z_loss > 0:
        loss = loss + z_loss * sum_over(torch.where(valid, lse, 0.0).square().sum(), mesh, token_axes) / denom
    return loss, denom


#: batch keys the model reads: token ids (long), and the stub front ends' embeddings (compute dtype)
_ID_KEYS, _EMBED_KEYS = ("tokens", "labels"), ("enc_embeds", "vision_embeds")


def _device_batch(batch, device, compute_dtype) -> Dict[str, torch.Tensor]:
    """The keys the model reads on ``device``: token ids and labels as
    ``long``; whisper's frame embeddings (``enc_embeds``) and a VLM's patch
    embeddings (``vision_embeds``) as floats in ``compute_dtype`` (the model
    casts them so too)."""
    dtypes = {**dict.fromkeys(_ID_KEYS, torch.long), **dict.fromkeys(_EMBED_KEYS, compute_dtype)}
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(device=device, dtype=dtypes[k])
            for k, v in batch.items() if k in dtypes}


def make_loss_fn(model: Transformer, tcfg: TrainConfig) -> Callable:
    """``loss_fn(batch) -> (total, {"loss", "aux", "tokens"})`` on the model's device."""

    def loss_fn(batch):
        b = _device_batch(batch, model.device, model.cfg.compute_tdtype())
        logits, aux = model(b["tokens"], enc_embeds=b.get("enc_embeds"), vision_embeds=b.get("vision_embeds"))
        loss, n_tok = cross_entropy(logits, b["labels"], tcfg.z_loss)
        return loss + tcfg.aux_weight * aux, {"loss": loss, "aux": aux, "tokens": n_tok}

    return loss_fn


def make_train_step(model: Transformer, tcfg: TrainConfig) -> Callable:
    """``train_step(opt_state, batch) -> (opt_state, metrics)``, updating the
    model's parameters in place.  ``batch`` arrays are (global_batch, ...)
    and are split into ``tcfg.microbatches`` accumulation chunks along axis
    0 (activation memory ∝ one microbatch).

    With ``compress_grads`` each microbatch's fp32 gradient goes through
    ``ef_compress`` (``opt_state["ef"]``, updated in place; one int8 scale a
    reference leaf, ``compress_groups``) before it is added; with several
    microbatches the accumulator is kept in
    ``accum_dtype``, each addition ``(acc.float() + g).to(accum_dtype)`` and
    the mean taken in ``accum_dtype`` before the clip, as the reference
    does.  One microbatch has no accumulator: its fp32 gradient is clipped
    as it is.

    On a mesh (DTensor parameters, ``launch.steps.place``) each microbatch
    is the reference's rows of the global batch, kept at the batch's
    placements; each gradient is brought to its parameter's placements (a
    replicated parameter used on batch-sharded rows has a ``Partial`` one,
    reduced here), and the accumulation, the clip and AdamW run on the
    local shards (the global norm all-reduces the shards' squared norms).
    int8 compression (``compress_grads``) runs on plain tensors only."""
    loss_fn = make_loss_fn(model, tcfg)
    n_micro = tcfg.microbatches
    acc_dtype = torch_dtype(tcfg.accum_dtype)
    per_leaf = tcfg.compress_grads or (n_micro > 1 and acc_dtype != torch.float32)
    names = [n for n, _ in model.named_parameters()]
    groups = compress_groups(model.cfg, names)
    # the leaves of one reference leaf, together (ef_compress takes a group whole)
    order: Dict[str, List[int]] = {}
    for j, n in enumerate(names):
        order.setdefault(groups[n] if tcfg.compress_grads else n, []).append(j)

    def accumulate(acc: List[torch.Tensor], grads: List, ef) -> List[torch.Tensor]:
        """Add one microbatch's gradients into ``acc`` a group at a time,
        each group compressed first where ``ef`` is given, dropping each
        gradient from ``grads`` (a list) as it is used."""
        out: List[Optional[torch.Tensor]] = [None] * len(names)
        for idx in order.values():
            part = {names[j]: grads[j] for j in idx}
            for j in idx:
                grads[j] = None
            part = ef_compress(part, ef, groups)[0] if ef is not None else {n: g.float() for n, g in part.items()}
            for j in idx:
                g = part.pop(names[j])
                if n_micro == 1:
                    out[j] = g
                elif not acc:
                    out[j] = g.to(acc_dtype)
                elif acc_dtype == torch.float32:
                    out[j] = acc[j].add_(g)
                else:
                    out[j] = (acc[j].float() + g).to(acc_dtype)
                del g
        return out

    def train_step(opt_state, batch):
        params = dict(model.named_parameters())
        leaves = list(params.values())
        sharded = is_dtensor(*leaves)
        if sharded and tcfg.compress_grads:
            raise NotImplementedError("int8 gradient compression (compress_grads) runs on plain tensors; its "
                                      "sharded form is not written yet (ROADMAP)")
        rows = len(batch["tokens"])
        if rows % n_micro:
            raise ValueError(f"batch of {rows} does not split into {n_micro} microbatches")
        size = rows // n_micro
        acc: List[torch.Tensor] = []
        ef = opt_state["ef"] if tcfg.compress_grads else None
        loss = aux = tokens = 0.0

        def grads_of(total):
            grads = list(torch.autograd.grad(total, leaves))
            return [_shard_of(g, p) for g, p in zip(grads, leaves)] if sharded else grads

        for i in range(n_micro):
            mb = batch if n_micro == 1 else {k: _rows(v, i * size, size) for k, v in batch.items()}
            total, metrics = loss_fn(mb)
            if per_leaf:
                acc = accumulate(acc, grads_of(total), ef)
            else:
                grads = grads_of(total)
                if acc:  # a bf16 gradient adds into its fp32 accumulator op by op: no fp32 copy of it
                    torch._foreach_add_(acc, grads)
                else:
                    acc = [g.float() for g in grads]
                del grads
            loss = loss + metrics["loss"].detach()
            aux = aux + metrics["aux"].detach()
            tokens = tokens + metrics["tokens"]
        if n_micro > 1:
            torch._foreach_div_(acc, float(n_micro))
        if sharded:  # the local sums, as DTensors at their parameters' placements
            acc = [from_shard(a, p.device_mesh, p.placements, p.shape) for a, p in zip(acc, leaves)]
        grads, gnorm = clip_by_global_norm(dict(zip(params, acc)), tcfg.adamw.grad_clip)
        lr = learning_rate(int(opt_state["step"]), tcfg.schedule)
        opt_state = adamw_update(grads, opt_state, params, lr, tcfg.adamw)
        metrics = {"loss": loss / n_micro, "aux": aux / n_micro, "tokens": tokens, "grad_norm": gnorm, "lr": lr}
        return opt_state, metrics

    return train_step


def _rows(t, start: int, size: int):
    """Rows ``[start, start + size)`` of a batch leaf; a DTensor's at its
    own placements (the slice itself gathers the rows it cuts across)."""
    part = t[start:start + size]
    if is_dtensor(t) and part.placements != t.placements:
        part = part.redistribute(t.device_mesh, t.placements)
    return part


def _shard_of(g, p) -> torch.Tensor:
    """The local shard of gradient ``g`` at parameter ``p``'s placements
    (a ``Partial`` gradient reduced, a replicated one cut)."""
    if g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g.to_local()


def functional_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the reference's signature: :func:`make_train_step` over a
    model built on the parameter tree ``params``
    (``Transformer.from_params``, keyed as ``model_defs``), whose tensors
    it updates in place and returns.  The step factory
    (``launch/steps.py``) and the trainer's cost count call it."""

    def train_step(params, opt_state, batch):
        model = Transformer.from_params(cfg, params)
        opt_state, metrics = make_train_step(model, tcfg)(opt_state, batch)
        return params, opt_state, metrics

    return train_step


def compress_groups(cfg: ModelConfig, names) -> Dict[str, str]:
    """Each parameter name's int8-compression group: the reference leaf that
    holds it (``models.convert.reference_leaf``), so the layers of one
    reference stack share a scale as the reference's stacked leaf does."""
    return {n: reference_leaf(cfg, n) for n in names}


def flash_widths(cfg: ModelConfig) -> Tuple[int, int, int]:
    """``(kv heads, q/k head dim, v head dim)`` at which ``cfg``'s attention
    layers call the flash kernels: MLA expands K and V per query head, at
    q/k width ``qk_nope_dim + qk_rope_dim`` and v width ``v_head_dim``
    (deepseek-v2's (192, 128)); any other attention runs ``n_kv_heads`` at
    ``resolved_head_dim`` for both."""
    if cfg.mla is not None:
        m = cfg.mla
        return cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    return cfg.n_kv_heads, cfg.resolved_head_dim, cfg.resolved_head_dim


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, *, device="cuda") -> Tuple[Transformer, Dict]:
    """(model, opt_state): seeded random weights from ``tcfg.seed`` and
    zeroed moments in ``cfg.opt_state_dtype``; with ``compress_grads`` also
    the zeroed fp32 error-feedback buffers, ``opt_state["ef"]``."""
    model = Transformer(cfg, device=device, seed=tcfg.seed)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params, torch_dtype(cfg.opt_state_dtype))
    if tcfg.compress_grads:
        opt_state["ef"] = ef_state_init(params)
    return model, opt_state


class Trainer:
    """Live training loop with per-stream stats + checkpoint/restart.

    The train lane and the (optional) eval lane are distinct *streams*: their
    step records and byte/FLOP attribution never mix
    (``stats.summary(train_stream)`` vs ``stats.summary(eval_stream)``).
    The train lane's cost per step is counted once, before the first step,
    by :func:`repro_torch.perf.cost.count_step` on fake copies of the model,
    the optimizer state and the batch (no data, no device work; the real
    first step runs uncounted, like every other step): FLOPs by
    ``torch.utils.flop_counter.FlopCounterMode`` and ``hbm_bytes`` by an
    unfused count of every dispatched op's inputs and outputs (not XLA's
    ``bytes accessed``), each plus what the hand-written kernels (the SSD
    scan, flash attention forward and backward) add by formula, one count
    per launch their wrappers record on the fake tensors, on either device.
    :attr:`cost_parts` names each part.  ``hbm_bytes`` lands on the train
    lane's ``GLOBAL_ACC_R`` MISS counter, as the reference's compiled cost
    does.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        data_iter,
        *,
        eval_iter=None,
        ckpt_manager=None,
        ckpt_every: int = 0,
        eval_every: int = 0,
        sinks: Optional[Tuple[ReportSink, ...]] = None,
        device="cuda",
    ) -> None:
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.data_iter = data_iter
        self.eval_iter = eval_iter
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.eval_every = eval_every
        self.sinks = list(sinks) if sinks else []
        self.stats = StreamStats()
        self.streams = StreamManager()
        self.train_stream = self.streams.create_stream("train").stream_id
        self.eval_stream = self.streams.create_stream("eval").stream_id
        self.step = 0
        #: the train lane's per-step cost, and its parts: FLOPs ("counted",
        #: "ssd_kernel", "flash_forward", "flash_backward") and bytes (the same
        #: names after "bytes_"): what the counters saw and what each kernel's
        #: launches add by formula (``perf.cost.count_step``'s ``parts``)
        self.step_cost: Optional[StepCost] = None
        self.cost_parts: Dict[str, float] = {}
        #: host seconds the count took (on fake tensors, before the first step)
        self.count_s: Optional[float] = None
        self.eval_history: List[Dict[str, float]] = []

    def restore_or_init(self) -> Tuple[Transformer, Dict]:
        """The latest committed checkpoint's model and optimizer state, or a
        fresh :func:`init_train_state`."""
        model, opt_state = init_train_state(self.cfg, self.tcfg, device=self.device)
        restored = self.ckpt.restore_latest(self.device) if self.ckpt is not None else None
        if restored is not None:
            params, opt_state, meta = restored
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(params[name])
            opt_state["step"] = opt_state["step"].cpu()
            self.step = int(meta.get("step", 0))
        return model, opt_state

    def run(self, model: Transformer, opt_state, num_steps: int):
        step_fn = make_train_step(model, self.tcfg)
        loss_fn = make_loss_fn(model, self.tcfg)
        history = []
        for _ in range(num_steps):
            batch = next(self.data_iter)
            if self.step_cost is None:  # on fake copies: the real step below runs uncounted
                t0 = time.perf_counter()
                summary = count_step(functional_train_step(self.cfg, self.tcfg), param_tree(model), opt_state, batch)
                self.count_s = time.perf_counter() - t0
                self.cost_parts = summary.parts
                self.step_cost = StepCost(flops=summary.flops_per_device, hbm_bytes=summary.hbm_bytes_per_device)
            uid = self.stats.step_begin("train_step", self.train_stream)
            opt_state, metrics = step_fn(opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            self.stats.step_end(uid, tokens=int(metrics["tokens"]), cost=self.step_cost, loss=metrics["loss"])
            self.step += 1
            history.append(metrics)
            if self.ckpt is not None and self.ckpt_every and self.step % self.ckpt_every == 0:
                self.ckpt.save(dict(model.named_parameters()), opt_state, {"step": self.step}, step=self.step)
            if self.eval_iter is not None and self.eval_every and self.step % self.eval_every == 0:
                ebatch = next(self.eval_iter)
                with self.stats.step("eval_step", self.eval_stream), torch.no_grad():
                    m = loss_fn(ebatch)[1]
                    self.eval_history.append({k: float(v) for k, v in m.items()})
        self.emit_reports()
        return model, opt_state, history

    def frame(self) -> StatsFrame:
        """The trainer's per-stream telemetry as a :class:`StatsFrame`; the
        train and eval lanes resolve by name."""
        return StatsFrame(
            self.stats.table,
            timeline=self.stats.timeline,
            names={"train": self.train_stream, "eval": self.eval_stream},
        )

    def emit_reports(self) -> int:
        """Per-stream summary reports (train/eval lanes) through the plugged sinks."""
        if not self.sinks:
            return 0
        return self.stats.emit(self.sinks, source="train")
