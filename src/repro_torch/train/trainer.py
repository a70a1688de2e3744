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

from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import ModelConfig, torch_dtype
from ..core import ReportSink, StepCost, StreamManager, StreamStats
from ..core.query import StatsFrame
from ..kernels import flash_attention as flash_kernel
from ..kernels import ssd_scan as ssd_kernel
from ..models import Transformer
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

__all__ = [
    "TrainConfig",
    "cross_entropy",
    "make_loss_fn",
    "make_train_step",
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
    Returns ``(loss, number of valid tokens)``."""
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


#: batch keys the model reads: token ids (long), and the stub front ends' embeddings (compute dtype)
_ID_KEYS, _EMBED_KEYS = ("tokens", "labels"), ("enc_embeds", "vision_embeds")


def _device_batch(batch, device, compute_dtype) -> Dict[str, torch.Tensor]:
    """The keys the model reads on ``device``: token ids and labels as
    ``long``; whisper's frame embeddings (``enc_embeds``) and a VLM's patch
    embeddings (``vision_embeds``) as floats in ``compute_dtype`` (the model
    casts them so too)."""
    dtypes = {**dict.fromkeys(_ID_KEYS, torch.long), **dict.fromkeys(_EMBED_KEYS, compute_dtype)}
    return {k: torch.as_tensor(np.asarray(v)).to(device=device, dtype=dtypes[k]) for k, v in batch.items()
            if k in dtypes}


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
    as it is."""
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
        rows = len(batch["tokens"])
        if rows % n_micro:
            raise ValueError(f"batch of {rows} does not split into {n_micro} microbatches")
        size = rows // n_micro
        acc: List[torch.Tensor] = []
        ef = opt_state["ef"] if tcfg.compress_grads else None
        loss = aux = tokens = 0.0
        for i in range(n_micro):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            total, metrics = loss_fn(mb)
            if per_leaf:
                acc = accumulate(acc, list(torch.autograd.grad(total, leaves)), ef)
            else:
                grads = [g.float() for g in torch.autograd.grad(total, leaves)]
                if acc:
                    torch._foreach_add_(acc, grads)
                else:
                    acc = grads
            loss = loss + metrics["loss"].detach()
            aux = aux + metrics["aux"].detach()
            tokens = tokens + metrics["tokens"]
        if n_micro > 1:
            torch._foreach_div_(acc, float(n_micro))
        grads, gnorm = clip_by_global_norm(dict(zip(params, acc)), tcfg.adamw.grad_clip)
        lr = learning_rate(int(opt_state["step"]), tcfg.schedule)
        opt_state = adamw_update(grads, opt_state, params, lr, tcfg.adamw)
        metrics = {"loss": loss / n_micro, "aux": aux / n_micro, "tokens": tokens, "grad_norm": gnorm, "lr": lr}
        return opt_state, metrics

    return train_step


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor inputs and outputs.

    An unfused count: each eager op is taken to read its inputs and write its
    outputs in full, once.  Views and allocations move nothing and are
    skipped.  It is not XLA's ``bytes accessed`` (the reference's count,
    taken after fusion), and it cannot see a kernel launched through ctypes,
    whose bytes the trainer adds by formula."""

    _NO_DATA = {
        torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default, torch.ops.aten.empty_like.default,
        torch.ops.aten._unsafe_view.default, torch.ops.aten.detach.default, torch.ops.aten.lift_fresh.default,
    }

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in self._NO_DATA:
            self.bytes += sum(t.nbytes for t in tree_flatten((args, kwargs, out))[0] if isinstance(t, torch.Tensor))
        return out


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
    The train lane's cost per step is counted once, over the first step:
    FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` and ``hbm_bytes``
    by an unfused count of every dispatched op's inputs and outputs
    (:class:`_ByteCounter`; not XLA's ``bytes accessed``), each plus what the
    kernels launched through ctypes (the SSD scan, flash attention forward
    and backward) add by formula, since neither counter can see them.
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
        #: launches add by formula
        self.step_cost: Optional[StepCost] = None
        self.cost_parts: Dict[str, float] = {}
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

    @staticmethod
    def _launches() -> Dict[str, Any]:
        """The kernels' launch counts: the SSD scan's as a number, each flash
        direction's by :class:`~repro_torch.kernels.flash_attention.FlashLaunch`
        (a copy of the wrapper's record)."""
        return {"ssd_kernel": ssd_kernel.ssd_scan.launches,
                "flash_forward": Counter(flash_kernel.flash_attention.shapes),
                "flash_backward": Counter(flash_kernel.flash_attention_backward.shapes)}

    def _kernel_costs(self, batch, launched: Dict[str, Any]) -> Dict[str, float]:
        """FLOPs and bytes that the kernels launched through ctypes add, by
        formula: the SSD scan's ``launched["ssd_kernel"]`` launches at this
        batch's microbatch shape, and each flash launch at its own shape and
        mask, as the wrapper recorded it (``launched["flash_forward"]`` and
        ``["flash_backward"]``: counts by ``FlashLaunch``; whisper's encoder,
        cross and decoder launches and paligemma's prefix differ).  A kernel
        that did not launch adds nothing."""
        cfg = self.cfg
        out = {"ssd_kernel": 0.0, "bytes_ssd_kernel": 0.0}
        if launched["ssd_kernel"]:
            rows, S = np.asarray(batch["tokens"]).shape
            B = rows // self.tcfg.microbatches
            esize = cfg.compute_tdtype().itemsize
            s = cfg.ssm
            H = s.n_heads(cfg.d_model)
            n = launched["ssd_kernel"]
            out["ssd_kernel"] = float(n * ssd_kernel.ssd_flops(B, S, H, s.head_dim, s.d_state, s.n_groups))
            out["bytes_ssd_kernel"] = float(n * ssd_kernel.ssd_bytes(B, S, H, s.head_dim, s.d_state, s.n_groups,
                                                                     esize))
        for name, backward in (("flash_forward", False), ("flash_backward", True)):
            shapes = launched[name]
            out[name] = float(sum(n * rec.flops(backward) for rec, n in shapes.items()))
            out[f"bytes_{name}"] = float(sum(n * rec.bytes(backward) for rec, n in shapes.items()))
        return out

    def run(self, model: Transformer, opt_state, num_steps: int):
        step_fn = make_train_step(model, self.tcfg)
        loss_fn = make_loss_fn(model, self.tcfg)
        history = []
        for _ in range(num_steps):
            batch = next(self.data_iter)
            uid = self.stats.step_begin("train_step", self.train_stream)
            if self.step_cost is None:
                before = self._launches()
                with FlopCounterMode(display=False) as counter, _ByteCounter() as moved:
                    opt_state, metrics = step_fn(opt_state, batch)
                launched = {name: n - before[name] for name, n in self._launches().items()}  # Counters subtract
                self.cost_parts = {"counted": float(counter.get_total_flops()), "bytes_counted": float(moved.bytes),
                                   **self._kernel_costs(batch, launched)}
                parts = self.cost_parts.items()
                self.step_cost = StepCost(flops=sum(v for k, v in parts if not k.startswith("bytes_")),
                                          hbm_bytes=sum(v for k, v in parts if k.startswith("bytes_")))
            else:
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
