"""Training step + loop: microbatch accumulation, remat, AdamW, per-stream
telemetry, checkpoint/resume.

:func:`make_train_step` builds the step over a :class:`~repro_torch.models.Transformer`
(the parameters are updated in place); :class:`Trainer` owns the live loop
(data, checkpoints, per-stream instrumentation via :mod:`repro_torch.core`).
The math is the reference's (``train/trainer.py``): token-mean cross-entropy
with z-loss in fp32, gradients accumulated over microbatches in
fp32, clipped by global norm, AdamW with the schedule's rate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import ModelConfig, torch_dtype
from ..core import ReportSink, StepCost, StreamManager, StreamStats
from ..core.query import StatsFrame
from ..kernels import ssd_scan as ssd_kernel
from ..models import Transformer
from ..optim import AdamWConfig, ScheduleConfig, adamw_init, adamw_update, clip_by_global_norm, learning_rate

__all__ = [
    "TrainConfig",
    "cross_entropy",
    "make_loss_fn",
    "make_train_step",
    "init_train_state",
    "Trainer",
]


@dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    microbatches: int = 1  # gradient-accumulation chunks per step
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


def _device_batch(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device=device, dtype=torch.long) for k, v in batch.items()
            if k in ("tokens", "labels")}


def make_loss_fn(model: Transformer, tcfg: TrainConfig) -> Callable:
    """``loss_fn(batch) -> (total, {"loss", "aux", "tokens"})`` on the model's device."""

    def loss_fn(batch):
        b = _device_batch(batch, model.device)
        logits, aux = model(b["tokens"])
        loss, n_tok = cross_entropy(logits, b["labels"], tcfg.z_loss)
        return loss + tcfg.aux_weight * aux, {"loss": loss, "aux": aux, "tokens": n_tok}

    return loss_fn


def make_train_step(model: Transformer, tcfg: TrainConfig) -> Callable:
    """``train_step(opt_state, batch) -> (opt_state, metrics)``, updating the
    model's parameters in place.  ``batch`` arrays are (global_batch, ...)
    and are split into ``tcfg.microbatches`` accumulation chunks along axis
    0 (activation memory ∝ one microbatch)."""
    loss_fn = make_loss_fn(model, tcfg)
    n_micro = tcfg.microbatches

    def train_step(opt_state, batch):
        params = dict(model.named_parameters())
        leaves = list(params.values())
        rows = len(batch["tokens"])
        if rows % n_micro:
            raise ValueError(f"batch of {rows} does not split into {n_micro} microbatches")
        size = rows // n_micro
        acc: List[torch.Tensor] = []
        loss = aux = tokens = 0.0
        for i in range(n_micro):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            total, metrics = loss_fn(mb)
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


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, *, device="cuda") -> Tuple[Transformer, Dict]:
    """(model, opt_state): seeded random weights from ``tcfg.seed`` and
    zeroed moments in ``cfg.opt_state_dtype``."""
    model = Transformer(cfg, device=device, seed=tcfg.seed)
    opt_state = adamw_init(dict(model.named_parameters()), torch_dtype(cfg.opt_state_dtype))
    return model, opt_state


class Trainer:
    """Live training loop with per-stream stats + checkpoint/restart.

    The train lane and the (optional) eval lane are distinct *streams*: their
    step records and byte/FLOP attribution never mix
    (``stats.summary(train_stream)`` vs ``stats.summary(eval_stream)``).
    The train lane's cost per step is counted once, over the first step, by
    ``torch.utils.flop_counter.FlopCounterMode`` plus the SSD kernel's FLOPs
    by formula (the counter cannot see a kernel launched through ctypes);
    its ``hbm_bytes`` is 0 (not counted).
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
        #: the train lane's per-step cost, and its parts: what the counter saw
        #: and what the SSD kernel's launches add by formula
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

    def _ssd_flops(self, batch) -> int:
        """FLOPs of one SSD kernel launch at this batch's microbatch shape."""
        s = self.cfg.ssm
        if s is None:
            return 0
        rows, S = np.asarray(batch["tokens"]).shape
        H = s.n_heads(self.cfg.d_model)
        return ssd_kernel.ssd_flops(rows // self.tcfg.microbatches, S, H, s.head_dim, s.d_state)

    def run(self, model: Transformer, opt_state, num_steps: int):
        step_fn = make_train_step(model, self.tcfg)
        loss_fn = make_loss_fn(model, self.tcfg)
        history = []
        for _ in range(num_steps):
            batch = next(self.data_iter)
            uid = self.stats.step_begin("train_step", self.train_stream)
            if self.step_cost is None:
                launches = ssd_kernel.ssd_scan.launches
                with FlopCounterMode(display=False) as counter:
                    opt_state, metrics = step_fn(opt_state, batch)
                kernel = (ssd_kernel.ssd_scan.launches - launches) * self._ssd_flops(batch)
                self.cost_parts = {"counted": float(counter.get_total_flops()), "ssd_kernel": float(kernel)}
                self.step_cost = StepCost(flops=self.cost_parts["counted"] + kernel)
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
