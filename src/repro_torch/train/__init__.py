"""Training: the step (microbatch accumulation, remat, AdamW) and the live
loop with per-stream train/eval lanes and checkpoints.

``python -m repro_torch.train`` trains mamba2-130m at its published shape
(see :mod:`repro_torch.train.__main__`)."""

from .trainer import (TrainConfig, Trainer, cross_entropy, flash_widths, init_train_state, make_loss_fn,
                      make_train_step)

__all__ = ["TrainConfig", "Trainer", "cross_entropy", "flash_widths", "init_train_state", "make_loss_fn",
           "make_train_step"]
