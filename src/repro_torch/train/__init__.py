"""Training: the step (microbatch accumulation, int8 compression with error
feedback, remat, AdamW), the live loop with per-stream train/eval lanes and
checkpoints, and the GPipe pipeline (:mod:`.pipeline`).

``python -m repro_torch.train`` trains mamba2-130m at its published shape
(see :mod:`repro_torch.train.__main__`)."""

from .trainer import (TrainConfig, Trainer, compress_groups, cross_entropy, flash_widths, functional_train_step,
                      init_train_state, make_loss_fn, make_train_step)

__all__ = ["TrainConfig", "Trainer", "compress_groups", "cross_entropy", "flash_widths", "functional_train_step",
           "init_train_state", "make_loss_fn", "make_train_step"]
