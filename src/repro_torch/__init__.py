"""PyTorch/CUDA port of the per-stream stat tracking system, for NVIDIA Hopper.

Subpackages mirror the reference package's module names:

* :mod:`repro_torch.configs` — the architecture registry with torch dtypes,
* :mod:`repro_torch.core` — the per-stream stats core the engine records into,
* :mod:`repro_torch.kernels` — hand-written CUDA kernels beside their plain versions,
* :mod:`repro_torch.models` — the dense and pure-SSM decoder and weight conversion,
* :mod:`repro_torch.serve` — the continuous-batching server and its load generator,
* :mod:`repro_torch.optim`, :mod:`repro_torch.data`, :mod:`repro_torch.ckpt`,
  :mod:`repro_torch.train` — AdamW and the schedule, the data pipeline,
  checkpoints, and the training loop (``python -m repro_torch.train``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Importing the package builds no kernel and imports neither JAX nor the
reference package.
"""

__all__ = ["configs", "core", "kernels", "models", "serve", "optim", "data", "ckpt", "train"]
