"""PyTorch/CUDA port of the per-stream stat tracking system, for NVIDIA Hopper.

Subpackages mirror the reference package's module names:

* :mod:`repro_torch.configs` — the architecture registry with torch dtypes,
* :mod:`repro_torch.core` — the per-stream stats core the engine records into,
* :mod:`repro_torch.kernels` — hand-written CUDA kernels beside their plain versions,
* :mod:`repro_torch.models` — the dense decoder and weight conversion,
* :mod:`repro_torch.serve` — the continuous-batching server and its load generator.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Importing the package builds no kernel and imports neither JAX nor the
reference package.
"""

__all__ = ["configs", "core", "kernels", "models", "serve"]
