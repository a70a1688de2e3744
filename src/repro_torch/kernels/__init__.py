"""Kernels of the port: hand-written CUDA for Hopper, each beside its plain version.

Importing this package builds nothing; a kernel is compiled at its first
launch on a CUDA tensor (see :mod:`.build`).  The attention entry points
are ``ops.flash_attention`` and ``ops.decode_attention``; the name
``flash_attention`` here is the kernel's module, whose wrapper carries the
launch count (``flash_attention.flash_attention.launches``).
"""

from . import flash_attention, ops, ref

__all__ = ["flash_attention", "ops", "ref"]
