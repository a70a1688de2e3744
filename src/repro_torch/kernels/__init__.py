"""Kernels of the port: hand-written CUDA for Hopper, each beside its plain version.

Importing this package builds nothing; a kernel is compiled at its first
launch on a CUDA tensor (see :mod:`.build`).  The attention entry points
are ``ops.flash_attention`` and ``ops.decode_attention``, the SSM entry
point ``ops.ssd_scan``; the names ``flash_attention`` and ``ssd_scan`` here
are the kernels' modules, whose wrappers carry the launch counts
(``flash_attention.flash_attention.launches``, ``ssd_scan.ssd_scan.launches``).
"""

from . import flash_attention, ops, ref, ssd_scan

__all__ = ["flash_attention", "ops", "ref", "ssd_scan"]
