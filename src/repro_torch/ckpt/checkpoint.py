"""Async, atomic checkpointing of the parameter and optimizer trees.

Layout per step, as in the reference (``ckpt/checkpoint.py``)::

    <dir>/step_<N>/
        manifest.json        # leaf paths, shapes, dtypes, meta
        leaves.npz           # every leaf, whole (one process, one card)
        COMMIT               # written last → restore ignores partial saves

* **atomicity** — COMMIT is written only after the leaf file is
  fsync'd; a preempted save is invisible to :meth:`restore_latest`.
* **async** — :meth:`save` copies every leaf to host memory on the caller's
  thread (the consistency point) and writes on a background thread.
* **placement** — the reference's sharding callback becomes a ``device``
  argument of :meth:`restore_latest`: every leaf lands on that device.
* **retention** — the ``keep`` most recent commits are retained.

Trees are nested dicts of tensors, keyed by ``/``-joined paths on disk.
bf16 leaves are stored as their 16 bits (numpy has no bfloat16) and the
manifest's dtype restores them, so a round trip is bitwise.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.params import iter_leaves

__all__ = ["CheckpointManager"]

def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()  # the caller's own storage when t lies on the CPU: copy it
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr.copy())
    if dtype == "bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    return t


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------ save
    def save(self, params, opt_state, meta: Dict[str, Any], *, step: int, blocking: bool = False) -> None:
        """Snapshot now, write in the background (or blocking)."""
        self.wait()  # one in-flight save at a time
        items = iter_leaves({"params": params, "opt_state": opt_state})
        host_items = [(k, _to_host(v), str(v.dtype).replace("torch.", "")) for k, v in items]
        manifest = {
            "step": int(step),
            "meta": meta,
            "leaves": {k: {"shape": list(a.shape), "dtype": d} for k, a, d in host_items},
            "time": time.time(),
        }

        def _write():
            d = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(d, "leaves.npz"), "wb") as f:
                np.savez(f, **{k.replace("/", "|"): a for k, a, _ in host_items})
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(d, "COMMIT"), "w") as f:
                f.write(str(step))
                f.flush()
                os.fsync(f.fileno())
            self._gc()

        if blocking:
            _write()
            return

        def _run():
            try:
                _write()
            except Exception as err:  # re-raised by wait() on the caller's thread
                self._error = err

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save has committed; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def committed_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore_latest(self, device=None):
        """Returns ``(params, opt_state, meta)`` of the latest commit, every
        leaf on ``device`` (the CPU when None), or None when nothing is
        committed."""
        steps = self.committed_steps()
        if not steps:
            return None
        d = os.path.join(self.dir, f"step_{steps[-1]:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        tree: Dict[str, Any] = {}
        with np.load(os.path.join(d, "leaves.npz")) as z:
            for name in z.files:
                key = name.replace("|", "/")
                leaf = _from_host(z[name], manifest["leaves"][key]["dtype"])
                *parents, last = key.split("/")
                cur = tree
                for p in parents:
                    cur = cur.setdefault(p, {})
                cur[last] = leaf.to(device) if device is not None else leaf
        return tree["params"], tree["opt_state"], manifest["meta"] | {"step": manifest["step"]}
