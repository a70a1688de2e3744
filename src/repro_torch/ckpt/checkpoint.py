"""Sharded, async, elastic checkpointing of the parameter and optimizer trees.

Layout per step, as in the reference (``ckpt/checkpoint.py``)::

    <dir>/step_<N>/
        manifest.json        # leaf paths, shapes, dtypes, meta (host 0)
        host_<H>.npz         # the leaves host H was given, whole
        COMMIT               # written last by host 0 → restore ignores partial saves

* **atomicity** — host 0 writes COMMIT only after its manifest and leaf
  file are fsync'd; a preempted save is invisible to :meth:`restore_latest`.
* **async** — :meth:`save` copies every leaf to host memory on the caller's
  thread (the consistency point) and writes on a background thread.
* **elastic restore** — the manifest records global shapes, and a restore
  merges every host's file, so a job restarted on another topology or host
  count places each leaf anew: on ``device``, or through ``sharding_fn``
  (the reference's callback) onto a ``DeviceMesh`` with
  ``distribute_tensor``.
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
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.params import iter_leaves

__all__ = ["CheckpointManager"]

#: the entry of a host's file that names each of its leaves' dtypes (bf16 is stored as its 16 bits)
_DTYPES = "__dtypes__"

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
    def __init__(self, directory: str, *, host_id: int = 0, n_hosts: int = 1, keep: int = 3):
        self.dir = directory
        self.host_id = host_id
        self.n_hosts = n_hosts
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
            "n_hosts": self.n_hosts,
            "time": time.time(),
        }

        def _write():
            d = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(d, exist_ok=True)
            if self.host_id == 0:
                with open(os.path.join(d, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
            with open(os.path.join(d, f"host_{self.host_id}.npz"), "wb") as f:
                dtypes = json.dumps({k: dt for k, _, dt in host_items})  # its own leaves' dtypes
                np.savez(f, **{_DTYPES: np.array(dtypes)}, **{k.replace("/", "|"): a for k, a, _ in host_items})
                f.flush()
                os.fsync(f.fileno())
            if self.host_id == 0:
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

    def restore_latest(self, device=None, sharding_fn: Optional[Callable[[str, tuple], Any]] = None):
        """Returns ``(params, opt_state, meta)`` of the latest commit, merged
        from every host's file, or None when nothing is committed.

        ``sharding_fn(key, shape) -> (DeviceMesh, placements) | None`` lets
        an elastic restart place each leaf onto the *new* mesh
        (``distribute_tensor``); a leaf it gives None for, or every leaf
        without it, lands on ``device`` (the CPU when None).
        """
        steps = self.committed_steps()
        if not steps:
            return None
        d = os.path.join(self.dir, f"step_{steps[-1]:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        tree: Dict[str, Any] = {}
        for h in range(manifest.get("n_hosts", 1)):
            path = os.path.join(d, f"host_{h}.npz")
            if not os.path.exists(path):
                continue
            with np.load(path) as z:
                dtypes = json.loads(str(z[_DTYPES]))
                for name in z.files:
                    if name == _DTYPES:
                        continue
                    key = name.replace("|", "/")
                    leaf = _from_host(z[name], dtypes[key])
                    *parents, last = key.split("/")
                    cur = tree
                    for p in parents:
                        cur = cur.setdefault(p, {})
                    cur[last] = self._place(key, leaf, device, sharding_fn)
        return tree["params"], tree["opt_state"], manifest["meta"] | {"step": manifest["step"]}

    @staticmethod
    def _place(key: str, leaf: torch.Tensor, device, sharding_fn) -> torch.Tensor:
        placed = sharding_fn(key, tuple(leaf.shape)) if sharding_fn is not None else None
        if placed is not None:
            from torch.distributed.tensor import distribute_tensor

            mesh, placements = placed
            return distribute_tensor(leaf, mesh, placements)
        return leaf.to(device) if device is not None else leaf
