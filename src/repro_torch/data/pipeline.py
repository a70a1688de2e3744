"""Deterministic, restart-safe data pipeline with prefetch + straggler skip.

Design for 1000+ nodes:

* **step-indexed determinism** — batch ``i`` is a pure function of
  ``(seed, i)``; a restarted (or elastically re-sized) job replays exactly
  the same stream from its checkpointed step, with no iterator state to
  snapshot.
* **host sharding** — each host materialises only its slice of the global
  batch (``host_id``/``n_hosts``), matching jax.Array per-host addressing.
* **prefetch** — a background thread keeps ``depth`` batches ready;
* **straggler mitigation** — ``next()`` with a deadline: if the source
  stalls past ``straggler_timeout_s`` (slow storage shard — the data-side
  straggler case), the batch is *skipped* and a locally-generated filler
  batch (deterministic from the step index) is substituted, so one slow
  host cannot stall the collective step.  Skips are counted per stream in
  the instrumentation layer.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "TokenFileSource", "Prefetcher", "make_train_iter"]


@dataclass(frozen=True)
class DataConfig:
    global_batch: int = 8
    seq_len: int = 128
    vocab_size: int = 512
    seed: int = 1234
    host_id: int = 0
    n_hosts: int = 1
    prefetch_depth: int = 2
    straggler_timeout_s: float = 0.0  # 0 = disabled
    # stub-frontend extras
    enc_len: int = 0  # whisper: frame-embedding length
    d_model: int = 0
    vision_tokens: int = 0


class SyntheticLM:
    """Deterministic synthetic LM batches: batch i = f(seed, i).

    Produces a self-predictable sequence family (affine step patterns with
    per-sequence offsets) so a ~100M model visibly learns within a few
    hundred steps — real signal for the end-to-end example, not noise.
    """

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=[0, 0, cfg.host_id, index]))
        B, S, V = self.local_batch, cfg.seq_len, cfg.vocab_size
        start = rng.integers(0, V, (B, 1))
        stride = rng.integers(1, 7, (B, 1))
        toks = (start + stride * np.arange(S + 1)[None, :]) % V
        noise = rng.random((B, S + 1)) < 0.02
        toks = np.where(noise, rng.integers(0, V, (B, S + 1)), toks).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
        if cfg.enc_len and cfg.d_model:
            out["enc_embeds"] = rng.standard_normal((B, cfg.enc_len, cfg.d_model), dtype=np.float32)
        if cfg.vision_tokens and cfg.d_model:
            out["vision_embeds"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model), dtype=np.float32)
        return out


class TokenFileSource:
    """Pre-tokenised corpus from a flat uint32 file (memory-mapped), cut into
    step-indexed windows — same determinism contract as SyntheticLM."""

    def __init__(self, path: str, cfg: DataConfig) -> None:
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.uint32, mode="r")
        self.local_batch = cfg.global_batch // cfg.n_hosts
        n_windows = (len(self.tokens) - 1) // cfg.seq_len
        if n_windows < 1:
            raise ValueError("corpus smaller than one sequence")
        self.n_windows = n_windows

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = self.local_batch, cfg.seq_len
        base = (index * cfg.n_hosts + cfg.host_id) * B
        rows = [(base + i) % self.n_windows for i in range(B)]
        toks = np.stack([self.tokens[r * S : r * S + S + 1] for r in rows]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background prefetch with optional straggler-skip."""

    def __init__(self, source, cfg: DataConfig, start_index: int = 0) -> None:
        self.source = source
        self.cfg = cfg
        self.index = start_index
        self.skipped = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, cfg.prefetch_depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        i = self.index
        while not self._stop.is_set():
            try:
                b = self.source.batch_at(i)
            except Exception:
                break
            self._q.put((i, b))
            i += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        timeout = self.cfg.straggler_timeout_s or None
        try:
            i, b = self._q.get(timeout=timeout)
            self.index = i + 1
            return b
        except queue.Empty:
            # straggler: substitute a deterministic filler batch and move on
            self.skipped += 1
            filler = SyntheticLM(self.cfg).batch_at(self.index)
            self.index += 1
            return filler

    def close(self) -> None:
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()


def make_train_iter(cfg: DataConfig, path: Optional[str] = None, start_index: int = 0) -> Prefetcher:
    source = TokenFileSource(path, cfg) if path else SyntheticLM(cfg)
    return Prefetcher(source, cfg, start_index)
