"""Deterministic synthetic data pipeline with host sharding + prefetch.

Counterpart of ``repro/data/pipeline.py``: ``synth_batch`` is the
reference's, verbatim, so both packages train on the same NumPy batches
bit for bit.  ``Pipeline`` is the reference's: ``host_index`` and
``host_count`` default to the process group's rank and size
(``launch/procs.py``), as the reference's follow
``jax.process_index()`` / ``jax.process_count()``, and to 0 and 1
without one.  Produces the token/label (and frame/patch) batches
each architecture takes, deterministic per (seed, step), so a restarted
trainer replays the exact stream from its checkpoint step; a background
thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


def synth_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, *,
                seed: int = 0, host_index: int = 0, host_count: int = 1):
    """The batch for ``step`` (this host's slice)."""
    b = shape.global_batch // host_count
    s = shape.seq_len
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, host_index]))
    # zipf-ish token stream: realistic embedding-gather skew (paper §2.3)
    def toks(n, t):
        z = rng.zipf(1.3, size=(n, t))
        return ((z - 1) % cfg.vocab_size).astype(np.int32)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
                    (b, s // 2, cfg.d_model)).astype(np.float32),
                "tokens": toks(b, s // 2),
                "labels": toks(b, s // 2)}
    if cfg.family == "vlm":
        p = cfg.num_patches
        return {"patches": rng.standard_normal(
                    (b, p, cfg.d_model)).astype(np.float32),
                "tokens": toks(b, s - p),
                "labels": toks(b, s - p)}
    t = toks(b, s + 1)
    return {"tokens": t[:, :-1], "labels": t[:, 1:].copy()}


class Pipeline:
    def __init__(self, cfg, shape, *, seed=0, start_step=0, prefetch=2,
                 host_index=None, host_count=None):
        from ..launch import procs
        group = procs.current()
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.host_index = host_index if host_index is not None \
            else (group.rank if group else 0)
        self.host_count = host_count if host_count is not None \
            else (group.size if group else 1)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="pipeline-prefetch")
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, self.shape, step, seed=self.seed,
                                host_index=self.host_index,
                                host_count=self.host_count)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        # drain so a worker blocked on a full queue sees the stop flag on
        # its next put timeout, then reap it — close() must not leave the
        # prefetch thread running against a torn-down pipeline
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
