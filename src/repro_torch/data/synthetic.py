"""Synthetic token pipeline: sharded, deterministic, prefetching.

Per-host iterator yielding numpy batches; in a multi-host deployment each
host draws its own shard (seeded by host id) and device_put's onto its
addressable slice of the batch sharding — here single-host, same code path.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class TokenPipeline:
    """Deterministic zipfian token stream with doc boundaries (resumable)."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0, start_step: int = 0, extras: dict | None = None):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.step = start_step
        self.extras = extras or {}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        # zipf-ish marginal so losses have structure to learn
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = np.minimum(z, self.vocab - 1).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for k, shape in self.extras.items():
            batch[k] = rng.standard_normal((self.batch,) + shape).astype(np.float32)
        return batch


class Prefetcher:
    """Background-thread prefetch (depth-bounded) over any iterator."""

    def __init__(self, it, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        t = threading.Thread(target=self._fill, daemon=True)
        t.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
