"""Deterministic synthetic LM token pipeline (a copy of the reference
package's ``data/lm_pipeline.py``, which is numpy only: the two give equal
token streams, bit for bit, sharded ones included).

Batch ``i`` is a pure function of ``(seed, i)``: a restarted or elastically
resharded run reproduces the exact token stream by construction (O(1)
skip-ahead — no data-loader state in checkpoints).  Tokens come from a
Zipf-weighted order-1 Markov chain so a small model has real structure to
learn (``repro_torch.examples.train_lm`` shows the loss dropping).  A background prefetch
thread overlaps host generation with device steps.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                 n_states: int = 64, prefetch: int = 2,
                 shard_index: int = 0, shard_count: int = 1):
        self.vocab_size = int(vocab_size)
        self.batch = int(batch)
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        self.shard_index = int(shard_index)
        self.shard_count = int(shard_count)
        rng = np.random.default_rng(seed ^ 0xC0FFEE)
        # shared Markov structure: n_states latent states, Zipf emissions
        self._trans = rng.dirichlet(np.full(n_states, 0.3), size=n_states)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        zipf = ranks ** -1.1
        self._emit_base = zipf / zipf.sum()
        # Generator.choice(p=...)'s own inverse-CDF draw, its CDF made once
        # here rather than on every call: the same tokens from the same
        # stream of uniforms, without a pass over the vocabulary per token
        self._emit_cdf = np.cumsum(self._emit_base)
        self._emit_cdf /= self._emit_cdf[-1]
        self._emit_shift = rng.integers(0, self.vocab_size, size=n_states)
        self._queue: Optional[queue.Queue] = None
        self._prefetch = prefetch
        self._stop = threading.Event()

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for global step ``step`` (this shard's slice)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 31 + self.shard_index)
        b = self.batch // self.shard_count
        toks = np.zeros((b, self.seq_len), np.int32)
        state = rng.integers(0, self._trans.shape[0], size=b)
        for t in range(self.seq_len):
            u = rng.random(b)
            cum = np.cumsum(self._trans[state], axis=1)
            state = (cum < u[:, None]).sum(axis=1)
            base = self._emit_cdf.searchsorted(rng.random(b), side="right")
            toks[:, t] = (base + self._emit_shift[state]) % self.vocab_size
        return {"tokens": toks}

    # ---- prefetching iterator -------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        return self.iterate(0)

    def iterate(self, start_step: int) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
