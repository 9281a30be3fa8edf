"""Per-query serving instrumentation: enqueue→drain→answer latency, QPS.

A copy of the reference package's ``serving/metrics.py`` (host Python).

Every query that crosses the serving front end (DESIGN.md §11) carries three
timestamps: ``t_enqueue`` (admission), ``t_drain`` (its batch left the
admission queue), ``t_answer`` (answer materialized).  ``ServingMetrics``
aggregates them into the SLO numbers the north star asks for — p50/p99 of
total latency and of its queue-wait and answer components, plus sustained
queries/sec — and carries the backpressure/staleness counters (shed queries,
writer-stall detections) that the latency distribution alone cannot show.

Thread-safe: readers record from the drain worker while clients submit and
the writer slides windows; ``summary()`` takes a consistent copy under the
same lock.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ServingMetrics", "percentiles", "now"]


def percentiles(xs: Sequence[float], qs: Sequence[float] = (50.0, 99.0)) -> Dict[str, float]:
    """``{"p50": ..., "p99": ...}`` in milliseconds (empty input -> zeros)."""
    if len(xs) == 0:
        return {f"p{int(q)}": 0.0 for q in qs}
    vals = np.percentile(np.asarray(xs, np.float64), list(qs))
    return {f"p{int(q)}": float(v) * 1e3 for q, v in zip(qs, vals)}


class ServingMetrics:
    """Latency histogram + counters for one serving front end."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total: List[float] = []      # t_answer - t_enqueue
        self._queue: List[float] = []      # t_drain - t_enqueue
        self._answer: List[float] = []     # t_answer - t_drain
        self._first_enqueue: Optional[float] = None
        self._last_answer: Optional[float] = None
        self._batch_sizes: List[int] = []
        self.n_answered = 0
        self.n_cache_hits = 0
        self.n_shed = 0
        self.n_errors = 0
        self.n_stalls = 0

    # -- recording -----------------------------------------------------------

    def record_answer(self, t_enqueue: float, t_drain: float, t_answer: float,
                      *, cache_hit: bool = False) -> None:
        with self._lock:
            self._total.append(t_answer - t_enqueue)
            self._queue.append(t_drain - t_enqueue)
            self._answer.append(t_answer - t_drain)
            if self._first_enqueue is None or t_enqueue < self._first_enqueue:
                self._first_enqueue = t_enqueue
            if self._last_answer is None or t_answer > self._last_answer:
                self._last_answer = t_answer
            self.n_answered += 1
            if cache_hit:
                self.n_cache_hits += 1

    def record_batch(self, n: int) -> None:
        with self._lock:
            self._batch_sizes.append(int(n))

    def record_shed(self) -> None:
        with self._lock:
            self.n_shed += 1

    def record_error(self) -> None:
        with self._lock:
            self.n_errors += 1

    def record_stall(self) -> None:
        with self._lock:
            self.n_stalls += 1

    # -- aggregation ---------------------------------------------------------

    def summary(self) -> dict:
        """p50/p99 (ms) of total / queue-wait / answer latency, QPS, batch
        shape, and the shed/error/stall counters."""
        with self._lock:
            total, queue, answer = list(self._total), list(self._queue), list(self._answer)
            batches = list(self._batch_sizes)
            span = ((self._last_answer - self._first_enqueue)
                    if self._first_enqueue is not None
                    and self._last_answer is not None else 0.0)
            out = {
                "n_answered": self.n_answered,
                "n_shed": self.n_shed,
                "n_errors": self.n_errors,
                "n_stalls": self.n_stalls,
                "cache_hit_rate": (self.n_cache_hits / self.n_answered
                                   if self.n_answered else 0.0),
            }
        out["latency_ms"] = percentiles(total)
        out["queue_wait_ms"] = percentiles(queue)
        out["answer_ms"] = percentiles(answer)
        out["qps"] = (len(total) / span) if span > 0 else 0.0
        out["mean_batch"] = float(np.mean(batches)) if batches else 0.0
        out["n_batches"] = len(batches)
        return out


def now() -> float:
    """The serving clock (one place, so tests can reason about it)."""
    return time.perf_counter()
