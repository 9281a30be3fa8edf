"""Equivalence-class partitioners (paper §4.5, Algorithm 10) + beyond-paper.

``getPartition(v)`` maps the rank ``v`` of a class's 1-length prefix (ranks
are assigned 0..n-1 in the frequent-item sort order) to a partition id.

Paper partitioners:
  * default       : partition v   -> one class per partition ((n-1) partitions)
  * hash          : v % p                                  (EclatV4)
  * reverse_hash  : r = v % p; v >= p ? (p-1) - r : r       (EclatV5)

Beyond paper:
  * greedy        : LPT bin-packing on an explicit per-class work estimate —
    classes sorted by decreasing estimated work, each placed on the currently
    lightest partition.  The estimate |EC_v|^2 * W counts the AND/popcount
    word-ops of the class's first expansion level, which empirically
    dominates the subtree cost.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = [
    "default_partitioner",
    "hash_partitioner",
    "reverse_hash_partitioner",
    "greedy_partitioner",
    "assign_partitions",
    "pack_items",
    "partition_stats",
    "PARTITIONERS",
]


def default_partitioner(v: np.ndarray, p: int, work: Optional[np.ndarray] = None) -> np.ndarray:
    """Paper's default: class v -> partition v (n-1 singleton partitions).

    With a fixed executor/device count ``p`` Spark schedules those (n-1)
    tasks round-robin; the modulo below is that scheduling step, applied
    after the identity partitioning so semantics match the paper's V1-V3.
    """
    v = np.asarray(v, dtype=np.int64)
    return v % int(p)


def hash_partitioner(v: np.ndarray, p: int, work: Optional[np.ndarray] = None) -> np.ndarray:
    """EclatV4: getPartition(v) = v % p."""
    v = np.asarray(v, dtype=np.int64)
    return v % int(p)


def reverse_hash_partitioner(v: np.ndarray, p: int, work: Optional[np.ndarray] = None) -> np.ndarray:
    """EclatV5: reflect every second "row" of the modulo so that big and small
    classes (class size is monotone in prefix rank) alternate ends."""
    v = np.asarray(v, dtype=np.int64)
    p = int(p)
    r = v % p
    return np.where(v >= p, (p - 1) - r, r)


def greedy_partitioner(v: np.ndarray, p: int, work: Optional[np.ndarray] = None) -> np.ndarray:
    """Beyond-paper LPT: heaviest class first onto the lightest partition."""
    v = np.asarray(v, dtype=np.int64)
    p = int(p)
    if work is None:
        # fall back to the structural estimate: class of rank v among n items
        # has (n-1-v) members -> first-level pair work ~ members^2
        n = int(v.max()) + 1 if v.size else 0
        members = (n - 1 - v).clip(min=0)
        work = members.astype(np.float64) ** 2
    work = np.asarray(work, dtype=np.float64)
    order = np.argsort(-work, kind="stable")
    loads = np.zeros(p, dtype=np.float64)
    out = np.zeros(v.shape[0], dtype=np.int64)
    for idx in order:
        tgt = int(np.argmin(loads))
        out[idx] = tgt
        loads[tgt] += work[idx]
    return out


PARTITIONERS: dict[str, Callable] = {
    "default": default_partitioner,
    "hash": hash_partitioner,
    "reverse_hash": reverse_hash_partitioner,
    "greedy": greedy_partitioner,
}


def assign_partitions(
    n_classes: int,
    partitioner: str,
    p: int,
    work: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Partition table: class rank -> partition id.  This table plus the
    immutable vertical DB is the full lineage of every partition."""
    if n_classes <= 0:
        return np.zeros(0, dtype=np.int64)
    fn = PARTITIONERS[partitioner]
    v = np.arange(n_classes, dtype=np.int64)
    return fn(v, p, work)


def pack_items(work: np.ndarray, n_slots: int):
    """Greedy-LPT pack ``len(work)`` items into ``n_slots`` balanced groups.

    The one packing entry point the serving side shares
    (``serving.engine.pack_requests``): items are placed heaviest-first on
    the lightest slot and the balance of the assignment that will actually
    run is reported.  Returns ``(assignment, stats)``.
    """
    work = np.asarray(work, dtype=np.float64)
    assign = greedy_partitioner(np.arange(work.shape[0]), int(n_slots),
                                work=work)
    return assign, partition_stats(assign, work, int(n_slots))


def partition_stats(assignment: np.ndarray, work: np.ndarray, p: int) -> dict:
    """Balance metrics.  ``padding_efficiency`` = mean/max per-partition work:
    when every device steps the padded maximum, this is the fraction of
    device cycles doing useful ANDs — the paper's workload-balance argument
    restated for lock-step devices."""
    loads = np.zeros(int(p), dtype=np.float64)
    np.add.at(loads, np.asarray(assignment, dtype=np.int64), np.asarray(work, dtype=np.float64))
    total = float(loads.sum())
    mx = float(loads.max()) if loads.size else 0.0
    return {
        "loads": loads,
        "max": mx,
        "mean": total / max(int(p), 1),
        "cv": float(loads.std() / loads.mean()) if total > 0 else 0.0,
        "padding_efficiency": (total / (mx * int(p))) if mx > 0 else 1.0,
    }
