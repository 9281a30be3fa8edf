"""Equivalence classes of the level-wise frontier.

The paper's Phase-3/4 builds 1-length-prefix equivalence classes and runs
Zaki's recursive Bottom-Up search inside each class.  The card runs
fixed-shape batches, so recursion becomes *level-wise expansion with a
host-driven loop* (the Spark driver analogue): the device executes batched
AND+popcount over bucket-padded pair lists; the host owns the data-dependent
bookkeeping (class segmentation, itemset reconstruction).

Class invariant used throughout: a candidate produced by joining members
``a < b`` of a class is assigned class id = (global row index of ``a``).
Rows are emitted in ascending (class, a, b) order, so every class is a
contiguous row segment at every level — exactly the prefix-sorted layout the
paper gets from lexicographic generation.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["segment_pairs", "class_segments", "pair_work"]

_TRIU_CACHE: dict[int, Tuple[np.ndarray, np.ndarray]] = {}


def _triu_pairs(m: int) -> Tuple[np.ndarray, np.ndarray]:
    got = _TRIU_CACHE.get(m)
    if got is None:
        got = np.triu_indices(m, k=1)
        got = (got[0].astype(np.int64), got[1].astype(np.int64))
        _TRIU_CACHE[m] = got
    return got


def class_segments(class_id: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Start offsets and sizes of the contiguous class segments."""
    if class_id.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.nonzero(np.diff(class_id))[0] + 1
    starts = np.concatenate([[0], change]).astype(np.int64)
    ends = np.concatenate([change, [class_id.shape[0]]]).astype(np.int64)
    return starts, ends - starts


def segment_pairs(starts: np.ndarray, sizes: np.ndarray):
    """All within-class join pairs (global row indices), class-ordered.

    Returns (left, right) with left < right row indices; candidates are
    ``itemset(left) ∪ {last_item(right)}`` per Algorithm 1.
    """
    lefts: List[np.ndarray] = []
    rights: List[np.ndarray] = []
    for s, m in zip(starts.tolist(), sizes.tolist()):
        if m < 2:
            continue
        li, ri = _triu_pairs(int(m))
        lefts.append(li + s)
        rights.append(ri + s)
    if not lefts:
        z = np.zeros(0, np.int64)
        return z, z.copy()
    return np.concatenate(lefts), np.concatenate(rights)


def pair_work(sizes: np.ndarray, n_words: int) -> np.ndarray:
    """Per-class first-expansion work estimate in word-ops: C(m,2) * W."""
    m = sizes.astype(np.float64)
    return (m * (m - 1) / 2.0) * float(n_words)
