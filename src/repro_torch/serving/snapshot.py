"""Immutable per-version window snapshots + the shared answer kernels.

The reader/writer contract of the serving layer (DESIGN.md §11) hinges on
one rule: a reader answers a query entirely from **one**
:class:`WindowSnapshot` object, grabbed by a single reference read.  The
writer builds the next snapshot off to the side and publishes it with one
attribute assignment (atomic in CPython), so a query racing ``ingest`` sees
either the old window or the new one, never a torn mixture — and every
answer is stamped with the version it was computed against.

The answer kernels here are the *only* implementation of top-k / support /
rules in the package; the synchronous
:class:`~repro_torch.serving.StreamQueryService` and the batched admission
front end (:class:`~repro_torch.serving.ServingFrontend`) both call them, so
"batched answer == direct answer at the same version" holds by
construction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.itemsets import generate_rules
from .cache import VersionedCache

__all__ = ["WindowSnapshot", "answer_topk", "answer_rules", "answer_support",
           "answer_query"]


@dataclasses.dataclass(frozen=True)
class WindowSnapshot:
    """One consistent, immutable view of a mined window.

    ``version`` is the miner's ``window_version`` at mine time; ``itemsets``
    is the store's ``(itemset, support)`` list and ``support_map`` its dict
    form.  Frozen: readers share it freely across threads.
    """

    version: int
    n_txn: int
    itemsets: Tuple[Tuple[Tuple[int, ...], int], ...]
    support_map: Dict[Tuple[int, ...], int]

    @classmethod
    def from_result(cls, result) -> "WindowSnapshot":
        """Snapshot a :class:`~repro_torch.streaming.WindowResult` (host copies)."""
        itemsets = tuple(result.itemsets())
        return cls(version=int(result.version), n_txn=int(result.n_txn),
                   itemsets=itemsets, support_map=dict(itemsets))

    @classmethod
    def empty(cls, version: int = 0) -> "WindowSnapshot":
        return cls(version=int(version), n_txn=0, itemsets=(), support_map={})


# -- answer kernels (shared by the sync adapter and the batched front end) ---

def _sorted_topk(snap: WindowSnapshot, min_len: int,
                 cache: Optional[VersionedCache]):
    """All itemsets of length >= min_len, sorted by (-support, -len, lex);
    cached per (version, min_len) so any k slices the same list."""
    key = ("topk", int(min_len))
    if cache is not None:
        found, value = cache.lookup(snap.version, key)
        if found:
            return value, True
    cand = [(s, it) for it, s in snap.itemsets if len(it) >= min_len]
    cand.sort(key=lambda e: (-e[0], -len(e[1]), e[1]))
    value = [(it, s) for s, it in cand]
    if cache is not None:
        cache.insert(snap.version, key, value)
    return value, False


def answer_topk(snap: WindowSnapshot, k: int = 10, min_len: int = 1,
                cache: Optional[VersionedCache] = None):
    """k most supported frequent itemsets (ties: longer, then lex)."""
    ranked, _ = _sorted_topk(snap, min_len, cache)
    return ranked[:k]


def answer_support(snap: WindowSnapshot, itemset: Sequence[int]) -> int:
    """Support of one itemset over the snapshot window (0 if infrequent)."""
    return snap.support_map.get(tuple(sorted(itemset)), 0)


def _sorted_rules(snap: WindowSnapshot, min_conf: float,
                  cache: Optional[VersionedCache]):
    """Full confidence-ranked rule list, cached per (version, min_conf)."""
    key = ("rules", float(min_conf))
    if cache is not None:
        found, value = cache.lookup(snap.version, key)
        if found:
            return value, True
    value = sorted(generate_rules(snap.support_map, min_conf),
                   key=lambda r: (-r[2], -r[3], r[0], r[1]))
    if cache is not None:
        cache.insert(snap.version, key, value)
    return value, False


def answer_rules(snap: WindowSnapshot, min_conf: float = 0.8,
                 k: Optional[int] = None,
                 cache: Optional[VersionedCache] = None):
    """Most confident association rules over the snapshot window.

    A cache hit at ``k=None`` returns the identical list object (callers
    must not mutate it — the sync adapter's cache-identity test relies on
    it).
    """
    rules, _ = _sorted_rules(snap, min_conf, cache)
    return rules if k is None else rules[:k]


def answer_query(snap: WindowSnapshot, query,
                 cache: Optional[VersionedCache] = None):
    """Dispatch one :class:`~repro_torch.serving.ItemsetQuery` against ``snap``.

    Returns ``(answer, cache_hit)``; unknown kinds raise ``ValueError``
    (same contract as the pre-refactor ``answer_batch``).
    """
    if query.kind == "topk":
        ranked, hit = _sorted_topk(snap, query.min_len, cache)
        return ranked[:query.k], hit
    if query.kind == "rules":
        rules, hit = _sorted_rules(snap, query.min_conf, cache)
        return (rules if query.k is None else rules[:query.k]), hit
    raise ValueError(f"unknown query kind {query.kind!r}")
