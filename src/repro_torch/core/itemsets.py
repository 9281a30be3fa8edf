"""Itemset store, reconstruction and association-rule generation.

Frontier rows carry (parent pointer, last item) only; this module turns the
per-level row records into explicit itemsets (the ``saveAsTextFile`` analogue)
and implements ARM step 2 (confident rules) for completeness.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["LevelRecord", "ItemsetStore", "generate_rules", "support_checksum"]


@dataclasses.dataclass
class LevelRecord:
    """Compact record of one mined level (host-side, bitmap-free)."""

    k: int
    parent: np.ndarray      # (P,) row index into level k-1 (-1 at k == 1)
    item_rank: np.ndarray   # (P,) frequent-item rank of the last item
    support: np.ndarray     # (P,)
    partition: np.ndarray   # (P,)


class ItemsetStore:
    """Accumulates LevelRecords and reconstructs explicit itemsets."""

    def __init__(self, item_ids: np.ndarray):
        self._item_ids = np.asarray(item_ids, dtype=np.int64)
        self.levels: List[LevelRecord] = []

    def add_level(self, rec: LevelRecord) -> None:
        if self.levels and rec.k != self.levels[-1].k + 1:
            raise ValueError("levels must be added in order")
        self.levels.append(rec)

    @property
    def counts(self) -> List[int]:
        return [int(l.parent.shape[0]) for l in self.levels]

    @property
    def total(self) -> int:
        return int(sum(self.counts))

    def itemsets(self) -> List[Tuple[Tuple[int, ...], int]]:
        """All frequent itemsets as (sorted item-id tuple, support)."""
        out: List[Tuple[Tuple[int, ...], int]] = []
        prev_paths: List[Tuple[int, ...]] = []
        for rec in self.levels:
            paths: List[Tuple[int, ...]] = []
            for r in range(rec.parent.shape[0]):
                item = int(self._item_ids[rec.item_rank[r]])
                if rec.k == 1:
                    path = (item,)
                else:
                    path = prev_paths[int(rec.parent[r])] + (item,)
                paths.append(path)
                out.append((tuple(sorted(path)), int(rec.support[r])))
            prev_paths = paths
        return out

    def support_map(self) -> Dict[Tuple[int, ...], int]:
        return dict(self.itemsets())


def generate_rules(
    support_map: Dict[Tuple[int, ...], int], min_conf: float
) -> List[Tuple[Tuple[int, ...], Tuple[int, ...], float, int]]:
    """ARM step 2: rules X => Y with conf = sup(X∪Y)/sup(X) >= min_conf.

    Returns (antecedent, consequent, confidence, support) tuples.
    """
    from itertools import combinations

    rules = []
    for itemset, sup in support_map.items():
        k = len(itemset)
        if k < 2:
            continue
        for r in range(1, k):
            for ante in combinations(itemset, r):
                sup_a = support_map.get(tuple(sorted(ante)))
                if not sup_a:
                    continue
                conf = sup / sup_a
                if conf >= min_conf:
                    cons = tuple(sorted(set(itemset) - set(ante)))
                    rules.append((tuple(sorted(ante)), cons, float(conf), int(sup)))
    return rules


def support_checksum(support_map: Dict[Tuple[int, ...], int]) -> str:
    """Stable digest of a full (itemset, support) map: identical mining
    output <=> identical checksum, independent of dict order.  The same
    digest as the reference package's headline benchmark, so a checksum
    printed by either package can be compared with the other's."""
    lines = sorted(f"{','.join(map(str, k))}:{int(v)}"
                   for k, v in support_map.items())
    return hashlib.sha1("\n".join(lines).encode()).hexdigest()[:16]
