"""Brute-force FIM oracle for correctness tests (host-only, tiny inputs)."""
from __future__ import annotations

from itertools import combinations
from typing import Dict, Sequence, Tuple

__all__ = ["bruteforce_fim"]


def bruteforce_fim(
    transactions: Sequence[Sequence[int]], min_sup: int, max_k: int | None = None
) -> Dict[Tuple[int, ...], int]:
    """All frequent itemsets by direct enumeration.  Exponential — tests only."""
    txn_sets = [frozenset(int(i) for i in t) for t in transactions]
    counts: Dict[int, int] = {}
    for t in txn_sets:
        for i in t:
            counts[i] = counts.get(i, 0) + 1
    freq_items = sorted(i for i, c in counts.items() if c >= min_sup)
    out: Dict[Tuple[int, ...], int] = {}
    # None-check, not truthiness: max_k=0 means "no itemsets", not
    # "unbounded"
    kmax = len(freq_items) if max_k is None else max_k
    for k in range(1, kmax + 1):
        found_any = False
        for combo in combinations(freq_items, k):
            s = frozenset(combo)
            sup = sum(1 for t in txn_sets if s <= t)
            if sup >= min_sup:
                out[tuple(combo)] = sup
                found_any = True
        if not found_any:
            break
    return out
