"""Workload modes on top of the mined lattice: closed / maximal / top-k.

The paper mines *all* frequent itemsets.  Production consumers rarely want
the full lattice — they want its non-redundant frontier (closed itemsets:
the smallest set that still determines every frequent support), its outline
(maximal itemsets: the longest patterns), or simply "the k strongest
patterns" without having to guess a support threshold at all.  All three
are derivable from the level records the engine already produces, so they
run as host-side post-filters on the ``ItemsetStore`` lineage — no new
device code, every engine backend gets them for free, and the bit-exactness
contract carries over (DESIGN.md §9).

Definitions (over the *mined* lattice — with ``max_k`` set, "closed"
means closed among itemsets of length <= max_k):

  closed    X with no proper frequent superset of equal support.  Lossless:
            :func:`frequent_from_closed` reconstructs every frequent
            itemset's support as the max over its closed supersets.
  maximal   X with no proper frequent superset at all.  maximal ⊆ closed.
  top-k     the k highest-support itemsets, found by an adaptive min_sup
            ladder (:func:`top_k_mine`) — no user threshold; ties broken
            deterministically by (support desc, length asc, items lex asc).

Anti-monotonicity makes the immediate-superset check sufficient: if any
proper superset of X has sup(X), some superset with exactly one more item
does too (supports only fall along the lattice), so each k-itemset only
has to look at its (k-1)-subsets' records — O(total · k) overall.
"""
from __future__ import annotations

import dataclasses
from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple

Itemset = Tuple[int, ...]
SupportMap = Dict[Itemset, int]

__all__ = ["closed_itemsets", "maximal_itemsets", "frequent_from_closed",
           "filter_mode", "TopKResult", "top_k_mine", "WORKLOAD_MODES"]

WORKLOAD_MODES = ("all", "closed", "maximal")


def _immediate_subsets(itemset: Itemset):
    """All (k-1)-subsets of a sorted k-tuple, still sorted."""
    for drop in range(len(itemset)):
        yield itemset[:drop] + itemset[drop + 1:]


def closed_itemsets(support_map: SupportMap) -> SupportMap:
    """The closed subset of a frequent-itemset map.

    One pass over the map marks, for every itemset, the immediate subsets
    whose support it ties — those subsets have a proper superset of equal
    support and are exactly the non-closed ones.
    """
    non_closed: set = set()
    for itemset, sup in support_map.items():
        if len(itemset) < 2:
            continue
        for sub in _immediate_subsets(itemset):
            if support_map.get(sub) == sup:
                non_closed.add(sub)
    return {s: v for s, v in support_map.items() if s not in non_closed}


def maximal_itemsets(support_map: SupportMap) -> SupportMap:
    """The maximal subset: itemsets with no frequent proper superset."""
    non_maximal: set = set()
    for itemset in support_map:
        if len(itemset) < 2:
            continue
        for sub in _immediate_subsets(itemset):
            non_maximal.add(sub)
    return {s: v for s, v in support_map.items() if s not in non_maximal}


def frequent_from_closed(closed_map: SupportMap) -> SupportMap:
    """Reconstruct the full frequent map from its closed representation.

    sup(X) = max{ sup(C) : C closed, X ⊆ C } — the closure operator.
    Exponential in the longest closed itemset (it enumerates subsets), so
    this is a verification/serving utility for the itemset lengths real
    databases produce, not an engine path.
    """
    out: SupportMap = {}
    for closed, sup in closed_map.items():
        for r in range(1, len(closed) + 1):
            for sub in combinations(closed, r):
                if out.get(sub, -1) < sup:
                    out[sub] = sup
    return out


def filter_mode(support_map: SupportMap, mode: str) -> SupportMap:
    """Apply a workload mode ("all" | "closed" | "maximal") to a mined map."""
    if mode == "all":
        return dict(support_map)
    if mode == "closed":
        return closed_itemsets(support_map)
    if mode == "maximal":
        return maximal_itemsets(support_map)
    raise ValueError(f"unknown workload mode {mode!r}; "
                     f"expected one of {WORKLOAD_MODES}")


# ---------------------------------------------------------------------------
# top-k: the thresholdless serving mode
# ---------------------------------------------------------------------------

def topk_sort_key(entry: Tuple[Itemset, int]):
    """Deterministic total order for top-k: support desc, then shorter
    itemsets first, then items lexicographically."""
    itemset, sup = entry
    return (-int(sup), len(itemset), itemset)


@dataclasses.dataclass
class TopKResult:
    """Outcome of :func:`top_k_mine`."""

    itemsets: List[Tuple[Itemset, int]]   # exactly k, or all if fewer exist
    k: int
    abs_min_sup: int                      # the rung the answer was read at
    ladder: List[dict]                    # per rung: abs_min_sup, n_found
    stats: dict


def top_k_mine(
    transactions: Sequence[Sequence[int]],
    n_items: int,
    k: int,
    config=None,
    *,
    device=None,
    min_len: int = 1,
    mesh=None,
) -> TopKResult:
    """Mine the k highest-support itemsets without a user threshold.

    Adaptive min_sup ladder, seeded from the data: the first rung is the
    k-th largest *singleton* support — at that threshold at least k
    singletons (hence >= k itemsets) are frequent, so on the default
    ``min_len=1`` the ladder terminates after one mine() even on dense
    databases where a naive "start at 50%" rung would enumerate an
    astronomically large lattice (chess at min_sup=0.5 is the classic
    blow-up).  When a rung still comes back short (fewer than k itemsets of
    length >= ``min_len``), the threshold halves until it holds or reaches
    1 (the lattice is then complete and fewer than k exist).  Correctness:
    once >= k itemsets clear rung ``s``, the k-th best support is >= s, so
    nothing below the rung can displace the answer.

    ``config`` is an :class:`~repro_torch.core.eclat.EclatConfig` template
    whose ``min_sup``/``mode`` are overridden per rung — variant, backend
    and ``mesh`` plumb through unchanged, so top-k runs on any engine
    backend.  ``device``, ``min_len`` and ``mesh`` are keyword-only: the
    reference's fifth parameter is ``mesh``, so a positional call written
    for it fails here instead of passing its mesh as the device.
    """
    from . import bitmap as bm             # late: postfilter <- eclat cycle
    from .eclat import EclatConfig, mine

    if k < 1:
        raise ValueError(f"top-k needs k >= 1, got {k}")
    if min_len < 1:
        raise ValueError(f"min_len must be >= 1, got {min_len}")
    n_txn = len(transactions)
    template = config if config is not None else EclatConfig(min_sup=1)

    sup1 = bm.support_np(bm.pack_transactions(transactions, n_items))
    present = sup1[sup1 > 0]
    if present.size >= k:
        # k-th largest singleton support: >= k singleton itemsets clear it
        abs_ms = int(sorted(present.tolist(), reverse=True)[k - 1])
    else:
        # fewer than k items ever occur; only deeper combinations (or
        # nothing) can fill the answer — enumerate the complete lattice
        abs_ms = 1
    abs_ms = max(1, abs_ms)
    ladder: List[dict] = []
    while True:
        cfg = dataclasses.replace(template, min_sup=int(abs_ms), mode="all")
        res = mine(transactions, n_items, cfg, device=device, mesh=mesh)
        found = [(s, v) for s, v in res.support_map().items()
                 if len(s) >= min_len]
        ladder.append({"abs_min_sup": int(abs_ms), "n_found": len(found)})
        if len(found) >= k or abs_ms <= 1:
            break
        abs_ms = max(1, abs_ms // 2)

    ordered = sorted(found, key=topk_sort_key)[:k]
    return TopKResult(
        itemsets=ordered, k=k, abs_min_sup=int(abs_ms), ladder=ladder,
        stats={"rungs": len(ladder), "backend": res.stats.get("backend"),
               "variant": res.stats.get("variant"),
               "n_found_final": len(found)},
    )
