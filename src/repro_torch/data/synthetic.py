"""Transaction-database generators reproducing the paper's Table-2 datasets.

A numpy copy of the reference package's generators: the same seed draws
the same transactions in both packages, so their results can be compared
itemset for itemset.

The paper evaluates on seven benchmarks (SPMF / FIMI repositories).  Those
files are not available offline, so this module generates databases with the
same *statistical shape* — transaction count, item universe, average width,
and density family — via:

  * :func:`quest` — the IBM Quest synthetic generator (Agrawal & Srikant,
    VLDB'94 §4.1): the exact process behind T10I4D100K / T40I10D100K /
    c20d10k.
  * :func:`attribute_table` — dense attribute-value data (chess, mushroom):
    each transaction picks one value per attribute, giving fixed width and
    small, heavily reused item universe.
  * :func:`clickstream` — sparse Zipf-distributed click data (BMS-WebView-1/2).

All generators are deterministic in (name, seed, scale).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

__all__ = ["quest", "attribute_table", "clickstream", "DatasetSpec",
           "PAPER_DATASETS", "generate", "materialize"]


def quest(
    n_txn: int,
    n_items: int,
    avg_txn_len: float,
    avg_pattern_len: float,
    n_patterns: int = 0,
    corruption: float = 0.5,
    seed: int = 0,
) -> List[List[int]]:
    """IBM Quest-style generator (T<avg_txn_len>I<avg_pattern_len>D<n_txn>)."""
    rng = np.random.default_rng(seed)
    n_patterns = n_patterns or max(n_items // 10, 10)

    # maximal potentially-frequent itemsets
    sizes = np.maximum(1, rng.poisson(avg_pattern_len, n_patterns))
    patterns: List[np.ndarray] = []
    prev = rng.choice(n_items, size=int(sizes[0]), replace=False)
    patterns.append(prev)
    for s in sizes[1:]:
        s = int(min(s, n_items))
        n_shared = min(int(round(rng.exponential(0.5) * s)), s, prev.shape[0])
        shared = rng.choice(prev, size=n_shared, replace=False) if n_shared else np.empty(0, np.int64)
        fresh = rng.choice(n_items, size=s - n_shared, replace=False)
        pat = np.unique(np.concatenate([shared, fresh]).astype(np.int64))
        patterns.append(pat)
        prev = pat
    weights = rng.exponential(1.0, n_patterns)
    weights /= weights.sum()

    txns: List[List[int]] = []
    for _ in range(n_txn):
        target = max(1, int(rng.poisson(avg_txn_len)))
        txn: set = set()
        guard = 0
        while len(txn) < target and guard < 40:
            guard += 1
            pat = patterns[rng.choice(n_patterns, p=weights)]
            keep = rng.random(pat.shape[0]) >= corruption * rng.random()
            picked = pat[keep]
            for it in picked:
                if len(txn) >= target:
                    break
                txn.add(int(it))
        if not txn:
            txn.add(int(rng.integers(n_items)))
        txns.append(sorted(txn))
    return txns


def attribute_table(
    n_txn: int,
    n_attributes: int,
    n_items: int,
    skew: float = 1.2,
    seed: int = 0,
) -> List[List[int]]:
    """Dense attribute-value data (chess/mushroom family): each txn = one item per
    attribute; per-attribute value domains partition the item universe and
    values are drawn with a skewed (Zipf-ish) distribution so correlations and
    long frequent itemsets appear — the paper's "dense real-life" regime."""
    rng = np.random.default_rng(seed)
    # partition items into per-attribute domains (sizes >= 2 where possible)
    bounds = np.linspace(0, n_items, n_attributes + 1).astype(int)
    txns = np.zeros((n_txn, n_attributes), dtype=np.int64)
    for a in range(n_attributes):
        lo, hi = int(bounds[a]), int(bounds[a + 1])
        dom = max(hi - lo, 1)
        pvals = 1.0 / np.arange(1, dom + 1) ** skew
        pvals /= pvals.sum()
        txns[:, a] = lo + rng.choice(dom, size=n_txn, p=pvals)
    return [sorted(set(row.tolist())) for row in txns]


def clickstream(
    n_txn: int,
    n_items: int,
    avg_txn_len: float,
    zipf_a: float = 1.6,
    seed: int = 0,
) -> List[List[int]]:
    """Sparse clickstream data (BMS-WebView family): Zipf item popularity,
    short Poisson session lengths."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = ranks ** (-zipf_a)
    p /= p.sum()
    perm = rng.permutation(n_items)
    txns: List[List[int]] = []
    for _ in range(n_txn):
        size = max(1, int(rng.poisson(avg_txn_len)))
        picks = rng.choice(n_items, size=min(size, n_items), replace=False, p=p)
        txns.append(sorted(set(int(perm[i]) for i in picks)))
    return txns


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Paper Table-2 row + generator binding."""

    name: str
    kind: str                  # quest | attribute | clickstream
    n_txn: int
    n_items: int
    avg_width: float
    params: dict
    # paper's per-dataset experiment knobs:
    min_sups: tuple            # the varying min_sup sweep (Figs 8-14)
    tri_matrix: bool           # paper: False for BMS1/BMS2


PAPER_DATASETS = {
    "c20d10k": DatasetSpec("c20d10k", "quest", 10_000, 192, 20,
                           dict(avg_pattern_len=6, n_patterns=40),
                           min_sups=(0.5, 0.4, 0.3, 0.2, 0.1), tri_matrix=True),
    "chess": DatasetSpec("chess", "attribute", 3_196, 75, 37,
                         dict(n_attributes=37, skew=3.5),
                         min_sups=(0.9, 0.85, 0.8, 0.75, 0.7), tri_matrix=True),
    "mushroom": DatasetSpec("mushroom", "attribute", 8_124, 119, 23,
                            dict(n_attributes=23, skew=2.2),
                            min_sups=(0.4, 0.35, 0.3, 0.25, 0.2), tri_matrix=True),
    "BMS_WebView_1": DatasetSpec("BMS_WebView_1", "clickstream", 59_602, 497, 2.5,
                                 dict(zipf_a=1.35),
                                 min_sups=(0.005, 0.004, 0.003, 0.002, 0.001), tri_matrix=False),
    "BMS_WebView_2": DatasetSpec("BMS_WebView_2", "clickstream", 77_512, 3_340, 5,
                                 dict(zipf_a=1.35),
                                 min_sups=(0.005, 0.004, 0.003, 0.002, 0.001), tri_matrix=False),
    "T10I4D100K": DatasetSpec("T10I4D100K", "quest", 100_000, 870, 10,
                              dict(avg_pattern_len=4, n_patterns=100),
                              min_sups=(0.05, 0.04, 0.03, 0.02, 0.01), tri_matrix=True),
    "T40I10D100K": DatasetSpec("T40I10D100K", "quest", 100_000, 1_000, 40,
                               dict(avg_pattern_len=10, n_patterns=100),
                               min_sups=(0.05, 0.04, 0.03, 0.02, 0.01), tri_matrix=True),
}


def materialize(spec: DatasetSpec, n_txn: int, seed: int = 0) -> List[List[int]]:
    """Draw exactly ``n_txn`` transactions from a spec's generator family
    (shared by :func:`generate` and the streaming micro-batch source,
    the streaming source)."""
    if spec.kind == "quest":
        txns = quest(n_txn, spec.n_items, spec.avg_width,
                     spec.params["avg_pattern_len"],
                     n_patterns=spec.params.get("n_patterns", 0), seed=seed)
    elif spec.kind == "attribute":
        txns = attribute_table(n_txn, spec.params["n_attributes"], spec.n_items,
                               skew=spec.params.get("skew", 1.2), seed=seed)
    elif spec.kind == "clickstream":
        txns = clickstream(n_txn, spec.n_items, spec.avg_width,
                           zipf_a=spec.params.get("zipf_a", 1.6), seed=seed)
    else:
        raise ValueError(spec.kind)
    return txns


def generate(name: str, scale: float = 1.0, seed: int = 0) -> tuple[List[List[int]], DatasetSpec]:
    """Materialize a paper dataset (``scale`` shrinks n_txn for CPU budgets;
    the Fig-16 scalability benchmark uses scale > 1)."""
    spec = PAPER_DATASETS[name]
    n_txn = max(16, int(round(spec.n_txn * scale)))
    return materialize(spec, n_txn, seed=seed), spec
