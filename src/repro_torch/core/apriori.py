"""Spark-Apriori (YAFIM-like) baseline, in the same substrate: the
reference package's ``core/apriori.py`` on PyTorch.

The paper compares RDD-Eclat against a YAFIM-style Spark Apriori.  To keep
the comparison meaningful, this baseline keeps Apriori's defining costs:

  * level-wise candidate generation with subset pruning (on the host,
    where YAFIM builds its hash tree), and
  * support counting by re-scanning the *horizontal* database every level —
    a (n_txn x n_items) @ (n_items x n_cands) containment product on the
    device, the dense analogue of "each transaction probes the broadcast
    hash tree".

No tidset memoization crosses levels — that is exactly the advantage Eclat
keeps for itself.  The reference computes the product with a jnp ``@``
outside any Pallas kernel, so here it is ``torch.matmul``: no kernel of
this package lies on this path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import bitmap as bm
from .eclat import resolve_min_sup

__all__ = ["AprioriResult", "apriori_mine"]


@dataclasses.dataclass
class AprioriResult:
    support_map: Dict[Tuple[int, ...], int]
    counts: List[int]
    stats: dict

    @property
    def total(self) -> int:
        return sum(self.counts)


def _containment_counts(txn: torch.Tensor, chunk: np.ndarray, k: int) -> np.ndarray:
    """counts[c] = #transactions containing all k items of candidate c.

    txn:   (n_txn, n1) float32 0/1 on the device
    chunk: (Q, k) int64 column indices of the candidates, on the host

    The (Q, n1) 0/1 mask is scattered on the device; ``hits = txn @ mask.T``
    is the full-database rescan.  float32 keeps the counts exact under any
    matmul precision: every input is 0 or 1 (exact in TF32 and bf16 too),
    every product 0 or 1, and every sum at most n1 < 2^24.  One host read
    of the (Q,) counts."""
    idx = torch.from_numpy(chunk).to(txn.device)
    mask = torch.zeros((chunk.shape[0], txn.shape[1]), dtype=torch.float32,
                       device=txn.device)
    mask.scatter_(1, idx, 1.0)
    hits = txn @ mask.T                     # (n_txn, Q)
    return (hits >= float(k)).sum(dim=0, dtype=torch.int64).cpu().numpy()


def _gen_candidates(prev: List[Tuple[int, ...]], prev_set: set, k: int) -> List[Tuple[int, ...]]:
    """F(k-1) x F(k-1) join on a common (k-2)-prefix + subset pruning."""
    cands: List[Tuple[int, ...]] = []
    n = len(prev)
    i = 0
    while i < n:
        j = i + 1
        while j < n and prev[i][:-1] == prev[j][:-1]:
            cand = prev[i] + (prev[j][-1],)
            # prune: all (k-1)-subsets frequent
            ok = all(
                cand[:m] + cand[m + 1:] in prev_set for m in range(k)
            )
            if ok:
                cands.append(cand)
            j += 1
        i += 1
    return cands


def apriori_mine(
    transactions: Sequence[Sequence[int]],
    n_items: int,
    min_sup: float,
    max_k: int | None = None,
    cand_chunk: int = 8192,
    *,
    device: DeviceLike = None,
) -> AprioriResult:
    """All frequent itemsets by level-wise Apriori, the support counting on
    ``device`` (``None`` = CUDA; with no card that raises unless
    ``device="cpu"`` is passed).  The same boundaries, errors, results and
    ``stats`` keys as the reference's ``apriori_mine``, plus
    ``stats["device"]``, where the horizontal database lives."""
    t_start = time.perf_counter()
    # the same boundaries as Eclat's mine(): max_k >= 1 or None
    if max_k is not None and max_k < 1:
        raise ValueError(f"max_k must be >= 1 (or None for unbounded), "
                         f"got {max_k}")
    if cand_chunk < 1:
        raise ValueError(f"cand_chunk must be >= 1, got {cand_chunk}")
    dev = resolve_device(device)
    n_txn = len(transactions)
    # same type-based fraction/count disambiguation as Eclat
    abs_min_sup = resolve_min_sup(min_sup, n_txn)

    # Phase 1 (YAFIM): frequent items — single pass
    packed = bm.pack_transactions(transactions, n_items)
    sup1 = bm.support_np(packed)
    freq = np.nonzero(sup1 >= abs_min_sup)[0]
    item_of_col = freq.astype(np.int64)
    n1 = freq.shape[0]

    support_map: Dict[Tuple[int, ...], int] = {
        (int(it),): int(sup1[it]) for it in freq
    }
    counts = [n1]
    stats = {"abs_min_sup": abs_min_sup, "n_freq_items": n1, "level_s": [],
             "device": str(dev)}
    if n1 < 2:
        stats["total_s"] = time.perf_counter() - t_start
        return AprioriResult(support_map, counts, stats)

    # horizontal DB over frequent columns only (YAFIM keeps the RDD cached),
    # uploaded once
    dense = bm.unpack_bitmap(packed[freq], n_txn)       # (n1, n_txn)
    txn = torch.from_numpy(np.ascontiguousarray(dense.T, dtype=np.float32)).to(dev)

    frequent_prev: List[Tuple[int, ...]] = sorted((int(c),) for c in range(n1))
    k = 1
    kmax = n1 if max_k is None else max_k
    while frequent_prev and k < kmax:
        k += 1
        t0 = time.perf_counter()
        prev_set = set(frequent_prev)
        cands = _gen_candidates(frequent_prev, prev_set, k)
        if not cands:
            break
        survivors: List[Tuple[int, ...]] = []
        for s in range(0, len(cands), cand_chunk):
            chunk = cands[s: s + cand_chunk]
            cnt = _containment_counts(txn, np.asarray(chunk, np.int64), k)
            for r, cand in enumerate(chunk):
                if cnt[r] >= abs_min_sup:
                    survivors.append(cand)
                    support_map[tuple(sorted(int(item_of_col[c]) for c in cand))] = int(cnt[r])
        stats["level_s"].append(time.perf_counter() - t0)
        counts.append(len(survivors))
        if not survivors:
            counts.pop()
            break
        frequent_prev = sorted(survivors)

    stats["total_s"] = time.perf_counter() - t_start
    return AprioriResult(support_map, counts, stats)
