"""Synchronous query service over the sliding-window miner.

``StreamQueryService`` answers one call at a time (ingest / top_k_itemsets /
support / rules / answer_batch) from the pieces the batched admission front
end (``admission.ServingFrontend``) also uses: immutable
:class:`~repro_torch.serving.snapshot.WindowSnapshot` publication, the
version-keyed :class:`~repro_torch.serving.cache.VersionedCache`, and the
shared answer kernels — so an answer at a given ``window_version`` is the
same whichever front end computed it (DESIGN.md §11).

Heterogeneous query batches are packed onto answer slots with the same
greedy-LPT partitioner that packs equivalence classes onto executors and
prompts onto decode batches (DESIGN.md §4/§5 — the paper's balance
objective reused at the product surface).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.partitioners import pack_items
from ..streaming import StreamingMiner, WindowResult
from .cache import VersionedCache
from .snapshot import (WindowSnapshot, answer_query, answer_rules,
                       answer_support, answer_topk)

__all__ = ["ItemsetQuery", "StreamQueryService", "pack_queries", "query_work"]


@dataclasses.dataclass
class ItemsetQuery:
    """One reader request against the current window.

    kind:     "topk" (k most supported itemsets of length >= min_len) or
              "rules" (k most confident rules at min_conf).
    """

    qid: int
    kind: str = "topk"
    k: int = 10
    min_len: int = 1
    min_conf: float = 0.8


def query_work(query: ItemsetQuery, n_itemsets: int) -> float:
    """Estimated store-scan work of one query, in entry-visit units.

    The estimate folds in the query's own parameters, not just its kind
    (the regression: a ``k=1`` probe and a ``k=10_000`` scan were costed
    identically, so the greedy packer balanced the wrong quantity):

    * topk — one full store scan (the ``min_len`` filter touches every
      entry) plus top-k selection/copy work proportional to the ``k``
      entries actually ranked and returned;
    * rules — antecedent enumeration over the store dominates (~4x a scan),
      and a *looser* ``min_conf`` keeps more candidate rules alive through
      confidence ranking, so cost grows as ``min_conf`` drops; the ``k``
      term prices the returned slice.
    """
    n = max(int(n_itemsets), 1)
    k = n if query.k is None else min(int(query.k), n)
    if query.kind == "rules":
        return 4.0 * n * (2.0 - float(query.min_conf)) + 8.0 * k
    return float(n) + 8.0 * k


def pack_queries(queries: Sequence[ItemsetQuery], n_batches: int,
                 n_itemsets: int):
    """Greedy-LPT pack queries into ``n_batches`` answer slots, balancing
    the per-query :func:`query_work` estimate.  Returns (assignment,
    stats)."""
    work = np.array([query_work(q, n_itemsets) for q in queries], np.float64)
    return pack_items(work, n_batches)


class StreamQueryService:
    def __init__(self, miner: StreamingMiner):
        self.miner = miner
        self.result: Optional[WindowResult] = None
        self.cache = VersionedCache()
        self._snapshot = WindowSnapshot.empty(version=miner.window_version)
        self.n_slides = 0

    # -- writer side ---------------------------------------------------------

    def ingest(self, batch: Sequence[Sequence[int]]) -> WindowResult:
        """Advance the window one micro-batch and publish a new snapshot."""
        result = self.miner.advance(batch)
        self.publish(result)
        return result

    def publish(self, result: WindowResult) -> WindowSnapshot:
        """Swap in an immutable snapshot of ``result`` (one atomic reference
        assignment — readers see the old window or the new one, never a
        torn mixture) and invalidate exactly the out-of-version cache
        entries."""
        snap = WindowSnapshot.from_result(result)
        self._snapshot = snap
        self.result = result
        self.cache.advance(snap.version)
        self.n_slides += 1
        return snap

    # -- reader side ---------------------------------------------------------

    @property
    def snapshot(self) -> WindowSnapshot:
        """The current published window view (immutable, version-stamped)."""
        return self._snapshot

    @property
    def window_version(self) -> int:
        return self._snapshot.version

    def top_k_itemsets(self, k: int = 10, min_len: int = 1):
        """k most supported frequent itemsets (ties: longer, then lex)."""
        return answer_topk(self._snapshot, k, min_len, cache=self.cache)

    def support(self, itemset: Sequence[int]) -> int:
        """Support of one itemset over the live window (0 if infrequent)."""
        return answer_support(self._snapshot, itemset)

    def rules(self, min_conf: float = 0.8, k: Optional[int] = None):
        """Most confident association rules over the live window."""
        return answer_rules(self._snapshot, min_conf, k, cache=self.cache)

    def answer_batch(self, queries: Sequence[ItemsetQuery], n_batches: int = 4):
        """Answer a heterogeneous query batch, greedy-LPT packed.

        The packing is executed, not just reported: queries are answered
        slot-by-slot in the packed assignment against one snapshot grabbed
        up front.  Returns ``(answers by qid, packing stats)`` — the stats
        carry the partitioner's ``padding_efficiency`` plus
        ``queries_per_slot``, the per-answer-slot query counts of the
        assignment that actually ran.
        """
        snap = self._snapshot
        assign, stats = pack_queries(queries, n_batches,
                                     max(len(snap.itemsets), 1))
        answers: Dict[int, list] = {}
        queries_per_slot: List[int] = []
        for slot in range(int(n_batches)):
            members = np.nonzero(assign == slot)[0]
            queries_per_slot.append(int(members.size))
            for qi in members:
                q = queries[int(qi)]
                answers[q.qid], _ = answer_query(snap, q, cache=self.cache)
        stats["queries_per_slot"] = queries_per_slot
        stats["window_version"] = snap.version
        return answers, stats
