"""Spark-accumulator analogue (EclatV3's vertical-DB build), single process.

Spark accumulators are add-only shared variables merged associatively on the
driver.  Here each shard owns a contiguous block of transaction ids, scatters
its own bits into a zero-initialised packed matrix, and the partials are
OR-merged through a :class:`HostAccumulator` (the partials are bit-disjoint,
so OR and add agree).  The mesh variant, which merges the partials with a
collective across devices, belongs to the multi-GPU backends and is not part
of this package yet: asking for it raises.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from . import bitmap as bm
from .vertical import VerticalDB, sort_items

__all__ = ["HostAccumulator", "build_vertical_accumulated"]


class HostAccumulator:
    """Add-only accumulator with an associative merge, driver-readable only
    (mirrors the Spark contract: workers add, driver reads)."""

    def __init__(self, zero, merge):
        self._value = zero
        self._merge = merge
        self._adds = 0

    def add(self, partial) -> None:
        self._value = self._merge(self._value, partial)
        self._adds += 1

    def value(self):
        return self._value

    @property
    def n_adds(self) -> int:
        return self._adds


def _partial_bitmap(chunk: Sequence[Sequence[int]], tid_offset: int,
                    n_items: int, w: int) -> np.ndarray:
    packed = np.zeros((n_items, w), dtype=np.uint32)
    bm.scatter_transactions(packed, chunk, tid_offset)
    return packed


def build_vertical_accumulated(
    transactions: Sequence[Sequence[int]],
    n_items: int,
    min_sup: int,
    order: str = "support_asc",
    n_shards: int = 4,
    mesh=None,
) -> VerticalDB:
    """EclatV3 Phase-3: accumulator-built vertical DB.

    The transactions are cut into ``n_shards`` chunks whose partial bitmaps
    are OR-merged through a :class:`HostAccumulator`.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the mesh accumulator (a cross-device merge of the partial "
            "bitmaps) belongs to the multi-GPU backends, which are not "
            "ported yet")
    n_txn = len(transactions)
    w = bm.n_words(n_txn)
    n_shards = max(1, min(n_shards, max(n_txn, 1)))
    bounds = np.linspace(0, n_txn, n_shards + 1).astype(int)
    acc = HostAccumulator(
        zero=np.zeros((n_items, w), dtype=np.uint32), merge=np.bitwise_or)
    for i in range(n_shards):
        acc.add(_partial_bitmap(transactions[bounds[i]: bounds[i + 1]],
                                int(bounds[i]), n_items, w))
    packed = acc.value()

    supports = bm.support_np(packed)
    freq_mask = supports >= int(min_sup)
    items = np.nonzero(freq_mask)[0].astype(np.int64)
    packed = packed[freq_mask]
    supports = supports[freq_mask]
    perm = sort_items(items, supports, order)
    return VerticalDB(
        bitmaps=packed[perm], items=items[perm], supports=supports[perm],
        n_txn=n_txn, order=order,
    )
