"""Spark-accumulator analogue (EclatV3's vertical-DB build).

Spark accumulators are add-only shared variables merged associatively on the
driver.  Here each shard owns a contiguous block of transaction ids and
scatters its own bits into a zero-initialised packed matrix.  Without a mesh
the partials are OR-merged through a :class:`HostAccumulator` in one
process; on a mesh, rank ``i`` of the merge axis builds the partial of chunk
``i`` and one all-reduce (sum) over that axis merges them.  The partials
are bit-disjoint, so OR and add agree, and the int32 words the port carries
add without a carry.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..device import DeviceLike, words_from_numpy, words_to_numpy
from ..dist import collectives as coll
from ..dist.sharding import axis_index, axis_size
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
    axis: str = "data",
    device: DeviceLike = None,
) -> VerticalDB:
    """EclatV3 Phase-3: accumulator-built vertical DB.

    Host mode (``mesh=None``): the transactions are cut into ``n_shards``
    chunks whose partial bitmaps are OR-merged through a
    :class:`HostAccumulator`.  Mesh mode (a ``DeviceMesh``): the chunks
    follow the ranks of ``axis`` (the reference's ``np.linspace`` bounds
    over its size), each rank builds its own chunk's partial, and one
    all-reduce over ``axis`` on ``device`` merges them; every rank returns
    the same DB.
    """
    n_txn = len(transactions)
    w = bm.n_words(n_txn)
    if mesh is not None:
        if not hasattr(mesh, "get_group"):
            raise TypeError(f"mesh must be a torch DeviceMesh, got "
                            f"{type(mesh).__name__}")
        d, i = axis_size(mesh, axis), axis_index(mesh, axis)
        bounds = np.linspace(0, n_txn, d + 1).astype(int)
        part = words_from_numpy(
            _partial_bitmap(transactions[bounds[i]: bounds[i + 1]],
                            int(bounds[i]), n_items, w), device)
        packed = words_to_numpy(coll.all_reduce(part, mesh, axis))
    else:
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
