"""Lineage-based fault tolerance for mining jobs.

Spark recovers a lost RDD partition by replaying its lineage.  Here the
lineage of partition ``pid`` is explicit and tiny: the immutable frequent-item
vertical bitmap + the class->partition table.  ``recover_partition`` replays
exactly the classes owned by ``pid`` and reproduces its subtree bit for bit.
``save/load_mining_checkpoint`` provide the HDFS-persistence analogue: a
restartable snapshot of (found levels, current frontier), written
atomically.  The ``mining_ckpt_k*.npz`` files are the reference package's,
key for key (the frontier words as ``uint32``), so either package resumes
the other's.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device, words_from_numpy
from .equivalence import class_segments, segment_pairs
from .itemsets import ItemsetStore, LevelRecord
from .vertical import VerticalDB

__all__ = [
    "recover_partition",
    "save_mining_checkpoint",
    "load_mining_checkpoint",
    "latest_mining_checkpoint",
    "mining_checkpoint_path",
]


def recover_partition(
    db: VerticalDB,
    table: np.ndarray,
    pid: int,
    abs_min_sup: int,
    max_k: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[Tuple[int, ...], int]:
    """Recompute every frequent itemset owned by partition ``pid``.

    Deterministic replay from lineage inputs only — no state from the failed
    worker is needed.  Returns {itemset: support} for itemsets of length >= 2
    whose 1-length prefix class is assigned to ``pid``.  The replay runs
    through the engine the device gives: ``fused`` (the kernels) on the
    card, ``ref`` on the host (``device="cpu"``).
    """
    from .engine import MODE_TIDSET, make_engine  # replay via the engine interface

    dev = resolve_device(device)
    n1 = db.n_items
    owned = np.nonzero(np.asarray(table) == pid)[0]
    out: Dict[Tuple[int, ...], int] = {}
    bitmaps = words_from_numpy(db.bitmaps, dev)
    execu = make_engine("fused" if dev.type == "cuda" else "ref", bucket_min=64)
    for rank in owned.tolist():
        # class [rank]: members rank+1..n1-1
        members = np.arange(rank + 1, n1, dtype=np.int32)
        if members.size == 0:
            continue
        left = np.full(members.shape, rank, np.int32)
        res = execu.expand(bitmaps, left, members,
                           np.zeros(members.shape[0], np.int32),
                           mode=MODE_TIDSET, min_sup=abs_min_sup)
        keep = res.mask
        frontier_bm = res.bitmaps
        frontier_items: List[Tuple[int, ...]] = [
            (int(db.items[rank]), int(db.items[j])) for j in members[keep]
        ]
        frontier_rank = members[keep]
        for iset, s in zip(frontier_items, res.supports):
            out[tuple(sorted(iset))] = int(s)
        k = 2
        class_id = np.zeros(len(frontier_items), np.int64)
        while len(frontier_items) and (max_k is None or k < max_k):
            starts, sizes = class_segments(class_id)
            l, r = segment_pairs(starts, sizes)
            if l.size == 0:
                break
            res = execu.expand(frontier_bm, l.astype(np.int32), r.astype(np.int32),
                               np.zeros(l.shape[0], np.int32),
                               mode=MODE_TIDSET, min_sup=abs_min_sup)
            k += 1
            if not res.mask.any():
                break
            sel = np.nonzero(res.mask)[0]
            new_items = [frontier_items[l[i]] + (int(db.items[frontier_rank[r[i]]]),)
                         for i in sel]
            frontier_bm = res.bitmaps
            frontier_rank = frontier_rank[r[sel]]
            class_id = l[sel]
            frontier_items = new_items
            for iset, s in zip(frontier_items, res.supports):
                out[tuple(sorted(iset))] = int(s)
    return out


def mining_checkpoint_path(directory: str, k: int) -> str:
    return os.path.join(directory, f"mining_ckpt_k{int(k)}.npz")


def save_mining_checkpoint(
    directory: str,
    store: ItemsetStore,
    k: int,
    class_id: np.ndarray,
    item_rank: np.ndarray,
    partition: np.ndarray,
    support: np.ndarray,
    bitmaps: np.ndarray,
    meta: Optional[dict] = None,
) -> str:
    """Atomic snapshot: levels found so far + live frontier at level ``k``
    (``bitmaps``: the frontier's ``(S, W)`` ``uint32`` words, host side).

    ``meta`` (JSON-able) records what a blind resume needs — the resolved
    ``abs_min_sup``, engine mode, ``max_k`` and partition count — so
    :func:`repro_torch.core.eclat.resume_mine` can continue the run without
    the original transactions (DESIGN.md §10)."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "k": np.asarray(k),
        "class_id": class_id,
        "item_rank": item_rank,
        "partition": partition,
        "support": support,
        "bitmaps": np.asarray(bitmaps, np.uint32),
        "item_ids": store._item_ids,
        "n_levels": np.asarray(len(store.levels)),
        "meta": np.asarray(json.dumps(meta or {})),
    }
    for i, lvl in enumerate(store.levels):
        payload[f"lvl{i}_parent"] = lvl.parent
        payload[f"lvl{i}_item_rank"] = lvl.item_rank
        payload[f"lvl{i}_support"] = lvl.support
        payload[f"lvl{i}_partition"] = lvl.partition
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    final = mining_checkpoint_path(directory, k)
    os.replace(tmp, final)
    return final


def load_mining_checkpoint(path: str):
    """Restore (store, frontier dict) from a snapshot; the frontier's
    ``bitmaps`` are host ``uint32`` words."""
    z = np.load(path)
    store = ItemsetStore(z["item_ids"])
    for i in range(int(z["n_levels"])):
        store.add_level(
            LevelRecord(
                k=i + 1,
                parent=z[f"lvl{i}_parent"],
                item_rank=z[f"lvl{i}_item_rank"],
                support=z[f"lvl{i}_support"],
                partition=z[f"lvl{i}_partition"],
            )
        )
    frontier = dict(
        k=int(z["k"]),
        class_id=z["class_id"],
        item_rank=z["item_rank"],
        partition=z["partition"],
        support=z["support"],
        bitmaps=z["bitmaps"],
        meta=(json.loads(str(z["meta"])) if "meta" in z.files else {}),
    )
    return store, frontier


def latest_mining_checkpoint(directory: str) -> str:
    """The deepest ``mining_ckpt_k*.npz`` in ``directory`` (the per-level
    checkpoints are cumulative: the deepest one carries every found level
    plus the live frontier)."""
    best, best_k = None, -1
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = re.fullmatch(r"mining_ckpt_k(\d+)\.npz", name)
            if m and int(m.group(1)) > best_k:
                best_k = int(m.group(1))
                best = os.path.join(directory, name)
    if best is None:
        raise FileNotFoundError(
            f"no mining checkpoint (mining_ckpt_k*.npz) under {directory!r}")
    return best
