"""RDD-Eclat on PyTorch: the paper's five variants (plus a beyond-paper sixth),
single device.

Execution model (DESIGN.md §2-3): the host process plays the Spark driver —
it owns data-dependent control flow (class segmentation, survivor
bookkeeping) — while the card executes the tidset-intersection hot loop
behind the ``core.engine`` backend interface.  Equivalence classes are
assigned to partitions once, from their 1-length prefix, and descendants
never migrate.

Variants:
  v1  vertical build via scatter, no filtering, default partitioner
  v2  + filtered transactions (bitmap column compaction)
  v3  + accumulator-built vertical DB
  v4  v3 + hash partitioner (p user-set)
  v5  v3 + reverse-hash partitioner
  v6  (beyond paper) v3 + greedy-LPT partitioner, optional dEclat diffsets

Not ported yet, and refused with ``NotImplementedError`` when asked for:
the mesh backends and ``shard``, ``backend="auto"``, ``autotune`` and
``block_w``, per-level checkpoints and ``resume_mine``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, words_from_numpy
from . import engine as eng
from .accumulator import build_vertical_accumulated
from .equivalence import class_segments, pair_work, segment_pairs
from .itemsets import ItemsetStore, LevelRecord
from .partitioners import assign_partitions, partition_stats
from .postfilter import WORKLOAD_MODES, filter_mode
from .triangular import cooccurrence_counts, frequent_pairs
from .vertical import VerticalDB, build_vertical, filter_transactions, filtering_reduction

__all__ = ["EclatConfig", "EclatResult", "mine", "resolve_min_sup",
           "run_bottom_up", "VARIANTS"]

VARIANTS: Dict[str, dict] = {
    "v1": dict(filter_txns=False, accumulator=False, partitioner="default"),
    "v2": dict(filter_txns=True, accumulator=False, partitioner="default"),
    "v3": dict(filter_txns=True, accumulator=True, partitioner="default"),
    "v4": dict(filter_txns=True, accumulator=True, partitioner="hash"),
    "v5": dict(filter_txns=True, accumulator=True, partitioner="reverse_hash"),
    "v6": dict(filter_txns=True, accumulator=True, partitioner="greedy"),
}


def resolve_min_sup(min_sup, n_txn: int) -> int:
    """Support threshold -> absolute count, disambiguated by *type*:

    - a float in (0, 1] is a support **fraction** of ``n_txn`` (so
      ``min_sup=1.0`` means "appears in every transaction", resolving to
      ``n_txn``);
    - an int >= 1 (or an integral float > 1) is an absolute **count**.

    Anything else (zero, negatives, bools) is rejected.
    """
    if isinstance(min_sup, (bool, np.bool_)):
        raise TypeError(f"min_sup must be a number, got bool {min_sup!r}")
    if isinstance(min_sup, (int, np.integer)):
        if min_sup < 1:
            raise ValueError(f"integer min_sup is an absolute count and must "
                             f"be >= 1, got {int(min_sup)}")
        return int(min_sup)
    f = float(min_sup)
    if 0.0 < f <= 1.0:
        return max(1, int(math.ceil(f * n_txn)))
    if f > 1.0:
        if not f.is_integer():
            raise ValueError(
                f"float min_sup > 1 is an absolute count and must be "
                f"integral (truncating {min_sup!r} would lower the "
                f"threshold); pass an int or a fraction in (0, 1]")
        return int(f)
    raise ValueError(f"min_sup must be a fraction in (0, 1] or an absolute "
                     f"count >= 1, got {min_sup!r}")


@dataclasses.dataclass
class EclatConfig:
    min_sup: float                      # float in (0,1] = fraction; int >= 1 = count
    variant: str = "v4"
    p: int = 10                         # partitions for v4/v5/v6 (paper: p=10)
    tri_matrix: Optional[bool] = None   # None = auto (paper's triMatrixMode)
    tri_matrix_max_items: int = 4096    # auto threshold (paper: item-id range)
    use_diffsets: bool = False          # v6 only (dEclat); other variants reject it
    backend: str = "fused"              # fused (CUDA kernels) | ref (plain torch)
    mode: str = "all"                   # workload: all | closed | maximal (DESIGN.md §9)
    max_k: Optional[int] = None         # deepest itemset length to mine (>= 1); None = unbounded
    bucket_min: int = 128               # pair-buffer ladder floor
    chunk_pairs: int = 1 << 18          # level-2 chunking when tri-matrix off
    # not ported yet: any value but these defaults raises NotImplementedError
    shard: str = "pairs"
    block_w: Optional[int] = None
    autotune: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every_level: bool = False

    def resolve_min_sup(self, n_txn: int) -> int:
        return resolve_min_sup(self.min_sup, n_txn)


_UNPORTED_DEFAULTS = dict(shard="pairs", block_w=None, autotune=False,
                          checkpoint_dir=None, checkpoint_every_level=False)


@dataclasses.dataclass
class EclatResult:
    store: ItemsetStore
    db: VerticalDB
    stats: dict
    mode: str = "all"                   # the workload mode this run mined for

    @property
    def counts(self) -> List[int]:
        return self.store.counts

    @property
    def total(self) -> int:
        return self.store.total

    def itemsets(self):
        return self.store.itemsets()

    def support_map(self):
        """The full frequent map (every mode mines the whole lattice —
        closed/maximal are post-filters over it, see :meth:`workload_map`)."""
        return self.store.support_map()

    def workload_map(self):
        """The mode-filtered map this run was configured for (DESIGN.md §9)."""
        return filter_mode(self.store.support_map(), self.mode)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_bottom_up(
    execu: eng.Engine,
    store: ItemsetStore,
    lvl_bitmaps: torch.Tensor,
    class_id: np.ndarray,
    item_rank: np.ndarray,
    partition: np.ndarray,
    support: np.ndarray,
    *,
    abs_min_sup: int,
    mode: int,
    max_k: int,
) -> None:
    """Levels >= 3: per-class level-wise expansion (the paper's Phase-4).

    Starts from a level-2 frontier (``class_id``/``item_rank``/``partition``/
    ``support`` row-aligned with ``lvl_bitmaps``) and appends one
    ``LevelRecord`` per surviving level.
    """
    k = 2
    while support.shape[0] and k < max_k:
        starts, sizes = class_segments(class_id)
        left, right = segment_pairs(starts, sizes)
        if left.size == 0:
            break
        res = execu.expand(
            lvl_bitmaps, left.astype(np.int32), right.astype(np.int32),
            support[left].astype(np.int32),
            mode=mode, min_sup=abs_min_sup,
        )
        k += 1
        if not res.mask.any():
            break
        sel = np.nonzero(res.mask)[0]
        parent = left[sel]
        item_rank = item_rank[right[sel]]
        class_id = left[sel]
        partition = partition[left[sel]]
        support = res.supports
        store.add_level(LevelRecord(k=k, parent=parent, item_rank=item_rank,
                                    support=support, partition=partition))
        lvl_bitmaps = res.bitmaps


def _build_db(transactions, n_items, abs_min_sup, spec) -> Tuple[VerticalDB, dict]:
    info: dict = {}
    if spec["accumulator"]:
        db = build_vertical_accumulated(transactions, n_items, abs_min_sup,
                                        order="support_asc")
    else:
        db = build_vertical(transactions, n_items, abs_min_sup, order="support_asc")
    if spec["filter_txns"]:
        before = db
        db = filter_transactions(db)
        info["filter_reduction"] = filtering_reduction(before, db)
    return db, info


def _finish(store: ItemsetStore, db: VerticalDB, stats: dict,
            config: EclatConfig, t_start: float) -> EclatResult:
    """Common tail of every ``mine()`` return path: record the workload
    mode (and, for closed/maximal, the post-filtered count) and stamp wall
    time last so it covers the mode bookkeeping too."""
    stats["mode"] = config.mode
    res = EclatResult(store=store, db=db, stats=stats, mode=config.mode)
    if config.mode != "all":
        stats["mode_itemsets"] = len(res.workload_map())
    stats["total_s"] = time.perf_counter() - t_start
    return res


def _check_config(config: EclatConfig) -> None:
    if config.variant not in VARIANTS:
        raise ValueError(f"unknown variant {config.variant!r}; "
                         f"expected one of {sorted(VARIANTS)}")
    for field, default in _UNPORTED_DEFAULTS.items():
        if getattr(config, field) != default:
            raise NotImplementedError(
                f"EclatConfig.{field}={getattr(config, field)!r} is not "
                f"ported yet (single-device batch mining only)")
    if config.use_diffsets and config.variant != "v6":
        # every variant but v6 mines tidsets; silently dropping the flag
        # would hand back correct-looking results from a different algorithm
        raise ValueError(
            f"use_diffsets is only supported by variant 'v6' (dEclat); "
            f"variant {config.variant!r} would silently ignore it")
    if config.max_k is not None and config.max_k < 1:
        raise ValueError(f"max_k must be >= 1 (or None for unbounded), "
                         f"got {config.max_k}")
    if config.mode not in WORKLOAD_MODES:
        raise ValueError(f"unknown workload mode {config.mode!r}; "
                         f"expected one of {WORKLOAD_MODES}")


def mine(
    transactions: Sequence[Sequence[int]],
    n_items: int,
    config: EclatConfig,
    device: DeviceLike = None,
) -> EclatResult:
    """Mine all frequent itemsets on one device (``None`` = CUDA; with no
    card that raises unless ``device="cpu"`` is passed)."""
    _check_config(config)
    dev = resolve_device(device)
    spec = VARIANTS[config.variant]
    t_start = time.perf_counter()
    stats: dict = {"variant": config.variant, "device": str(dev), "phase_s": {}}

    n_txn = len(transactions)
    abs_min_sup = config.resolve_min_sup(n_txn)
    stats["abs_min_sup"] = abs_min_sup

    # ---- Phase 1 (+2 filtering / +3 accumulator): vertical DB -------------
    t0 = time.perf_counter()
    db, info = _build_db(transactions, n_items, abs_min_sup, spec)
    stats.update(info)
    stats["phase_s"]["vertical"] = time.perf_counter() - t0
    n1, w = db.n_items, db.n_words
    stats["n_freq_items"] = n1
    stats["n_words"] = w

    store = ItemsetStore(db.items)
    # partition table over 1-length-prefix classes (class rank r, r < n1-1)
    n_classes = max(n1 - 1, 0)
    sizes1 = (n1 - 1 - np.arange(n_classes)).clip(min=0)
    est = pair_work(sizes1 + 1, w)  # +1: member count of class r is n1-1-r
    eff_p = config.p if spec["partitioner"] in ("hash", "reverse_hash", "greedy") else max(n_classes, 1)
    table = assign_partitions(n_classes, spec["partitioner"], eff_p, work=est)
    execu = eng.make_engine(config.backend, bucket_min=config.bucket_min)
    stats["backend"] = execu.name
    stats["backend_requested"] = config.backend

    if n_classes > 0:
        pstats = partition_stats(table, est, eff_p)
        stats["partition_balance"] = {
            **{k_: v for k_, v in pstats.items() if k_ != "loads"},
            "estimated_loads": pstats["loads"].tolist(),
        }

    lvl1_partition = np.concatenate([table, [table[-1] if n_classes else 0]])[:n1] if n1 else np.zeros(0, np.int64)
    store.add_level(
        LevelRecord(
            k=1,
            parent=np.full(n1, -1, np.int64),
            item_rank=np.arange(n1, dtype=np.int64),
            support=db.supports.astype(np.int64),
            partition=lvl1_partition,
        )
    )
    # max_k bounds every level, including 2
    max_k = n1 if config.max_k is None else config.max_k
    if n1 < 2 or max_k < 2:
        stats.update(execu.stats())
        return _finish(store, db, stats, config, t_start)

    bitmaps = words_from_numpy(db.bitmaps, dev)
    diffsets = config.use_diffsets

    # ---- Phase 2: triangular matrix (2-itemset counts) --------------------
    t0 = time.perf_counter()
    tri = config.tri_matrix
    if tri is None:
        tri = n1 <= config.tri_matrix_max_items  # paper's BMS1/BMS2 opt-out
    stats["tri_matrix"] = bool(tri)

    sup1 = db.supports.astype(np.int32)
    mode2 = eng.MODE_TID_TO_DIFF if diffsets else eng.MODE_TIDSET
    if tri:
        counts2 = cooccurrence_counts(bitmaps, backend=execu.name)
        iu, ju, _ = frequent_pairs(counts2, abs_min_sup)
        # materialize bitmaps only for the survivors; every pre-filtered pair
        # must pass the engine's threshold again
        res = execu.expand(bitmaps, iu.astype(np.int32), ju.astype(np.int32),
                           sup1[iu], mode=mode2, min_sup=abs_min_sup)
        # the level-2 LevelRecord below aligns iu/ju (all pre-filtered
        # pairs) with res.supports (survivors only) on the assumption that
        # the two sets are identical; a corrupt count matrix breaks that
        # silently, misaligning every deeper level — so it is a real
        # exception, not an ``assert``
        if iu.size and not res.mask.all():
            bad = np.nonzero(~res.mask)[0]
            raise RuntimeError(
                f"triangular-matrix co-occurrence counts disagree with the "
                f"engine on {bad.size}/{res.mask.size} level-2 pair(s) "
                f"(first: item ranks {int(iu[bad[0]])},{int(ju[bad[0]])}) — "
                f"the tri-matrix pass is corrupt")
        sup2 = res.supports.astype(np.int32)
        lvl_bitmaps = res.bitmaps
    else:
        # chunked all-pairs (the paper's no-tri-matrix path for BMS datasets)
        iu_all, ju_all = np.triu_indices(n1, k=1)
        keep_i, keep_j, keep_s, keep_bm = [], [], [], []
        for s in range(0, iu_all.shape[0], config.chunk_pairs):
            ic = iu_all[s: s + config.chunk_pairs].astype(np.int32)
            jc = ju_all[s: s + config.chunk_pairs].astype(np.int32)
            res = execu.expand(bitmaps, ic, jc, sup1[ic],
                               mode=mode2, min_sup=abs_min_sup)
            if res.mask.any():
                keep_i.append(ic[res.mask]); keep_j.append(jc[res.mask])
                keep_s.append(res.supports.astype(np.int32))
                # chunks are concatenated into one frontier: strip the
                # engine's rung padding so survivor rows stay contiguous
                keep_bm.append(res.bitmaps[: int(res.mask.sum())])
        if keep_i:
            iu = np.concatenate(keep_i).astype(np.int64)
            ju = np.concatenate(keep_j).astype(np.int64)
            sup2 = np.concatenate(keep_s)
            lvl_bitmaps = torch.cat(keep_bm, dim=0)
        else:
            iu = ju = np.zeros(0, np.int64); sup2 = np.zeros(0, np.int32)
            lvl_bitmaps = torch.zeros((0, w), dtype=torch.int32, device=dev)
    stats["phase_s"]["tri_matrix"] = time.perf_counter() - t0

    store.add_level(LevelRecord(
        k=2, parent=iu.copy(), item_rank=ju.copy(), support=sup2.astype(np.int64),
        partition=table[iu] if iu.size else np.zeros(0, np.int64)))

    # ---- Phase 3/4: level-wise Bottom-Up -----------------------------------
    t0 = time.perf_counter()
    run_bottom_up(execu, store, lvl_bitmaps, iu.copy(), ju.copy(),
                  table[iu] if iu.size else np.zeros(0, np.int64),
                  sup2.astype(np.int64), abs_min_sup=abs_min_sup,
                  mode=eng.MODE_DIFFSET if diffsets else eng.MODE_TIDSET,
                  max_k=max_k)
    stats["phase_s"]["bottom_up"] = time.perf_counter() - t0

    stats.update(execu.stats())
    return _finish(store, db, stats, config, t_start)
