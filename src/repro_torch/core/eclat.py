"""RDD-Eclat on PyTorch: the paper's five variants (plus a beyond-paper sixth),
on one device or on a mesh of ranks.

Execution model (DESIGN.md §2-3): the host process plays the Spark driver —
it owns data-dependent control flow (class segmentation, survivor
bookkeeping) — while the card executes the tidset-intersection hot loop
behind the ``core.engine`` backend interface.  Equivalence classes are
assigned to partitions once, from their 1-length prefix, and descendants
never migrate; on a mesh, partitions go round-robin to the ranks of the
engine's pair axis.  With a ``mesh`` every rank calls ``mine()`` on the same
transactions and returns the same result (``launch.mesh``).

Variants:
  v1  vertical build via scatter, no filtering, default partitioner
  v2  + filtered transactions (bitmap column compaction)
  v3  + accumulator-built vertical DB
  v4  v3 + hash partitioner (p user-set)
  v5  v3 + reverse-hash partitioner
  v6  (beyond paper) v3 + greedy-LPT partitioner, optional dEclat diffsets

With ``checkpoint_dir`` and ``checkpoint_every_level``, every level from 3
down is checkpointed (``core.lineage``, the reference's ``.npz`` files),
and :func:`resume_mine` continues a run from its deepest checkpoint, on any
backend and mesh.

``backend="auto"`` picks the backend from the measured crossover table
(``core.engine.DispatchPolicy``) for the level-2 shape; ``block_w`` names
the word tile of the fused-intersect kernel an expansion launches (K2's, or
the chunk K1 and K3 stage) and ``autotune`` tunes the kernels' tiles on a
miss (``kernels.autotune``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, words_from_numpy
from ..dist import collectives as coll
from ..dist.sharding import is_lead_rank
from . import engine as eng
from .accumulator import build_vertical_accumulated
from .equivalence import class_segments, pair_work, segment_pairs
from .itemsets import ItemsetStore, LevelRecord
from .partitioners import assign_partitions, partition_stats
from .postfilter import WORKLOAD_MODES, filter_mode
from .triangular import cooccurrence_counts, frequent_pairs
from .vertical import VerticalDB, build_vertical, filter_transactions, filtering_reduction

__all__ = ["EclatConfig", "EclatResult", "mine", "resume_mine",
           "resolve_min_sup", "run_bottom_up", "VARIANTS"]

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
    backend: str = "fused"              # fused (CUDA kernels) | ref (plain torch) | sharded | tidsharded | grid | auto (measured dispatch; "batched" = alias of the default)
    shard: str = "pairs"                # mesh split: "pairs" (frontier replicated) | "words" (tid axis) | "grid" (pairs x words 2D mesh)
    mode: str = "all"                   # workload: all | closed | maximal (DESIGN.md §9)
    max_k: Optional[int] = None         # deepest itemset length to mine (>= 1); None = unbounded
    bucket_min: int = 128               # pair-buffer ladder floor
    chunk_pairs: int = 1 << 18          # level-2 chunking when tri-matrix off
    checkpoint_dir: Optional[str] = None      # per-level mining checkpoints (lead rank writes)
    checkpoint_every_level: bool = False
    block_w: Optional[int] = None       # K2's word tile or K1's/K3's chunk (core.engine.PORT_BLOCK_WS); None = autotune table, else the kernel's rule
    autotune: bool = False              # tune on a miss: measure a shape class's tiles before its first launch
    compact: bool = True                # survivor compaction inside the intersection call (K2); False = the reference's two steps (K1, host mask, row gather)

    def resolve_min_sup(self, n_txn: int) -> int:
        return resolve_min_sup(self.min_sup, n_txn)


@dataclasses.dataclass
class EclatResult:
    store: ItemsetStore
    db: Optional[VerticalDB]            # None when resumed from a checkpoint
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
    part_to_dev: np.ndarray,
    on_level=None,
    k: int = 2,
) -> None:
    """Levels >= 3: per-class level-wise expansion (the paper's Phase-4).

    Starts from a level-2 frontier (``class_id``/``item_rank``/``partition``/
    ``support`` row-aligned with ``lvl_bitmaps``) and appends one
    ``LevelRecord`` per surviving level.  ``part_to_dev`` maps a partition
    to its rank on the engine's pair axis; ``on_level`` (checkpointing) sees
    every new frontier.  ``k`` is the level of the given frontier: 2, or a
    resumed checkpoint's level (the reference restarts the count at 2 there,
    so its ``resume_mine`` from any but the last level raises).
    """
    while support.shape[0] and k < max_k:
        starts, sizes = class_segments(class_id)
        left, right = segment_pairs(starts, sizes)
        if left.size == 0:
            break
        res = execu.expand(
            lvl_bitmaps, left.astype(np.int32), right.astype(np.int32),
            support[left].astype(np.int32),
            mode=mode, min_sup=abs_min_sup,
            device_of_pair=part_to_dev[partition[left]],
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
        if on_level is not None:
            on_level(k, class_id, item_rank, partition, support, lvl_bitmaps)


def _build_db(transactions, n_items, abs_min_sup, spec, mesh=None,
              dev=None) -> Tuple[VerticalDB, dict]:
    info: dict = {}
    if spec["accumulator"]:
        db = build_vertical_accumulated(transactions, n_items, abs_min_sup,
                                        order="support_asc", mesh=mesh,
                                        device=dev)
    else:
        db = build_vertical(transactions, n_items, abs_min_sup, order="support_asc")
    if spec["filter_txns"]:
        before = db
        db = filter_transactions(db)
        info["filter_reduction"] = filtering_reduction(before, db)
    return db, info


def _finish(store: ItemsetStore, db: Optional[VerticalDB], stats: dict,
            config: EclatConfig, t_start: float, execu: eng.Engine,
            mesh, coll_start: dict) -> EclatResult:
    """Common tail of every ``mine()`` return path after the engine is
    built: record its stats and the levels' collectives, the workload mode
    (and, for closed/maximal, the post-filtered count), and stamp wall time
    last so it covers the mode bookkeeping too."""
    stats.update(execu.stats())
    if mesh is not None:
        stats["collectives"]["levels"] = coll.counts_since(coll_start)
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
    mesh=None,
) -> EclatResult:
    """Mine all frequent itemsets on ``device`` (``None`` = CUDA; with no
    card that raises unless ``device="cpu"`` is passed).  ``mesh`` (a
    ``torch.distributed`` ``DeviceMesh``, see ``launch.mesh``) enables the
    mesh backends, ``config.shard`` picking pair-, word- or grid-sharding;
    every rank of the mesh calls ``mine()`` alike.  On a mesh,
    ``stats["collectives"]`` holds the collective calls and payload bytes
    of this rank, per axis, of the vertical build and of the levels."""
    _check_config(config)
    dev = resolve_device(device)
    spec = VARIANTS[config.variant]
    t_start = time.perf_counter()
    stats: dict = {"variant": config.variant, "device": str(dev), "phase_s": {}}
    coll_start = coll.collective_counts()

    n_txn = len(transactions)
    abs_min_sup = config.resolve_min_sup(n_txn)
    stats["abs_min_sup"] = abs_min_sup

    # ---- Phase 1 (+2 filtering / +3 accumulator): vertical DB -------------
    t0 = time.perf_counter()
    db, info = _build_db(transactions, n_items, abs_min_sup, spec, mesh, dev)
    stats.update(info)
    stats["phase_s"]["vertical"] = time.perf_counter() - t0
    if mesh is not None:
        stats["collectives"] = {"vertical": coll.counts_since(coll_start)}
    coll_start = coll.collective_counts()
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
    # dispatch hints for backend="auto": the dominant expansion is level 2,
    # all pairs of the n1 frequent items over w words (the reference's)
    est_q2 = n1 * (n1 - 1) // 2
    execu = eng.resolve_engine(config.backend, mesh,
                               bucket_min=config.bucket_min,
                               shard=config.shard, block_w=config.block_w,
                               autotune=config.autotune, compact=config.compact,
                               hints=(max(est_q2, 1), max(w, 1)), device=dev)
    stats["backend"] = execu.name
    stats["backend_requested"] = config.backend
    stats["dispatch"] = execu.dispatch
    # partition -> rank round robin (the mesh backends' pair axis)
    part_to_dev = np.arange(eff_p, dtype=np.int64) % max(execu.n_devices, 1)

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
        return _finish(store, db, stats, config, t_start, execu, mesh,
                       coll_start)

    full = words_from_numpy(db.bitmaps, dev)
    # the frontier as the backend carries it (a rank's word slice for the
    # word-sharded backends), placed once: the chunked level-2 path below
    # expands it many times
    bitmaps = execu.prepare_frontier(full)
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
        # the counts of the whole level-1 frontier, which every rank holds
        execu.tune_cooccurrence(full)
        counts2 = cooccurrence_counts(full, backend=execu.executor)
        iu, ju, _ = frequent_pairs(counts2, abs_min_sup)
        # materialize bitmaps only for the survivors; every pre-filtered pair
        # must pass the engine's threshold again
        res = execu.expand(bitmaps, iu.astype(np.int32), ju.astype(np.int32),
                           sup1[iu], mode=mode2, min_sup=abs_min_sup,
                           device_of_pair=part_to_dev[table[iu]] if iu.size else None)
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
                               mode=mode2, min_sup=abs_min_sup,
                               device_of_pair=part_to_dev[table[ic]] if ic.size else None)
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
            lvl_bitmaps = bitmaps.new_zeros((0, bitmaps.shape[1]))
    stats["phase_s"]["tri_matrix"] = time.perf_counter() - t0

    store.add_level(LevelRecord(
        k=2, parent=iu.copy(), item_rank=ju.copy(), support=sup2.astype(np.int64),
        partition=table[iu] if iu.size else np.zeros(0, np.int64)))

    # ---- Phase 3/4: level-wise Bottom-Up -----------------------------------
    t0 = time.perf_counter()
    mode_k = eng.MODE_DIFFSET if diffsets else eng.MODE_TIDSET
    on_level = None
    if config.checkpoint_dir and config.checkpoint_every_level:
        # resume metadata: everything resume_mine needs that is not derivable
        # from the frontier arrays themselves (DESIGN.md §10)
        on_level = _level_checkpointer(
            config.checkpoint_dir, store, execu, mesh,
            {"abs_min_sup": int(abs_min_sup), "engine_mode": int(mode_k),
             "max_k": int(max_k), "eff_p": int(eff_p),
             "use_diffsets": bool(diffsets)})
    run_bottom_up(execu, store, lvl_bitmaps, iu.copy(), ju.copy(),
                  table[iu] if iu.size else np.zeros(0, np.int64),
                  sup2.astype(np.int64), abs_min_sup=abs_min_sup,
                  mode=mode_k, max_k=max_k, part_to_dev=part_to_dev,
                  on_level=on_level)
    stats["phase_s"]["bottom_up"] = time.perf_counter() - t0
    return _finish(store, db, stats, config, t_start, execu, mesh, coll_start)


def _level_checkpointer(directory: str, store: ItemsetStore, execu: eng.Engine,
                        mesh, meta: dict):
    """The ``on_level`` hook that writes one mining checkpoint per level:
    the frontier's survivor rows, whole, on the host (``Engine.host_rows``;
    a gather of the slices on the word-sharded backends, on every rank),
    written by the mesh's lead rank only."""
    from .lineage import save_mining_checkpoint
    writer = is_lead_rank(mesh)

    def on_level(k, class_id, item_rank, partition, support, lvl_bitmaps):
        rows = execu.host_rows(lvl_bitmaps, support.shape[0])
        if writer:
            save_mining_checkpoint(directory, store, k, class_id, item_rank,
                                   partition, support, rows, meta=meta)
    return on_level


def _resume_path(directory: str, mesh) -> str:
    """The checkpoint every rank resumes from: the lead rank picks the
    deepest one and broadcasts its level, so every rank reads the same
    file."""
    from .lineage import latest_mining_checkpoint, mining_checkpoint_path
    k = -1
    if is_lead_rank(mesh):
        try:
            path = latest_mining_checkpoint(directory)
            k = int(os.path.basename(path)[len("mining_ckpt_k"):-len(".npz")])
        except FileNotFoundError:
            pass
    k = coll.lead_int(k, mesh)
    if k < 0:
        raise FileNotFoundError(
            f"no mining checkpoint (mining_ckpt_k*.npz) under {directory!r}")
    return mining_checkpoint_path(directory, k)


def resume_mine(config: EclatConfig, device: DeviceLike = None,
                mesh=None) -> EclatResult:
    """Continue a batch mine from its deepest per-level checkpoint.

    Reads the deepest ``mining_ckpt_k*.npz`` under ``config.checkpoint_dir``
    (written by ``mine()`` with ``checkpoint_every_level=True``, by this
    package or the reference), rebuilds the store and frontier, and resumes
    ``run_bottom_up`` from the checkpointed level on ``device`` (``None`` =
    CUDA).  The engine is resolved fresh from *this* call's
    ``config.backend`` / ``config.shard`` / ``mesh`` — restore onto a
    different mesh or a single device, and the frontier is re-placed by
    ``prepare_frontier`` (DESIGN.md §10): the remaining levels come out
    bit-exact because every backend is bit-exact on the same frontier.  The
    original transactions are not needed; ``EclatResult.db`` is ``None``.
    On a mesh every rank calls it alike; ``stats["collectives"]`` holds the
    resume's broadcasts (``restore``) and the levels'.
    """
    from .lineage import load_mining_checkpoint

    _check_config(config)
    if not config.checkpoint_dir:
        raise ValueError("resume_mine needs config.checkpoint_dir")
    dev = resolve_device(device)
    t_start = time.perf_counter()
    coll_start = coll.collective_counts()
    path = _resume_path(config.checkpoint_dir, mesh)
    store, fr = load_mining_checkpoint(path)
    meta = fr.get("meta") or {}
    if "abs_min_sup" not in meta:
        raise ValueError(
            f"{path} predates resume metadata — re-run the original mine "
            f"with this version to write a resumable checkpoint")
    abs_min_sup = int(meta["abs_min_sup"])
    mode_k = int(meta["engine_mode"])
    max_k = int(meta["max_k"])
    eff_p = int(meta["eff_p"])
    stats: dict = {"variant": config.variant, "device": str(dev), "phase_s": {},
                   "abs_min_sup": abs_min_sup,
                   "resumed_from": path, "resume_k": int(fr["k"])}
    if mesh is not None:
        stats["collectives"] = {"restore": coll.counts_since(coll_start)}
    coll_start = coll.collective_counts()

    execu = eng.resolve_engine(config.backend, mesh,
                               bucket_min=config.bucket_min,
                               shard=config.shard, block_w=config.block_w,
                               autotune=config.autotune, compact=config.compact,
                               device=dev)
    stats["backend"] = execu.name
    stats["backend_requested"] = config.backend
    part_to_dev = np.arange(eff_p, dtype=np.int64) % max(execu.n_devices, 1)
    lvl_bitmaps = execu.prepare_frontier(words_from_numpy(fr["bitmaps"], dev))
    on_level = (_level_checkpointer(config.checkpoint_dir, store, execu, mesh,
                                    meta)
                if config.checkpoint_every_level else None)

    t0 = time.perf_counter()
    run_bottom_up(execu, store, lvl_bitmaps,
                  class_id=np.asarray(fr["class_id"]),
                  item_rank=np.asarray(fr["item_rank"]),
                  partition=np.asarray(fr["partition"]),
                  support=np.asarray(fr["support"]).astype(np.int64),
                  abs_min_sup=abs_min_sup, mode=mode_k, max_k=max_k,
                  part_to_dev=part_to_dev, on_level=on_level, k=int(fr["k"]))
    stats["phase_s"]["bottom_up"] = time.perf_counter() - t0
    return _finish(store, None, stats, config, t_start, execu, mesh, coll_start)
