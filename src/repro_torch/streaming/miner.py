"""Sliding-window incremental Eclat: re-mine micro-batch streams in place.

The paper's argument for RDD-Eclat is that the vertical tidset state is worth
keeping resident between passes.  This module takes that to its conclusion:
when the database is a *sliding window* over a transaction stream, almost all
of a fresh ``mine()`` call is recomputation of state that one micro-batch
cannot have changed much.  The incremental miner therefore maintains, across
window slides:

* the packed vertical bitmap, as a ring of word-blocks (``WindowRing``) —
  admitting a micro-batch is one block pack + one in-place device write, never
  a full repack;
* per-item (1-itemset) supports, as the diagonal of
* the full co-occurrence count matrix ``C[i, j] = |tidset(i) ∩ tidset(j)|``
  over the item universe — popcount is additive across word blocks, so one
  slide updates it exactly with two block-sized co-occurrence products
  (``C += cooc(new_block) - cooc(evicted_block)``, the ``trimatrix`` kernel
  on the card) instead of the window-sized pass batch mining pays.  The
  matrix stays an ``int64`` host array, as in the reference package.

Re-mining a window is then: threshold the cached supports (equivalence
classes whose 1-prefix crossed ``min_sup`` enter or leave the active set with
no device work), read the frequent 2-itemsets straight out of ``C``, confirm
them with one expansion over the ring, and expand only the surviving classes
level by level through the *same* ``core.engine`` backend interface batch
mining uses — the frontier bitmaps never leave the device.  Results are
bit-exact with batch ``mine()`` over the window's transactions (DESIGN.md
§5).

The whole miner serializes as a :class:`MinerState` (DESIGN.md §10): ring,
engine accounting, the count matrix and the previous slide's frequent items,
all logical; :meth:`StreamingMiner.from_state` rebuilds it under any mesh
and backend, and ``streaming.persist`` writes it to disk.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from ..core import engine as eng
from ..core.eclat import resolve_min_sup, run_bottom_up
from ..core.equivalence import pair_work
from ..core.itemsets import ItemsetStore, LevelRecord, generate_rules
from ..core.partitioners import assign_partitions
from ..core.triangular import cooccurrence_counts, frequent_pairs
from ..core.vertical import sort_items
from ..device import DeviceLike, words_from_numpy
from ..faults import kill_point
from .window import RingState, WindowRing

__all__ = ["StreamConfig", "WindowResult", "StreamingMiner", "MinerState"]


@dataclasses.dataclass
class StreamConfig:
    """Knobs of the streaming miner (the EclatConfig of the windowed world)."""

    min_sup: float                 # float in (0,1] = fraction of live window txns; int >= 1 = count
    n_blocks: int = 16             # window capacity in micro-batch blocks
    block_txns: int = 1024         # txn columns per block (multiple of 32)
    backend: str = "fused"         # core.engine backend: fused (CUDA kernels) | ref (plain torch) | sharded | tidsharded | grid | auto (measured dispatch)
    shard: str = "pairs"           # mesh split: "pairs" | "words" (word-sharded ring, DESIGN.md §7) | "grid" (2D pairs x words mesh, DESIGN.md §8)
    partitioner: str = "greedy"    # equivalence-class placement (paper §4.5)
    p: int = 10                    # partitions for the class table
    max_k: Optional[int] = None    # deepest itemset length to mine (>= 1); None = unbounded
    bucket_min: int = 128          # engine pair-buffer ladder floor (half-pow2 rungs)
    block_w: Optional[int] = None  # K2's word tile or K1's/K3's chunk (core.engine.PORT_BLOCK_WS); None = autotune table, else the kernel's rule
    autotune: bool = False         # tune on a miss: measure a shape class's tiles before its first launch
    compact: bool = True           # survivor compaction inside the intersection call (K2); False = the reference's two steps (K1, host mask, row gather)

    def resolve_min_sup(self, n_txn: int) -> int:
        return resolve_min_sup(self.min_sup, n_txn)



@dataclasses.dataclass
class MinerState:
    """Serializable snapshot of a :class:`StreamingMiner` (DESIGN.md §10),
    the reference's fields and tree.

    Composes the ring and engine contracts with the miner's own incremental
    state: the co-occurrence count matrix (the host ``int64`` matrix itself,
    never a float copy) and the previous slide's frequent items (class-churn
    lineage).  Everything here is logical — the ring's device slice, the
    engine's pair buffers and the mesh are derived on restore — so a
    snapshot taken under any backend and mesh restores under any other
    (:meth:`StreamingMiner.from_state`), bit-exact.  ``config`` holds the
    port's backend names; ``streaming.persist`` writes the reference's.
    """
    n_items: int
    config: dict                          # StreamConfig, as a plain dict
    ring: RingState
    engine: eng.EngineState
    cooc: np.ndarray                      # (n_items, n_items) int64
    prev_frequent: Optional[np.ndarray]   # last slide's frequent items
    window_version: int = 0               # monotonic slide stamp (DESIGN.md §11)

    def to_tree(self):
        """Flat ``{path: ndarray}`` tree + JSON-able extra, ready for
        ``training.checkpoint.save_checkpoint``; ring and engine leaves are
        namespaced under ``ring/`` and ``engine/``."""
        ring_tree, ring_extra = self.ring.to_tree()
        eng_tree, eng_extra = self.engine.to_tree()
        tree = {"cooc": np.asarray(self.cooc, np.int64)}
        if self.prev_frequent is not None:
            tree["prev_frequent"] = np.asarray(self.prev_frequent, np.int64)
        tree.update({f"ring/{k}": v for k, v in ring_tree.items()})
        tree.update({f"engine/{k}": v for k, v in eng_tree.items()})
        extra = {"kind": "miner_state", "version": 1,
                 "n_items": int(self.n_items), "config": dict(self.config),
                 "has_prev_frequent": self.prev_frequent is not None,
                 "window_version": int(self.window_version),
                 "ring": ring_extra, "engine": eng_extra}
        return tree, extra

    @classmethod
    def from_tree(cls, tree, extra) -> "MinerState":
        def sub(prefix):
            return {k[len(prefix):]: v for k, v in tree.items()
                    if k.startswith(prefix)}
        return cls(
            n_items=int(extra["n_items"]), config=dict(extra["config"]),
            ring=RingState.from_tree(sub("ring/"), extra["ring"]),
            engine=eng.EngineState.from_tree(sub("engine/"), extra["engine"]),
            cooc=np.asarray(tree["cooc"], np.int64),
            prev_frequent=(np.asarray(tree["prev_frequent"], np.int64)
                           if extra["has_prev_frequent"] else None),
            # checkpoints from before version stamping restore at version 0
            window_version=int(extra.get("window_version", 0)))


@dataclasses.dataclass
class WindowResult:
    """Frequent itemsets of the current window + per-slide accounting.

    ``version`` is the miner's ``window_version`` at mine time — the cache
    key of the serving layer (DESIGN.md §11): two results with equal
    versions were mined from identical window contents.
    """

    store: ItemsetStore
    n_txn: int
    stats: dict
    version: int = 0

    @property
    def counts(self) -> List[int]:
        return self.store.counts

    @property
    def total(self) -> int:
        return self.store.total

    def itemsets(self):
        return self.store.itemsets()

    def support_map(self):
        return self.store.support_map()

    def rules(self, min_conf: float):
        return generate_rules(self.support_map(), min_conf)


class StreamingMiner:
    """Ingest micro-batches, keep the vertical state incremental, re-mine.

    ``advance(batch)`` = ``push(batch)`` (state deltas only) +
    ``mine_window()`` (re-expansion); callers that mine on a cadence rather
    than every batch can call the two halves separately.  Runs on ``device``
    (``None`` = CUDA, which raises without a card; ``"cpu"`` runs the plain
    torch paths on the host); with a ``mesh`` every rank builds the miner
    alike and pushes the same batches.
    """

    def __init__(self, n_items: int, config: StreamConfig, mesh=None,
                 keep_transactions: bool = True, device: DeviceLike = None):
        self.n_items = int(n_items)
        self.config = config
        self.mesh = mesh
        # word-sharded and grid modes carry the ring itself as this rank's
        # word slice, so the window bitmap never fully lands on any one rank
        words_mode = (config.shard in ("words", "grid")
                      or config.backend in ("tidsharded", "grid"))
        self.ring = WindowRing(n_items, config.n_blocks, config.block_txns,
                               keep_transactions=keep_transactions,
                               mesh=mesh if words_mode else None,
                               device=device)
        self.device = self.ring.dev
        # incremental state: co-occurrence counts over the item universe;
        # per-item supports are its diagonal
        self.cooc = np.zeros((n_items, n_items), np.int64)
        # dispatch hints for backend="auto" (the reference's): the
        # steady-state expansion is bounded by the item universe and the
        # ring's capacity
        est_q = max(n_items * (n_items - 1) // 2, 1)
        est_w = max(-(-int(config.n_blocks) * int(config.block_txns) // 32), 1)
        self.engine = eng.resolve_engine(config.backend, mesh,
                                         bucket_min=config.bucket_min,
                                         shard=config.shard,
                                         block_w=config.block_w,
                                         autotune=config.autotune,
                                         compact=config.compact,
                                         hints=(est_q, est_w),
                                         device=self.device)
        # the count matrix on the engine's executor: the kernel for fused,
        # the plain version for ref
        self._cooc_backend = self.engine.executor
        self._prev_frequent: Optional[np.ndarray] = None
        # monotonic window-content stamp: bumped once per completed push();
        # mine_window() stamps its result with the current value, so equal
        # versions imply identical window contents (the serving cache key,
        # DESIGN.md §11)
        self.window_version = 0

    # -- incremental state maintenance --------------------------------------

    @property
    def supports(self) -> np.ndarray:
        """Per-item supports over the live window (universe-indexed)."""
        return np.diag(self.cooc)

    def _block_counts(self, block: np.ndarray) -> np.ndarray:
        words = words_from_numpy(block, self.device)
        self.engine.tune_cooccurrence(words)
        return cooccurrence_counts(words,
                                   backend=self._cooc_backend).astype(np.int64)

    def push(self, batch: Sequence[Sequence[int]]) -> dict:
        """Admit one micro-batch; update ring + counts by block deltas."""
        t0 = time.perf_counter()
        new_block, old_block, n_evicted = self.ring.push(batch)
        # ring written, count matrix not yet — the torn state recovery must
        # handle
        kill_point("miner:mid_append")
        # popcount is additive over word blocks, so the count matrix follows
        # the ring exactly: add the admitted block, subtract the evicted one
        self.cooc += self._block_counts(new_block)
        # admitted block counted, evicted block not yet subtracted
        kill_point("miner:mid_evict")
        if n_evicted or old_block.any():
            self.cooc -= self._block_counts(old_block)
        # the window's contents changed: new version.  Bumped only after the
        # ring AND the count matrix agree, so a crash between the kill points
        # above never publishes a version for a half-applied slide.
        self.window_version += 1
        return {
            "push_s": time.perf_counter() - t0,
            "n_admitted": len(batch),
            "n_evicted": n_evicted,
        }

    # -- re-mining -----------------------------------------------------------

    def mine_window(self) -> WindowResult:
        """Expand the active equivalence classes of the current window.

        Level-1 supports and level-2 counts are read from the incrementally
        maintained state; level 2 is confirmed by one expansion over the
        ring, and only levels >= 3 of classes that still hold a frequent pair
        do further device work, through ``engine.expand`` (so the backends
        are interchangeable here exactly as in batch ``mine()``).
        """
        cfg = self.config
        if cfg.max_k is not None and cfg.max_k < 1:
            raise ValueError(f"max_k must be >= 1 (or None for unbounded), "
                             f"got {cfg.max_k}")
        t_start = time.perf_counter()
        engine_snap = self.engine.snapshot()
        n_txn = self.ring.n_txn
        abs_min_sup = cfg.resolve_min_sup(n_txn)
        stats: dict = {
            "abs_min_sup": abs_min_sup,
            "window_version": int(self.window_version),
            "window": {"n_txn": n_txn, "filled_blocks": self.ring.filled,
                       "n_blocks": self.ring.n_blocks,
                       "n_words": self.ring.n_words},
            "phase_s": {},
        }

        sup = self.supports
        freq = sup >= abs_min_sup
        item_ids = np.nonzero(freq)[0].astype(np.int64)
        # class churn: prefixes whose support crossed min_sup this slide
        prev = self._prev_frequent
        if prev is None:
            entered, exited = item_ids, np.zeros(0, np.int64)
        else:
            entered = np.setdiff1d(item_ids, prev, assume_unique=True)
            exited = np.setdiff1d(prev, item_ids, assume_unique=True)
        self._prev_frequent = item_ids
        stats["classes"] = {"n_active": int(item_ids.shape[0]),
                            "n_entered": int(entered.shape[0]),
                            "n_exited": int(exited.shape[0])}

        sup_f = sup[item_ids]
        perm = sort_items(item_ids, sup_f, "support_asc")
        items = item_ids[perm]
        sup1 = sup_f[perm].astype(np.int64)
        n1 = int(items.shape[0])

        store = ItemsetStore(items)
        n_classes = max(n1 - 1, 0)
        sizes1 = (n1 - 1 - np.arange(n_classes)).clip(min=0)
        est = pair_work(sizes1 + 1, self.ring.n_words)
        eff_p = cfg.p if cfg.partitioner in ("hash", "reverse_hash", "greedy") \
            else max(n_classes, 1)
        table = assign_partitions(n_classes, cfg.partitioner, eff_p, work=est)
        part_to_dev = np.arange(eff_p, dtype=np.int64) % max(self.engine.n_devices, 1)

        lvl1_partition = (np.concatenate([table, [table[-1] if n_classes else 0]])[:n1]
                          if n1 else np.zeros(0, np.int64))
        store.add_level(LevelRecord(k=1, parent=np.full(n1, -1, np.int64),
                                    item_rank=np.arange(n1, dtype=np.int64),
                                    support=sup1, partition=lvl1_partition))
        # max_k bounds every level, including 2 (bit-exact with batch mine())
        max_k = n1 if cfg.max_k is None else cfg.max_k
        if n1 < 2 or max_k < 2:
            stats.update(self.engine.stats(since=engine_snap))
            stats["total_s"] = time.perf_counter() - t_start
            return WindowResult(store=store, n_txn=n_txn, stats=stats,
                                version=self.window_version)

        # ---- level 2: straight from the cached count matrix ----------------
        t0 = time.perf_counter()
        # the ring as the engine carries it (this rank's slice on a
        # word-sharded mesh), adopted as it is: it is never cut again
        frontier = self.engine.adopt_frontier(self.ring.device, self.ring.n_words)
        csub = self.cooc[np.ix_(items, items)]
        iu, ju, _ = frequent_pairs(csub, abs_min_sup)
        if iu.size:
            # the ring's rows are the item universe: pairs are universe ids
            res = self.engine.expand(
                frontier,
                items[iu].astype(np.int32), items[ju].astype(np.int32),
                sup1[iu].astype(np.int32),
                mode=eng.MODE_TIDSET, min_sup=abs_min_sup,
                device_of_pair=part_to_dev[table[iu]],
            )
            # pairs were pre-filtered by the exact cached counts, so the
            # engine must confirm every one; disagreement means the
            # incremental state is corrupt and every further window would be
            # silently wrong.  A real exception, not an ``assert`` — this
            # must also fire under ``python -O``.
            if not res.mask.all():
                bad = np.nonzero(~res.mask)[0]
                raise RuntimeError(
                    f"cached co-occurrence counts disagree with the engine "
                    f"on {bad.size}/{res.mask.size} level-2 pair(s) "
                    f"(first: items {int(items[iu[bad[0]]])},"
                    f"{int(items[ju[bad[0]]])}) — incremental window state "
                    f"is corrupt")
            sup2 = res.supports.astype(np.int64)
            lvl_bitmaps = res.bitmaps
        else:
            sup2 = np.zeros(0, np.int64)
            lvl_bitmaps = frontier.new_zeros((0, frontier.shape[1]))
        partition = table[iu] if iu.size else np.zeros(0, np.int64)
        store.add_level(LevelRecord(k=2, parent=iu.copy(), item_rank=ju.copy(),
                                    support=sup2, partition=partition))
        stats["phase_s"]["level2"] = time.perf_counter() - t0

        # ---- levels >= 3: the shared per-class bottom-up loop --------------
        # level-2 read from the cached counts, deep expansion not yet run
        kill_point("miner:pre_deep_expand")
        t0 = time.perf_counter()
        run_bottom_up(self.engine, store, lvl_bitmaps,
                      class_id=iu.copy(), item_rank=ju.copy(),
                      partition=partition, support=sup2,
                      abs_min_sup=abs_min_sup, mode=eng.MODE_TIDSET,
                      max_k=max_k, part_to_dev=part_to_dev)
        stats["phase_s"]["bottom_up"] = time.perf_counter() - t0
        # engine counters are lifetime-cumulative; report this slide's delta
        stats.update(self.engine.stats(since=engine_snap))
        stats["total_s"] = time.perf_counter() - t_start
        return WindowResult(store=store, n_txn=n_txn, stats=stats,
                            version=self.window_version)

    def advance(self, batch: Sequence[Sequence[int]]) -> WindowResult:
        """One window slide: admit the micro-batch, then re-mine."""
        push_stats = self.push(batch)
        result = self.mine_window()
        result.stats.update(push_stats)
        result.stats["slide_s"] = push_stats["push_s"] + result.stats["total_s"]
        return result

    def window_transactions(self) -> List[List[int]]:
        """Live window contents (for parity checks against batch mining)."""
        return self.ring.window_transactions()

    # -- serializable state (DESIGN.md §10) ---------------------------------

    def snapshot_state(self) -> MinerState:
        """Deep-copied logical state of the whole miner, from host state
        alone (the ring's host mirror, the host count matrix); safe to hand
        to an asynchronous checkpoint writer while the stream keeps
        sliding."""
        return MinerState(
            n_items=self.n_items,
            config=dataclasses.asdict(self.config),
            ring=self.ring.snapshot_state(),
            engine=self.engine.snapshot_state(),
            cooc=self.cooc.copy(),
            prev_frequent=(None if self._prev_frequent is None
                           else self._prev_frequent.copy()),
            window_version=int(self.window_version))

    @classmethod
    def from_state(cls, state: MinerState, mesh=None, *,
                   backend: Optional[str] = None,
                   shard: Optional[str] = None,
                   keep_transactions: Optional[bool] = None,
                   device: DeviceLike = None) -> "StreamingMiner":
        """Rebuild a miner from a snapshot, possibly re-meshed, on ``device``
        (``None`` = CUDA).

        ``mesh`` is whatever the restoring process brings — fewer ranks, a
        different grid factorization, or ``None`` for one device — and
        ``backend`` / ``shard`` override the snapshot's config for
        cross-family moves (e.g. a ``tidsharded`` checkpoint restored as
        plain ``fused``).  All device placement is re-derived from the
        logical state, so the restored miner's itemsets are bit-exact with
        the snapshot's lineage.
        """
        state.engine.check_portable()
        fields = {f.name for f in dataclasses.fields(StreamConfig)}
        cfg_kw = {k: v for k, v in dict(state.config).items() if k in fields}
        if backend is not None:
            cfg_kw["backend"] = backend
        if shard is not None:
            cfg_kw["shard"] = shard
        cfg = StreamConfig(**cfg_kw)
        keep = (state.ring.txns is not None if keep_transactions is None
                else keep_transactions)
        miner = cls(state.n_items, cfg, mesh=mesh, keep_transactions=keep,
                    device=device)
        miner.ring.restore_state(state.ring)
        miner.cooc = np.array(state.cooc, np.int64, copy=True)
        miner._prev_frequent = (None if state.prev_frequent is None
                                else np.asarray(state.prev_frequent,
                                                np.int64).copy())
        miner.window_version = int(state.window_version)
        miner.engine.restore_state(state.engine)
        return miner
