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

Not ported yet: the serializable state (``MinerState``, ``snapshot_state``,
``from_state``) and its checkpointer wait for ROADMAP item 9.
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
from .window import WindowRing

__all__ = ["StreamConfig", "WindowResult", "StreamingMiner"]


@dataclasses.dataclass
class StreamConfig:
    """Knobs of the streaming miner (the EclatConfig of the windowed world)."""

    min_sup: float                 # float in (0,1] = fraction of live window txns; int >= 1 = count
    n_blocks: int = 16             # window capacity in micro-batch blocks
    block_txns: int = 1024         # txn columns per block (multiple of 32)
    backend: str = "fused"         # core.engine backend: fused (CUDA kernels) | ref (plain torch) | sharded | tidsharded | grid
    shard: str = "pairs"           # mesh split: "pairs" | "words" (word-sharded ring, DESIGN.md §7) | "grid" (2D pairs x words mesh, DESIGN.md §8)
    partitioner: str = "greedy"    # equivalence-class placement (paper §4.5)
    p: int = 10                    # partitions for the class table
    max_k: Optional[int] = None    # deepest itemset length to mine (>= 1); None = unbounded
    bucket_min: int = 128          # engine pair-buffer ladder floor (half-pow2 rungs)
    # not ported yet: any value but these defaults raises NotImplementedError
    block_w: Optional[int] = None
    autotune: bool = False
    compact: bool = True

    def resolve_min_sup(self, n_txn: int) -> int:
        return resolve_min_sup(self.min_sup, n_txn)


# field -> (its default, the ROADMAP entry that will port it)
_UNPORTED = {"block_w": (None, "item 6 (tile selection and dispatch)"),
             "autotune": (False, "item 6 (tile selection and dispatch)"),
             "compact": (True, "queue 3 (the port has only the compacting "
                               "engine)")}


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
        for field, (default, item) in _UNPORTED.items():
            if getattr(config, field) != default:
                raise NotImplementedError(
                    f"StreamConfig.{field}={getattr(config, field)!r} is not "
                    f"ported yet (ROADMAP {item})")
        self.n_items = int(n_items)
        self.config = config
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
        self.engine = eng.resolve_engine(config.backend, mesh,
                                         bucket_min=config.bucket_min,
                                         shard=config.shard)
        # the count matrix on the engine's executor: the kernel for fused,
        # the plain version for ref
        self._cooc_backend = getattr(self.engine, "inner", self.engine.name)
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
        return cooccurrence_counts(words_from_numpy(block, self.device),
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
