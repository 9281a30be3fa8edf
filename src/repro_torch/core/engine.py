"""The level-expansion engine: the executor behind every tidset intersection.

``core.eclat.mine`` is driver logic (class segmentation, partition tables,
store bookkeeping); every intersection on the device goes through the
backend interface defined here.  A backend turns one level-expansion request

    (frontier bitmaps, pair lists, parent supports, mode, min_sup)

into a :class:`LevelResult`: the survivor mask and supports for the driver
plus the survivor bitmaps, compacted on the device — only the ``(Q,)`` mask
and supports come back to the host.

Backends (``EclatConfig.backend``):

  ref     plain torch gather + AND + popcount + threshold + compaction on
          the frontier's device: the semantics every backend must match
          bit for bit.
  fused   the hand-written CUDA kernels (``kernels.fused_intersect``) for a
          frontier on the card, their plain torch version for one on the
          host.  Default.

Mesh backends, one process per rank over a ``torch.distributed`` device
mesh (``launch.mesh``); each runs ``ref`` or ``fused`` as its inner
executor, and every rank returns the same :class:`LevelResult`:

  sharded     pairs grouped by the rank their equivalence class was
              partitioned to (the paper's executor mapping), the frontier
              replicated; each rank intersects and compacts its block (K2),
              then supports and survivor rows are all-gathered over the
              pair axis.
  tidsharded  the frontier's word (tid) axis split over ``data``: every
              rank holds a (P, ceil(W / n)) slice, computes the raw
              popcount of every pair on it (K3, ``fused_intersect_partial``),
              one all-reduce of the (Q,) counts gives the supports, and the
              survivors are compacted on each rank's own slice.
  grid        pairs over ``class`` and words over ``data`` of a 2D mesh:
              K3 on each (class block x word slice) tile, one all-reduce
              over ``data`` only, then supports and survivor rows
              all-gathered over ``class``.

Axis ownership, as in the reference: ``device_of_pair`` routes over the
backend's *pair* axis (``n_devices`` wide: the class axis for
``sharded``/``grid``, trivial for the rest); ``prepare_frontier`` owns the
*word* axis (a rank's slice for ``tidsharded``/``grid``, identity
otherwise).  Word-sharded engines take in :meth:`Engine.expand` only
frontiers that :meth:`prepare_frontier` or :meth:`adopt_frontier` (a slice
cut elsewhere, such as the streaming miner's ring) or an earlier expand
produced.

Survivor compaction (``compact``, the reference's knob): by default it
runs inside the intersection call (K2, or K2's given-mask front end after
K3), so only the ``(Q,)`` mask and supports cross to the host.  With
``compact=False`` the reference's two-step path runs instead: K1 (K3 with
its store on the word-sharded backends) writes the whole ``(Q, W)`` block,
the mask comes to the host, and a row gather of the survivors follows
(:meth:`Engine._compact`); the survivors and supports are the compacting
path's bit for bit.

Tile selection and dispatch (DESIGN.md §6): ``block_w`` names the word
tile of whichever fused-intersect kernel an expansion launches
(``kernels.autotune``): K2's, the words one pair's lanes cover per step;
K1's and K3's, the words of a row their windows stage at once (the plan's
chunk); ``None`` = the autotune table's pick, else the kernel's rule.
``autotune`` measures a shape class's tiles on the card before its first
launch (tune on a miss), for every one of K1, K2 and K3 that the engine
launches.  ``resolve_engine("auto", hints=...)`` picks the
backend from the crossover table ``launch.kerneltune`` measured
(:class:`DispatchPolicy`).

Pair batches are padded up to a half-power-of-two ladder
(``bucket_min`` x {1, 1.5, 2, 3, 4, 6, ...}), which caps padding waste at
~33% and keeps the set of batch shapes small; survivor blocks are padded the
same way from the ``compact_min`` floor.  The ladder, the padding rows and
``stats()["pair_padding"]`` match the reference package's engine.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ..device import words_to_numpy
from ..dist import collectives as coll
from ..dist.sharding import (axis_index, axis_size, mesh_descriptor,
                             padded_word_count, shard_words)
from ..kernels import autotune as at
from ..kernels.fused_intersect import (MODE_DIFFSET, MODE_TID_TO_DIFF,
                                       MODE_TIDSET, compact_survivors,
                                       compact_survivors_ref, fused_intersect,
                                       fused_intersect_compact,
                                       fused_intersect_compact_ref,
                                       fused_intersect_partial,
                                       fused_intersect_partial_ref,
                                       fused_intersect_ref)

__all__ = [
    "MODE_TIDSET", "MODE_TID_TO_DIFF", "MODE_DIFFSET",
    "LevelResult", "Engine", "EngineState", "RefEngine", "FusedEngine",
    "ShardedEngine",
    "TidShardedEngine", "GridShardedEngine", "BACKENDS",
    "available_backends", "make_engine", "resolve_engine", "bucket_size",
    "PairBuffers", "group_pairs_by_device", "engine_from_state",
    "DispatchPolicy", "KERNELTUNE_ENV", "PORT_BLOCK_WS",
]

MESH_BACKENDS = ("sharded", "tidsharded", "grid")
INNER = ("ref", "fused")
# every word tile K2 has, for rows of 16-byte and of 4-byte elements, and
# every chunk K1's and K3's windows are offered
PORT_BLOCK_WS = sorted(set(at.kernel_block_ws(4)) | set(at.kernel_block_ws(1))
                       | set(at.window_block_ws()))


@dataclasses.dataclass
class LevelResult:
    """One level expansion, already min-support filtered.

    mask:     (Q,) bool — which input pairs survived, in input pair order.
    supports: (S,) int64 — supports of the survivors (S = mask.sum()).
    bitmaps:  (Sb, W) int32 tensor on the frontier's device — survivor
              tidsets/diffsets on a ladder rung Sb >= S.  Rows [:S] are the
              survivors in mask order; rows [S:] are padding and must not be
              read.
    """

    mask: np.ndarray
    supports: np.ndarray
    bitmaps: torch.Tensor


@dataclasses.dataclass
class EngineState:
    """Serializable engine state (DESIGN.md §10): config + accounting as
    *data*, never Python object innards; the reference's fields.

    What is data: the knobs a rebuild needs (backend, inner executor,
    ladder floors) and the accounting ledgers that must survive a crash so
    per-slide ``stats(since=...)`` deltas stay truthful after recovery.
    What is derived (and therefore absent): pair buffers and the mesh's
    process groups, rebuilt by :func:`engine_from_state` under whatever mesh
    the restoring process brings.  ``mesh`` is the provenance descriptor of
    the mesh the snapshot ran on; it is reported, never restored from.

    ``block_w``, ``autotune``, ``compact`` and ``interpret`` are the
    reference's kernel knobs.  The port's engines carry ``block_w`` (one of
    K2's word tiles or K1's and K3's chunks, :data:`PORT_BLOCK_WS`),
    ``autotune`` and ``compact``, and hold ``interpret`` at None; a state
    the port cannot run as recorded is refused on restore
    (:meth:`check_portable`).
    """
    backend: str
    inner: str
    bucket_min: int
    compact_min: int
    block_w: Optional[int]
    compact: bool
    autotune: bool
    interpret: Optional[bool]
    mesh: Optional[dict]                      # mesh_descriptor provenance
    n_intersections: int
    n_padded: int
    level_padding: List[Tuple[int, int]]
    device_pair_counts: List[np.ndarray]

    def to_tree(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """(array tree, JSON-able extra) for ``training.checkpoint``."""
        tree: Dict[str, np.ndarray] = {
            "level_padding": np.asarray(self.level_padding,
                                        np.int64).reshape(-1, 2),
        }
        if self.device_pair_counts:
            tree["device_pair_counts"] = np.stack(
                [np.asarray(c, np.int64) for c in self.device_pair_counts])
        extra = {"backend": self.backend, "inner": self.inner,
                 "bucket_min": int(self.bucket_min),
                 "compact_min": int(self.compact_min),
                 "block_w": None if self.block_w is None else int(self.block_w),
                 "compact": bool(self.compact),
                 "autotune": bool(self.autotune),
                 "interpret": self.interpret, "mesh": self.mesh,
                 "n_intersections": int(self.n_intersections),
                 "n_padded": int(self.n_padded)}
        return tree, extra

    @classmethod
    def from_tree(cls, tree: Dict[str, np.ndarray], extra: dict) -> "EngineState":
        lp = np.asarray(tree["level_padding"], np.int64).reshape(-1, 2)
        dpc = tree.get("device_pair_counts")
        return cls(
            backend=str(extra["backend"]), inner=str(extra["inner"]),
            bucket_min=int(extra["bucket_min"]),
            compact_min=int(extra["compact_min"]),
            block_w=(None if extra["block_w"] is None
                     else int(extra["block_w"])),
            compact=bool(extra["compact"]), autotune=bool(extra["autotune"]),
            interpret=extra["interpret"], mesh=extra["mesh"],
            n_intersections=int(extra["n_intersections"]),
            n_padded=int(extra["n_padded"]),
            level_padding=[(int(a), int(b)) for a, b in lp],
            device_pair_counts=([np.asarray(c, np.int64) for c in dpc]
                                if dpc is not None else []))

    def check_portable(self) -> None:
        """Refuse, by field, a state this port cannot run as recorded: its
        ``block_w`` names one of K2's word tiles or K1's and K3's chunks,
        not a Pallas tile width."""
        _check_block_w(self.block_w, "EngineState.block_w")


def _check_block_w(block_w, what: str) -> None:
    if block_w is not None and int(block_w) not in PORT_BLOCK_WS:
        raise ValueError(
            f"{what}={block_w!r} is not a word tile of the port's fused "
            f"kernels; their tiles are {PORT_BLOCK_WS} (K2's, the words a "
            f"pair's lanes cover a step, and K1's and K3's, the words of a row "
            f"staged at once; which of them a launch takes depends on the "
            f"row's width)")


def bucket_size(n: int, floor: int) -> int:
    """Smallest ladder rung >= n (>= floor): ``floor * {1, 1.5, 2, 3, 4,
    6, 8, ...}``, so a padded batch wastes at most ~33%."""
    b = max(int(floor), 1)
    while b < n:
        h = b + (b >> 1)
        if n <= h:
            return h
        b <<= 1
    return b


class PairBuffers:
    """Persistent bucket-ladder host buffers for padded pair batches: one
    ``(3, rung)`` int32 block per rung (rows: left, right, sup_left),
    refilled in place and uploaded to the device in one copy."""

    def __init__(self, floor: int):
        self.floor = max(int(floor), 1)
        self._rungs: Dict[int, np.ndarray] = {}

    def fill(self, left: np.ndarray, right: np.ndarray,
             sup_left: np.ndarray) -> Tuple[int, np.ndarray]:
        q = int(left.shape[0])
        qb = bucket_size(q, self.floor)
        block = self._rungs.get(qb)
        if block is None:
            block = np.zeros((3, qb), np.int32)
            self._rungs[qb] = block
        block[0, :q], block[1, :q], block[2, :q] = left, right, sup_left
        block[:, q:] = 0
        return qb, block


def group_pairs_by_device(
    left: np.ndarray,
    right: np.ndarray,
    sup_left: np.ndarray,
    device_of_pair: Optional[np.ndarray],
    n_devices: int,
    floor: int,
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Group candidate pairs by their pair-axis slot and pad every slot's
    block to a shared ladder rung (the reference's function).

    Returns ``(qmax, lpad, rpad, spad, slot_of_pair, counts)``: the
    ``(n_devices, qmax)`` pad blocks hold each rank's pairs in input order,
    ``slot_of_pair[q] = dev * qmax + slot`` maps input pair order to
    padded-block position, and ``counts`` is the per-rank pair load.
    Out-of-range device ids are refused up front: one would leave its
    ``slot_of_pair`` entry unset and the supports silently wrong.
    """
    q = int(left.shape[0])
    d = int(n_devices)
    if device_of_pair is None:
        device_of_pair = np.zeros(q, np.int64)
    device_of_pair = np.asarray(device_of_pair, np.int64)
    if device_of_pair.shape != (q,):
        raise ValueError(f"device_of_pair must be shape ({q},), got "
                         f"{device_of_pair.shape}")
    if (device_of_pair < 0).any() or (device_of_pair >= d).any():
        bad = device_of_pair[(device_of_pair < 0) | (device_of_pair >= d)]
        raise ValueError(
            f"device_of_pair contains ids outside [0, {d}) for this "
            f"{d}-device pair axis: {np.unique(bad).tolist()[:8]}")
    order = np.argsort(device_of_pair, kind="stable")
    counts = np.bincount(device_of_pair, minlength=d)
    qmax = bucket_size(int(counts.max()), floor)
    lpad = np.zeros((d, qmax), np.int32)
    rpad = np.zeros((d, qmax), np.int32)
    spad = np.zeros((d, qmax), np.int32)
    # every slot is written by the grouping loop below — the range check
    # above refuses the one id class that could leave a hole
    slot_of_pair = np.empty(q, np.int64)  # staticcheck: disable=RS002
    off = 0
    for dev in range(d):
        c = int(counts[dev])
        idx = order[off: off + c]
        lpad[dev, :c] = left[idx]
        rpad[dev, :c] = right[idx]
        spad[dev, :c] = sup_left[idx]
        slot_of_pair[idx] = dev * qmax + np.arange(c)
        off += c
    return qmax, lpad, rpad, spad, slot_of_pair, counts


class Engine:
    """Backend interface + shared accounting.

    The survivor compaction runs inside the intersection call, so on the
    card nothing returns to the host before it.  ``compact_min`` is the
    floor of the survivor ladder, separate from the pair floor because
    survivor counts collapse at deep levels.  ``n_devices`` is the width of
    the pair axis that ``device_of_pair`` routes over (1 but for the
    pair-distributing mesh backends).

    Kernel knobs, shared by every backend (``EclatConfig`` /
    ``StreamConfig`` thread them through :func:`resolve_engine`):

    ``block_w``   the word tile of each fused-intersect kernel launched:
                  K2's (``kernels.autotune.kernel_block_ws`` of the
                  frontier's width; another value raises ``ValueError`` at
                  the first expansion), and the chunk of K1's and K3's
                  window plan (``kernels.autotune.plan_for_block_w``; one of
                  at least the row's width stages whole rows); ``None`` =
                  the autotune table's pick for the shape, else the
                  kernel's rule.
    ``autotune``  tune on a miss: before the first launch of a shape class
                  the table has no entry for, time its tiles and store the
                  winner (:meth:`_maybe_tune`, :meth:`tune_cooccurrence`):
                  K2's lanes, K1's and K3's plans (K3 at the rank's slice
                  width).  Only an engine whose executor is ``fused``
                  tunes, and an explicit ``block_w`` overrides the table.
    ``compact``   compact the survivors inside the intersection call (K2;
                  default), or, ``False``, the reference's two steps: the
                  whole block (K1, or K3 with its store), the mask on the
                  host, then a row gather (:meth:`_compact`).  Both give
                  the same survivors, supports and padding rows.
    """

    name = "abstract"
    n_devices = 1

    def __init__(self, bucket_min: int = 128, *,
                 compact_min: int | None = None,
                 block_w: Optional[int] = None, autotune: bool = False,
                 compact: bool = True):
        _check_block_w(block_w, "block_w")
        self.buffers = PairBuffers(bucket_min)
        self.compact_min = (min(self.buffers.floor, 128)
                            if compact_min is None else max(int(compact_min), 1))
        self.block_w = None if block_w is None else int(block_w)
        self.autotune = bool(autotune)
        self.compact = bool(compact)
        self.n_intersections = 0
        self.n_padded = 0
        self.level_padding: List[Tuple[int, int]] = []
        self.device_pair_counts: List[np.ndarray] = []

    # the device functions a backend supplies: the intersection with its
    # survivor compaction (K2), and without it (K1)
    @staticmethod
    def _intersect_compact(bitmaps, left, right, sup_left, min_sup, n_valid,
                           *, mode, lanes=None):
        raise NotImplementedError

    @staticmethod
    def _intersect(bitmaps, left, right, sup_left, min_sup, *, mode, plan=None):
        raise NotImplementedError

    @property
    def executor(self) -> str:
        """The single-device executor that runs the kernels: ``fused`` or
        ``ref`` (a mesh backend's inner one)."""
        return getattr(self, "inner", self.name)

    def _lanes(self, w: int) -> Optional[int]:
        """K2's lanes per pair for ``w``-word rows: ``block_w``'s, or None
        (the table's pick, else the rule)."""
        return None if self.block_w is None else at.lanes_for_block_w(w, self.block_w)

    def _plan(self, kernel: str, q: int, w: int, mode: int,
              device) -> Optional[tuple]:
        """K1's (``kernel="pairs"``) or K3's (``"partial"``) plan for ``q``
        pairs of ``w``-word rows: the one ``block_w`` names as its chunk, or
        None (the table's plan, else the rule)."""
        if self.block_w is None:
            return None
        return tuple(at.plan_for_block_w(kernel, q, w, mode, self.block_w,
                                         at.device_kind(device))[:3])

    def _maybe_tune(self, bitmaps: torch.Tensor, q: int, mode: int,
                    kernels: Tuple[str, ...]) -> None:
        """Tune on a miss: time the tiles of each of ``kernels``
        (``"compact"``: K2's lanes; ``"pairs"``, ``"partial"``: K1's and
        K3's plans) for ``q`` pairs over a frontier of the shape of
        ``bitmaps`` before the shape class's first launch, so the launch's
        table lookup hits.  No-op unless ``autotune`` is on, no explicit
        ``block_w`` overrides it and the executor is ``fused``.  K3 is
        timed with its store where the engine stores (``compact=False``)."""
        if (not self.autotune or self.block_w is not None
                or self.executor != "fused"):
            return
        p, w = bitmaps.shape
        for kernel in kernels:
            if at.table_config(kernel, q, w, mode, bitmaps.device) is None:
                at.tune_shape(kernel, q, w, mode, device=bitmaps.device,
                              rows=p, reps=10,
                              store=kernel != "partial" or not self.compact)

    def tune_cooccurrence(self, bitmaps: torch.Tensor) -> None:
        """Tune on a miss for the co-occurrence kernel (K4) at the shape of
        ``bitmaps``, before the miner counts it; the same conditions as
        :meth:`_maybe_tune`."""
        if not self.autotune or self.executor != "fused":
            return
        n, w = bitmaps.shape
        if n and at.table_config("trimatrix", n, w, 0, bitmaps.device) is None:
            at.tune_shape("trimatrix", n, w, device=bitmaps.device, reps=10)

    def _record_padding(self, q: int, padded: int) -> None:
        self.n_padded += padded - q
        self.level_padding.append((int(q), int(padded)))

    @staticmethod
    def _check_pairs(bitmaps: torch.Tensor, left: np.ndarray,
                     right: np.ndarray) -> None:
        # the CUDA kernels gather rows without bounds checks
        p = int(bitmaps.shape[0])
        if (min(left.min(), right.min()) < 0
                or max(left.max(), right.max()) >= p):
            raise ValueError(f"pair indices outside the {p}-row frontier")

    def prepare_frontier(self, bitmaps: torch.Tensor) -> torch.Tensor:
        """The frontier as this backend carries it (identity here; a rank's
        word slice for the word-sharded backends).  Drivers call it once on
        the level-1 frontier."""
        return bitmaps

    def adopt_frontier(self, local: torch.Tensor, n_words: int) -> torch.Tensor:
        """Take a frontier of ``n_words`` words that is already held the way
        this backend carries it (the streaming miner's ring is born that
        way), without cutting or copying it: identity here, where that is
        the whole frontier."""
        if local.shape[1] != int(n_words):
            raise ValueError(f"the {self.name} backend carries whole frontiers "
                             f"of {n_words} words, got shape {tuple(local.shape)}")
        return local

    def expand(self, bitmaps: torch.Tensor, left: np.ndarray,
               right: np.ndarray, sup_left: np.ndarray, *, mode: int,
               min_sup: int,
               device_of_pair: Optional[np.ndarray] = None) -> LevelResult:
        """Intersect all (left[q], right[q]) frontier-row pairs, threshold at
        ``min_sup``, and return the device-compacted survivors.
        ``device_of_pair`` routes pairs over a mesh backend's pair axis; a
        single-device backend ignores it."""
        q = int(left.shape[0])
        if q == 0:
            return self._empty(bitmaps)
        self._check_pairs(bitmaps, left, right)
        w = int(bitmaps.shape[1])
        qb = bucket_size(q, self.buffers.floor)
        if self.compact:
            tile = dict(lanes=self._lanes(w))
        else:
            tile = dict(plan=self._plan("pairs", qb, w, mode, bitmaps.device))
        self.n_intersections += q
        qb, block = self.buffers.fill(left, right, sup_left)
        self._record_padding(q, qb)
        self._maybe_tune(bitmaps, qb, mode, ("compact",) if self.compact else ("pairs",))
        # staticcheck: sync=engine.pairs_upload
        lrs = torch.from_numpy(block).to(bitmaps.device)
        if self.compact:
            out, sup, mask_dev, _ = self._intersect_compact(
                bitmaps, lrs[0], lrs[1], lrs[2], int(min_sup), q, mode=mode,
                **tile)
        else:
            out, sup, mask_dev = self._intersect(
                bitmaps, lrs[0], lrs[1], lrs[2], int(min_sup), mode=mode,
                **tile)
        # the level's one read: the host builds the next level's pairs from it
        # staticcheck: disable=RS005 sync=engine.mask_supports
        host = torch.stack((mask_dev[:q], sup[:q])).cpu().numpy()
        mask = host[0].astype(bool)
        return LevelResult(mask=mask,
                           supports=host[1][mask].astype(np.int64),
                           bitmaps=self._survivors(out, mask))

    def _empty(self, bitmaps: torch.Tensor) -> LevelResult:
        return LevelResult(mask=np.zeros(0, bool),
                           supports=np.zeros(0, np.int64),
                           bitmaps=torch.zeros((0, bitmaps.shape[1]),
                                               dtype=torch.int32,
                                               device=bitmaps.device))

    def _slice_survivors(self, compact: torch.Tensor, n_surv: int) -> torch.Tensor:
        """Rung-slice a compacted block: rows ``[:n_surv]`` are the
        survivors and the padding beyond them duplicates row 0."""
        sb = bucket_size(max(int(n_surv), 1), self.compact_min)
        return compact[:sb]

    def _compact(self, block: torch.Tensor, sel: np.ndarray,
                 rows: Optional[int] = None) -> torch.Tensor:
        """The non-compacting path's survivors: rows ``sel`` of an
        uncompacted ``(Q, W)`` block, gathered in order and padded with row
        0 to the survivor rung (``rows``: to that many rows), the layout K2
        gives, so the two paths are interchangeable bit for bit (the
        reference's ``_compact``)."""
        n = bucket_size(max(int(sel.size), 1), self.compact_min) if rows is None else rows
        idx = np.zeros(n, np.int64)
        idx[:sel.size] = sel
        # staticcheck: sync=engine.gather_upload
        return self._take(block, torch.from_numpy(idx).to(block.device))

    def _survivors(self, out: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
        """The survivor block of a single-block expansion, ``mask`` the
        host mask of its ``q`` pairs: the rung slice of K2's compacted
        block, or the row gather of the uncompacted one."""
        if self.compact:
            return self._slice_survivors(out, int(mask.sum()))
        return self._compact(out, np.nonzero(mask)[0])

    def _rank_survivors(self, out: torch.Tensor, sups: np.ndarray, count: int,
                        min_sup: int) -> torch.Tensor:
        """This rank's survivors of a pair-distributed expansion, in slot
        order, as :meth:`_MeshEngine._assemble` takes them: ``out`` itself
        when compacting, else the gather of its rows whose support ``sups``
        (this rank's block, ``count`` of them real) reaches ``min_sup``,
        padded with row 0 to the block's length."""
        if self.compact:
            return out
        keep = (sups >= min_sup) & (np.arange(sups.size) < count)
        return self._compact(out, np.nonzero(keep)[0], rows=sups.size)

    def host_rows(self, bitmaps: torch.Tensor, n_rows: int) -> np.ndarray:
        """The first ``n_rows`` rows of a frontier this backend carries, whole
        (every word), as host ``uint32`` words: what a checkpoint of the
        frontier holds.  The word-sharded backends gather the slices (one
        all-gather over ``data``, on every rank)."""
        return words_to_numpy(bitmaps[:n_rows])

    def _take(self, block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Row gather behind the mesh backends' survivor assembly; rows stay
        on the rank, and a word slice stays the same slice."""
        return block.index_select(0, idx)

    def snapshot_state(self) -> EngineState:
        """Serializable snapshot of config + accounting (DESIGN.md §10).
        Deep-copies the ledgers so the snapshot is stable while the engine
        keeps expanding."""
        return EngineState(
            backend=self.name,
            inner=getattr(self, "inner",
                          self.name if self.name in INNER else "fused"),
            bucket_min=self.buffers.floor, compact_min=self.compact_min,
            block_w=self.block_w, compact=self.compact, autotune=self.autotune,
            interpret=None,
            mesh=mesh_descriptor(getattr(self, "mesh", None)),
            n_intersections=self.n_intersections, n_padded=self.n_padded,
            level_padding=[(int(a), int(b)) for a, b in self.level_padding],
            device_pair_counts=[np.asarray(c, np.int64).copy()
                                for c in self.device_pair_counts])

    def restore_state(self, state: EngineState) -> "Engine":
        """Adopt a snapshot's accounting.  Per-rank pair counts are kept only
        when this engine's pair axis has the snapshot's width: on another
        mesh factorization the old attribution means nothing, so it is
        dropped (derived accounting, not data; DESIGN.md §10)."""
        state.check_portable()
        self.n_intersections = int(state.n_intersections)
        self.n_padded = int(state.n_padded)
        self.level_padding = [(int(a), int(b)) for a, b in state.level_padding]
        dpc = [np.asarray(c, np.int64).copy()
               for c in state.device_pair_counts]
        if any(c.shape[0] != self.n_devices for c in dpc):
            dpc = []
        self.device_pair_counts = dpc
        return self

    def snapshot(self) -> Tuple[int, int, int, int]:
        """Counter snapshot, for per-call deltas on a long-lived engine
        (``stats(since=snapshot)``: the streaming miner reports each slide's
        work, not lifetime totals)."""
        return (self.n_intersections, self.n_padded,
                len(self.device_pair_counts), len(self.level_padding))

    def stats(self, since: Optional[Tuple[int, ...]] = None) -> dict:
        i0, p0, d0, l0 = (tuple(since) + (0,) * 4)[:4] if since else (0,) * 4
        out = {
            "backend": self.name,
            "n_intersections": self.n_intersections - i0,
            "n_padded": self.n_padded - p0,
        }
        levels = self.level_padding[l0:]
        if levels:
            tot_q = sum(q for q, _ in levels)
            tot_p = sum(p for _, p in levels)
            out["pair_padding"] = {
                "per_level": [
                    {"pairs": q, "padded_to": p,
                     "efficiency": q / p if p else 1.0}
                    for q, p in levels
                ],
                "efficiency": tot_q / tot_p if tot_p else 1.0,
            }
        if self.device_pair_counts[d0:]:
            per_dev = np.sum(self.device_pair_counts[d0:], axis=0)
            out["device_balance"] = {
                "pairs_per_device": per_dev.tolist(),
                "padding_efficiency": float(
                    per_dev.sum() / (per_dev.max() * per_dev.shape[0]))
                if per_dev.max() > 0 else 1.0,
            }
        return out


class RefEngine(Engine):
    """Plain torch executor: the semantics every backend matches."""

    name = "ref"
    _intersect_compact = staticmethod(fused_intersect_compact_ref)
    _intersect = staticmethod(fused_intersect_ref)


class FusedEngine(Engine):
    """The CUDA kernels for a frontier on the card (plain torch on the host):
    K2, or K1 with ``compact=False``."""

    name = "fused"
    _intersect_compact = staticmethod(fused_intersect_compact)
    _intersect = staticmethod(fused_intersect)


# ---------------------------------------------------------------------------
# mesh backends (one process per rank, DESIGN.md §7-8)
# ---------------------------------------------------------------------------

# inner executor -> (pair block with compaction, partial popcount,
# compaction from a given mask, pair block without compaction)
_INNER_FUNCS = {
    "fused": (fused_intersect_compact, fused_intersect_partial,
              compact_survivors, fused_intersect),
    "ref": (fused_intersect_compact_ref, fused_intersect_partial_ref,
            compact_survivors_ref, fused_intersect_ref),
}


class _MeshEngine(Engine):
    """What the mesh backends share: the mesh, the inner executor and the
    survivor assembly of the pair-distributing backends."""

    def __init__(self, mesh, bucket_min: int = 128, *, inner: str = "fused",
                 compact_min: int | None = None, **knobs):
        super().__init__(bucket_min, compact_min=compact_min, **knobs)
        if inner not in INNER:
            raise ValueError(f"unknown inner executor {inner!r}")
        self.mesh = mesh
        self.inner = inner
        (self._compact_block, self._partial, self._compact_rows,
         self._intersect) = _INNER_FUNCS[inner]

    def _assemble(self, sups: np.ndarray, block: torch.Tensor,
                  counts: np.ndarray, slot_of_pair: np.ndarray, min_sup: int,
                  axis: str) -> LevelResult:
        """The level result of a pair-distributed expansion, the same on
        every rank of ``axis``.  ``sups`` is the ``(d, qmax)`` stack of every
        rank's block supports (all-gathered); ``block`` this rank's
        compacted survivors, rows ``[:s_r]`` in slot order.  The survivor
        rows are all-gathered over ``axis`` and put in input pair order
        through ``slot_of_pair``, as the reference orders them; the rung
        padding gathers row 0 and must not be read."""
        d, qmax = sups.shape
        flags = (sups >= min_sup) & (np.arange(qmax)[None, :] < counts[:, None])
        mask = flags.reshape(-1)[slot_of_pair]
        sel = np.nonzero(mask)[0]
        supports = sups.reshape(-1)[slot_of_pair][sel].astype(np.int64)
        sb = bucket_size(max(sel.size, 1), self.compact_min)
        smax = int(flags.sum(axis=1).max())
        if smax == 0:
            return LevelResult(mask=mask, supports=supports, bitmaps=block[:sb])
        rows = coll.all_gather(block[:smax], self.mesh, axis)
        pos = np.cumsum(flags, axis=1) - 1
        dev, slot = np.divmod(slot_of_pair[sel], qmax)
        idx = np.zeros(sb, np.int64)
        idx[:sel.size] = dev * smax + pos[dev, slot]
        surv = self._take(rows.reshape(d * smax, -1),
                          # staticcheck: sync=mesh.survivor_upload
                          torch.from_numpy(idx).to(block.device))
        return LevelResult(mask=mask, supports=supports, bitmaps=surv)


class ShardedEngine(_MeshEngine):
    """Executor-task mapping: pairs grouped by the rank their class was
    partitioned to, padded per rank to a common rung, the frontier
    replicated.  Each rank runs the inner executor (the intersection with
    its survivor compaction, K2; with ``compact=False`` K1 and a gather of
    its survivor rows) on its block; the supports and the survivor rows
    are then all-gathered over the pair axis."""

    name = "sharded"

    def __init__(self, mesh, bucket_min: int = 128, axis: str = "data",
                 inner: str = "fused", *, compact_min: int | None = None,
                 **knobs):
        super().__init__(mesh, bucket_min, inner=inner, compact_min=compact_min,
                         **knobs)
        self.axis = axis
        self.n_devices = axis_size(mesh, axis)
        self.rank = axis_index(mesh, axis)

    def expand(self, bitmaps, left, right, sup_left, *, mode, min_sup,
               device_of_pair=None):
        q = int(left.shape[0])
        if q == 0:
            return self._empty(bitmaps)
        self._check_pairs(bitmaps, left, right)
        d, r = self.n_devices, self.rank
        qmax, lpad, rpad, spad, slot_of_pair, counts = group_pairs_by_device(
            left, right, sup_left, device_of_pair, d, self.buffers.floor)
        self.n_intersections += q
        self.device_pair_counts.append(counts)
        self._record_padding(q, d * qmax)
        w = int(bitmaps.shape[1])
        if self.compact:
            lanes = self._lanes(w)
        else:
            plan = self._plan("pairs", qmax, w, mode, bitmaps.device)
        self._maybe_tune(bitmaps, qmax, mode, ("compact",) if self.compact else ("pairs",))
        # staticcheck: sync=sharded.pairs_upload
        lrs = torch.from_numpy(np.stack((lpad[r], rpad[r], spad[r]))).to(bitmaps.device)
        if self.compact:
            out, sup, _, _ = self._compact_block(bitmaps, lrs[0], lrs[1], lrs[2],
                                                 int(min_sup), int(counts[r]),
                                                 mode=mode, lanes=lanes)
        else:
            out, sup, _ = self._intersect(bitmaps, lrs[0], lrs[1], lrs[2],
                                          int(min_sup), mode=mode, plan=plan)
        # every rank's supports, read once: the host assembles the level
        # staticcheck: disable=RS005 sync=sharded.supports_gather
        sups = coll.all_gather(sup, self.mesh, self.axis).cpu().numpy()
        out = self._rank_survivors(out, sups[r], int(counts[r]), min_sup)
        return self._assemble(sups, out, counts, slot_of_pair, min_sup, self.axis)


class _WordShardedFrontierMixin:
    """The word-axis (tid) half of a mesh backend: each rank carries its
    ``(P, ceil(W / n_data))`` slice of the frontier (zero-padded to a
    multiple of ``n_data`` words), replicated over any other mesh axis, and
    keeps it across levels: survivor rows are compacted out of the rank's
    own slice, so the next frontier is born sharded.

    ``prepare_frontier`` cuts a full frontier to this
    rank's slice and ``adopt_frontier`` takes a slice already cut that way
    (the streaming miner's ring); ``expand`` then takes only such slices
    (and the frontiers it returned) and refuses a frontier of another
    width.  Supports need
    the counts of every slice: K3 (``fused_intersect_partial``) counts this
    slice, one all-reduce over the data axis sums them, and the support
    conversion and threshold follow on the reduced value."""

    def _init_word_axis(self, data_axis: str) -> None:
        self.data_axis = data_axis
        self.n_shards = axis_size(self.mesh, data_axis)
        self.n_words: Optional[int] = None          # of the prepared frontier
        self.frontier_words: Optional[int] = None   # this rank's slice

    def prepare_frontier(self, bitmaps: torch.Tensor) -> torch.Tensor:
        local = shard_words(bitmaps, self.mesh, self.data_axis)
        self.n_words, self.frontier_words = int(bitmaps.shape[1]), int(local.shape[1])
        return local

    def adopt_frontier(self, local: torch.Tensor, n_words: int) -> torch.Tensor:
        """Take this rank's slice of an ``n_words``-wide frontier that was cut
        elsewhere (``shard_words``'s width), not a second time: the slice is
        registered as the prepared frontier and returned as it is."""
        ws = padded_word_count(n_words, self.n_shards) // self.n_shards
        if local.ndim != 2 or local.shape[1] != ws:
            raise ValueError(
                f"the {self.name} backend carries this rank's {ws}-word slice "
                f"of a {n_words}-word frontier, got shape {tuple(local.shape)}")
        self.n_words, self.frontier_words = int(n_words), ws
        return local

    def host_rows(self, bitmaps: torch.Tensor, n_rows: int) -> np.ndarray:
        self._check_slice(bitmaps)
        parts = coll.all_gather(bitmaps[:n_rows], self.mesh, self.data_axis)
        whole = parts.permute(1, 0, 2).reshape(int(n_rows), -1)
        return words_to_numpy(whole[:, :self.n_words])

    def _check_slice(self, bitmaps: torch.Tensor) -> None:
        if self.frontier_words is None or bitmaps.shape[1] != self.frontier_words:
            raise ValueError(
                f"the {self.name} backend expands this rank's word slice of a "
                f"frontier (prepare_frontier first; slice width "
                f"{self.frontier_words}), got shape {tuple(bitmaps.shape)}")

    def _reduced_survivors(self, bitmaps, lrs, n_valid: int, mode: int,
                           min_sup: int):
        """K3 on this rank's slice, one all-reduce of the (Q,) counts over
        the data axis, then support, threshold and the compaction of this
        slice's survivor rows: ``(compact, sup, mask)``.  With
        ``compact=False`` K3 stores the slice's intersections and they come
        back uncompacted, with the mask of every pair (the caller gathers
        the survivors).  K3's plan and K2's lanes are each resolved at the
        slice width (an explicit ``block_w`` names K3's chunk and K2's
        tile), and each rank tunes its own slice with no collective."""
        l, r, s = lrs
        q, w = int(l.shape[0]), int(bitmaps.shape[1])
        plan = self._plan("partial", q, w, mode, bitmaps.device)
        lanes = self._lanes(w) if self.compact else None
        self._maybe_tune(bitmaps, q, mode,
                         ("partial", "compact") if self.compact else ("partial",))
        inter, pop = self._partial(bitmaps, l, r, mode=mode, store=not self.compact,
                                   plan=plan)
        total = coll.all_reduce(pop, self.mesh, self.data_axis)
        sup = total if mode == MODE_TIDSET else s - total
        mask = (sup >= int(min_sup)).to(torch.int32)
        if not self.compact:
            return inter, sup, mask
        out, mask, _ = self._compact_rows(bitmaps, l, r, mask, int(n_valid),
                                          mode=mode, lanes=lanes)
        return out, sup, mask


class TidShardedEngine(_WordShardedFrontierMixin, _MeshEngine):
    """Word-sharded executor: every rank intersects and counts every pair on
    its slice of the words, so its frontier memory is 1/n_data of the
    whole while its pair work is unchanged.  Only the (Q,) count vector
    crosses ranks, in one all-reduce; the survivor rows are compacted on
    each rank's own slice (the post-reduce mask is the same on every rank,
    so every rank keeps the same rows, in global pair order)."""

    name = "tidsharded"

    def __init__(self, mesh, bucket_min: int = 128, axis: str = "data",
                 inner: str = "fused", *, compact_min: int | None = None,
                 **knobs):
        super().__init__(mesh, bucket_min, inner=inner, compact_min=compact_min,
                         **knobs)
        self._init_word_axis(axis)

    def stats(self, since=None) -> dict:
        out = super().stats(since=since)
        out["n_word_shards"] = self.n_shards
        out["frontier_words"] = self.frontier_words
        return out

    def expand(self, bitmaps, left, right, sup_left, *, mode, min_sup,
               device_of_pair=None):
        q = int(left.shape[0])
        if q == 0:
            return self._empty(bitmaps)
        self._check_slice(bitmaps)
        self._check_pairs(bitmaps, left, right)
        self.n_intersections += q
        qb, block = self.buffers.fill(left, right, sup_left)
        self._record_padding(q, qb)
        # staticcheck: sync=tidsharded.pairs_upload
        lrs = torch.from_numpy(block).to(bitmaps.device)
        out, sup, mask = self._reduced_survivors(bitmaps, lrs, q, mode, min_sup)
        # the level's one read after the all-reduce, as on one device
        # staticcheck: disable=RS005 sync=tidsharded.mask_supports
        host = torch.stack((mask[:q], sup[:q])).cpu().numpy()
        m = host[0].astype(bool)
        return LevelResult(mask=m, supports=host[1][m].astype(np.int64),
                           bitmaps=self._survivors(out, m))


class GridShardedEngine(_WordShardedFrontierMixin, _MeshEngine):
    """Grid executor on a 2D ``("class", "data")`` mesh: pairs grouped by
    partitioned class over ``class`` (as :class:`ShardedEngine`), the
    frontier's words over ``data`` (as :class:`TidShardedEngine`), so each
    rank runs K3 on one (class block x word slice) tile.  The counts are
    all-reduced over ``data`` only: class blocks hold disjoint pairs whose
    counts must never mix.  Each rank compacts its class block's survivors
    on its slice, and the supports and survivor rows are all-gathered over
    ``class``: the next frontier is replicated over ``class`` and
    word-sharded over ``data``."""

    name = "grid"

    def __init__(self, mesh, bucket_min: int = 128, class_axis: str = "class",
                 data_axis: str = "data", inner: str = "fused", *,
                 compact_min: int | None = None, **knobs):
        names = tuple(mesh.mesh_dim_names or ())
        missing = [a for a in (class_axis, data_axis) if a not in names]
        if missing:
            raise ValueError(
                f"grid backend needs a 2D ({class_axis!r}, {data_axis!r}) "
                f"mesh (launch.mesh.make_grid_mesh); this mesh has axes "
                f"{names}")
        super().__init__(mesh, bucket_min, inner=inner, compact_min=compact_min,
                         **knobs)
        self._init_word_axis(data_axis)
        self.class_axis = class_axis
        self.n_class = axis_size(mesh, class_axis)
        self.class_index = axis_index(mesh, class_axis)
        # drivers route partition -> rank over the pair (class) axis
        self.n_devices = self.n_class

    def stats(self, since=None) -> dict:
        out = super().stats(since=since)
        out["n_class_shards"] = self.n_class
        out["n_word_shards"] = self.n_shards
        out["grid"] = [self.n_class, self.n_shards]
        out["frontier_words"] = self.frontier_words
        return out

    def expand(self, bitmaps, left, right, sup_left, *, mode, min_sup,
               device_of_pair=None):
        q = int(left.shape[0])
        if q == 0:
            return self._empty(bitmaps)
        self._check_slice(bitmaps)
        self._check_pairs(bitmaps, left, right)
        d, c = self.n_class, self.class_index
        qmax, lpad, rpad, spad, slot_of_pair, counts = group_pairs_by_device(
            left, right, sup_left, device_of_pair, d, self.buffers.floor)
        self.n_intersections += q
        self.device_pair_counts.append(counts)
        self._record_padding(q, d * qmax)
        # staticcheck: sync=grid.pairs_upload
        lrs = torch.from_numpy(np.stack((lpad[c], rpad[c], spad[c]))).to(bitmaps.device)
        out, sup, _ = self._reduced_survivors(bitmaps, lrs, int(counts[c]),
                                              mode, min_sup)
        # every class block's supports, read once, as the sharded backend's
        # staticcheck: disable=RS005 sync=grid.supports_gather
        sups = coll.all_gather(sup, self.mesh, self.class_axis).cpu().numpy()
        out = self._rank_survivors(out, sups[c], int(counts[c]), min_sup)
        return self._assemble(sups, out, counts, slot_of_pair, min_sup,
                              self.class_axis)


BACKENDS: Dict[str, Type[Engine]] = {
    "ref": RefEngine, "fused": FusedEngine, "sharded": ShardedEngine,
    "tidsharded": TidShardedEngine, "grid": GridShardedEngine}


def available_backends() -> List[str]:
    return sorted(BACKENDS)


def make_engine(backend: str, *, mesh=None, bucket_min: int = 128,
                inner: str = "fused", block_w: Optional[int] = None,
                autotune: bool = False, compact: bool = True) -> Engine:
    """Construct a backend by name; the mesh backends need a mesh (``grid``
    a 2D ``("class", "data")`` one) and run ``inner`` on each rank.
    ``block_w`` / ``autotune`` / ``compact`` are the kernel knobs every
    backend takes (:class:`Engine`).  ``auto`` and ``batched`` are names of
    :func:`resolve_engine`, not backends, as in the reference."""
    cls = BACKENDS.get(backend)
    if cls is None:
        raise ValueError(f"unknown engine backend {backend!r}; "
                         f"available: {available_backends()}")
    knobs = dict(block_w=block_w, autotune=autotune, compact=compact)
    if backend in MESH_BACKENDS:
        if mesh is None:
            raise ValueError(f"{backend} backend requires a mesh")
        return cls(mesh, bucket_min, inner=inner, **knobs)
    return cls(bucket_min, **knobs)


def engine_from_state(state: EngineState, mesh=None, *,
                      backend: Optional[str] = None) -> Engine:
    """Rebuild an engine from an :class:`EngineState`, possibly on a
    different mesh — the engine half of live re-meshing (DESIGN.md §10).

    The snapshot's mesh descriptor is provenance only: the engine is built
    against ``mesh`` (whatever factorization the restoring process brings),
    and a mesh backend's state with ``mesh=None`` falls back to its inner
    executor on one device.  ``backend`` overrides the target outright
    (a cross-family move, e.g. ``sharded`` -> ``tidsharded``).  The state's
    ``block_w``, ``autotune`` and ``compact`` carry over."""
    state.check_portable()
    target = state.backend if backend is None else backend
    if target in MESH_BACKENDS and mesh is None:
        target = state.inner if state.inner in INNER else "fused"
    eng = make_engine(target, mesh=mesh if target in MESH_BACKENDS else None,
                      bucket_min=state.bucket_min,
                      inner=state.inner if state.inner in INNER else "fused",
                      block_w=state.block_w, autotune=state.autotune,
                      compact=state.compact)
    eng.compact_min = int(state.compact_min)
    return eng.restore_state(state)


# the crossover table launch.kerneltune measures: REPRO_TORCH_KERNELTUNE_TABLE,
# else BENCH_torch_kerneltune.json in the working directory, then at the
# repository's root (never the reference's REPRO_KERNELTUNE_TABLE or
# BENCH_kerneltune.json, whose cells are another package's backends on the CPU)
KERNELTUNE_ENV = "REPRO_TORCH_KERNELTUNE_TABLE"
KERNELTUNE_FILE = "BENCH_torch_kerneltune.json"


def _default_policy_paths() -> List[str]:
    paths = []
    env = os.environ.get(KERNELTUNE_ENV)
    if env:
        paths.append(env)
    paths.append(os.path.join(os.getcwd(), KERNELTUNE_FILE))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    paths.append(os.path.join(root, KERNELTUNE_FILE))
    return paths


class DispatchPolicy:
    """Backend choice from measured crossovers (the reference's class).

    ``launch.kerneltune`` times the ``ref`` and ``fused`` backends' expand
    over a Q x W grid and records each cell's winner
    (``BENCH_torch_kerneltune.json["crossover"]``: ``best_single``, and
    ``best_mesh``, null where no mesh was measured).  :meth:`choose` answers
    "which backend for an expansion of about q pairs over w words?" by the
    nearest measured cell in (log2 q, log2 w).  A missing, unreadable or
    empty table loads as ``None``, and ``resolve_engine("auto")`` falls
    back to the default; so does a table measured on another card than
    ``kind`` (its ``device``), whose crossovers say nothing of this one."""

    def __init__(self, cells: List[dict], source: Optional[str] = None):
        self.cells = [c for c in cells
                      if "q" in c and "w" in c and c.get("best_single")]
        self.source = source

    @classmethod
    def load(cls, path: Optional[str] = None,
             kind: Optional[str] = None) -> Optional["DispatchPolicy"]:
        """The first readable table of ``path`` (else the default paths)
        with cells, measured on ``kind`` (``None``: on any device)."""
        for p in ([path] if path else _default_policy_paths()):
            try:
                with open(p) as f:
                    data = json.load(f)
                cells = data.get("crossover", [])
                device = data.get("device")
            except (OSError, ValueError, AttributeError):
                continue
            if kind is not None and device is not None and device != kind:
                continue
            if cells:
                policy = cls(cells, source=p)
                if policy.cells:
                    return policy
        return None

    def choose(self, q: int, w: int, *, have_mesh: bool = False) -> str:
        """The measured best backend for a ~(q pairs, w words) expansion;
        with a mesh the cell's ``best_mesh`` winner, or its single-device
        one where none was measured."""
        lq, lw = np.log2(max(int(q), 1)), np.log2(max(int(w), 1))

        def dist(c):
            return ((np.log2(max(int(c["q"]), 1)) - lq) ** 2
                    + (np.log2(max(int(c["w"]), 1)) - lw) ** 2)

        cell = min(self.cells, key=dist)
        if have_mesh:
            return cell.get("best_mesh") or cell["best_single"]
        return cell["best_single"]


def _on_card(device, mesh) -> bool:
    """Whether an engine for ``device`` (else ``mesh``'s devices; ``None``
    is CUDA, the port's default) runs on a card."""
    if device is not None:
        return torch.device(device).type == "cuda"
    return mesh is None or mesh.device_type == "cuda"


def resolve_engine(backend: str, mesh=None, *, bucket_min: int = 128,
                   shard: str = "pairs", block_w: Optional[int] = None,
                   autotune: bool = False, compact: bool = True,
                   auto: Optional[bool] = None,
                   hints: Optional[Tuple[int, int]] = None,
                   policy_path: Optional[str] = None,
                   device=None) -> Engine:
    """Map a (backend name, mesh, shard mode) request onto an engine, with
    the reference's routing and errors.

    A mesh always means a mesh backend, with the named single-device
    backend (``ref`` or ``fused``) as its inner executor; ``shard`` picks
    the split: ``"pairs"`` (sharded), ``"words"`` (tidsharded) or
    ``"grid"``.  Naming a mesh backend implies its shard mode; combining it
    with a different non-default ``shard`` is refused.  A mesh backend
    without a mesh is the single-device default (``fused``), as in the
    reference.

    **Measured dispatch**: ``backend="auto"`` (or ``auto=True``) picks the
    backend nearest the measured winner of :class:`DispatchPolicy`'s table
    for ``hints=(pairs, words)``, the miner's estimate of its dominant
    expansion; under ``auto`` a mesh backend it picks overrides ``shard``.
    With ``device`` only a table measured on its card (or one that names
    no card) answers.  On a card (``device`` CUDA, or ``None``) ``auto``
    never picks ``ref``, the plain version: a cell won by it keeps the
    kernels' ``fused``.  No table, no hints or an unknown winner resolve to
    the default,
    ``fused`` (``"batched"`` is the reference's alias for it).
    ``engine.dispatch`` records what was asked and which table answered.
    ``block_w`` / ``autotune`` / ``compact`` go to whichever engine wins."""
    shard_to_backend = {"pairs": "sharded", "words": "tidsharded",
                        "grid": "grid"}
    if shard not in shard_to_backend:
        raise ValueError(f"unknown shard mode {shard!r}; "
                         "expected 'pairs', 'words' or 'grid'")
    requested = backend
    auto = (backend == "auto") if auto is None else bool(auto)
    if backend in ("batched", "auto"):
        backend = "fused"
    policy = None
    if auto:
        policy = DispatchPolicy.load(
            policy_path, kind=None if device is None else at.device_kind(device))
        if policy is not None and hints is not None:
            choice = policy.choose(*hints, have_mesh=mesh is not None)
            # on the card auto picks only engines that launch the kernels:
            # the plain version runs there only when it is named
            if choice in BACKENDS and not (choice == "ref"
                                           and _on_card(device, mesh)):
                backend = choice
    knobs = dict(bucket_min=bucket_min, block_w=block_w, autotune=autotune,
                 compact=compact)
    if backend not in BACKENDS:
        return make_engine(backend, **knobs)  # raises
    implied = {"sharded": "pairs", "tidsharded": "words",
               "grid": "grid"}.get(backend)
    if implied is not None:
        # shard="pairs" is the config default, so only an explicit
        # disagreement is a conflict — except under auto, where the policy
        # (not the user) picked the backend and overrides the shard
        if not auto and shard not in ("pairs", implied):
            raise ValueError(
                f"backend {backend!r} implies shard={implied!r} but "
                f"shard={shard!r} was requested; drop one of the two")
        shard = implied
    if mesh is None:
        engine = make_engine("fused" if implied else backend, **knobs)
    else:
        inner = backend if backend in INNER else "fused"
        engine = make_engine(shard_to_backend[shard], mesh=mesh, inner=inner,
                             **knobs)
    engine.dispatch = {"requested": requested, "auto": auto,
                       "policy": policy.source if policy else None}
    return engine
