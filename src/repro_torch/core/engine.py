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

Pair batches are padded up to a half-power-of-two ladder
(``bucket_min`` x {1, 1.5, 2, 3, 4, 6, ...}), which caps padding waste at
~33% and keeps the set of batch shapes small; survivor blocks are padded the
same way from the ``compact_min`` floor.  The ladder, the padding rows and
``stats()["pair_padding"]`` match the reference package's engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ..dist import collectives as coll
from ..dist.sharding import axis_index, axis_size, padded_word_count, shard_words
from ..kernels.fused_intersect import (MODE_DIFFSET, MODE_TID_TO_DIFF,
                                       MODE_TIDSET, compact_survivors,
                                       compact_survivors_ref,
                                       fused_intersect_compact,
                                       fused_intersect_compact_ref,
                                       fused_intersect_partial,
                                       fused_intersect_partial_ref)

__all__ = [
    "MODE_TIDSET", "MODE_TID_TO_DIFF", "MODE_DIFFSET",
    "LevelResult", "Engine", "RefEngine", "FusedEngine", "ShardedEngine",
    "TidShardedEngine", "GridShardedEngine", "BACKENDS",
    "available_backends", "make_engine", "resolve_engine", "bucket_size",
    "PairBuffers", "group_pairs_by_device",
]

# backends of the reference package that this port does not have yet
UNPORTED_BACKENDS = ("auto", "batched")
MESH_BACKENDS = ("sharded", "tidsharded", "grid")
INNER = ("ref", "fused")


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
    slot_of_pair = np.empty(q, np.int64)  # every entry is written below
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
    """

    name = "abstract"
    n_devices = 1

    def __init__(self, bucket_min: int = 128, *,
                 compact_min: int | None = None):
        self.buffers = PairBuffers(bucket_min)
        self.compact_min = (min(self.buffers.floor, 128)
                            if compact_min is None else max(int(compact_min), 1))
        self.n_intersections = 0
        self.n_padded = 0
        self.level_padding: List[Tuple[int, int]] = []
        self.device_pair_counts: List[np.ndarray] = []

    # the device function a backend supplies
    @staticmethod
    def _intersect_compact(bitmaps, left, right, sup_left, min_sup, n_valid,
                           *, mode):
        raise NotImplementedError

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
        self.n_intersections += q
        qb, block = self.buffers.fill(left, right, sup_left)
        self._record_padding(q, qb)
        lrs = torch.from_numpy(block).to(bitmaps.device)
        out, sup, mask_dev, _ = self._intersect_compact(
            bitmaps, lrs[0], lrs[1], lrs[2], int(min_sup), q, mode=mode)
        host = torch.stack((mask_dev[:q], sup[:q])).cpu().numpy()
        mask = host[0].astype(bool)
        return LevelResult(mask=mask,
                           supports=host[1][mask].astype(np.int64),
                           bitmaps=self._slice_survivors(out, int(mask.sum())))

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

    def _take(self, block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Row gather behind the mesh backends' survivor assembly; rows stay
        on the rank, and a word slice stays the same slice."""
        return block.index_select(0, idx)

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


class FusedEngine(Engine):
    """The CUDA kernels for a frontier on the card (plain torch on the host)."""

    name = "fused"
    _intersect_compact = staticmethod(fused_intersect_compact)


# ---------------------------------------------------------------------------
# mesh backends (one process per rank, DESIGN.md §7-8)
# ---------------------------------------------------------------------------

# inner executor -> (pair block with compaction, partial popcount,
# compaction from a given mask)
_INNER_FUNCS = {
    "fused": (fused_intersect_compact, fused_intersect_partial,
              compact_survivors),
    "ref": (fused_intersect_compact_ref, fused_intersect_partial_ref,
            compact_survivors_ref),
}


class _MeshEngine(Engine):
    """What the mesh backends share: the mesh, the inner executor and the
    survivor assembly of the pair-distributing backends."""

    def __init__(self, mesh, bucket_min: int = 128, *, inner: str = "fused",
                 compact_min: int | None = None):
        super().__init__(bucket_min, compact_min=compact_min)
        if inner not in INNER:
            raise ValueError(f"unknown inner executor {inner!r}")
        self.mesh = mesh
        self.inner = inner
        self._compact_block, self._partial, self._compact_rows = _INNER_FUNCS[inner]

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
                          torch.from_numpy(idx).to(block.device))
        return LevelResult(mask=mask, supports=supports, bitmaps=surv)


class ShardedEngine(_MeshEngine):
    """Executor-task mapping: pairs grouped by the rank their class was
    partitioned to, padded per rank to a common rung, the frontier
    replicated.  Each rank runs the inner executor (the intersection with
    its survivor compaction, K2) on its block; the supports and the survivor rows are then
    all-gathered over the pair axis."""

    name = "sharded"

    def __init__(self, mesh, bucket_min: int = 128, axis: str = "data",
                 inner: str = "fused", *, compact_min: int | None = None):
        super().__init__(mesh, bucket_min, inner=inner, compact_min=compact_min)
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
        lrs = torch.from_numpy(np.stack((lpad[r], rpad[r], spad[r]))).to(bitmaps.device)
        out, sup, _, _ = self._compact_block(bitmaps, lrs[0], lrs[1], lrs[2],
                                             int(min_sup), int(counts[r]),
                                             mode=mode)
        sups = coll.all_gather(sup, self.mesh, self.axis).cpu().numpy()
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
        slice's survivor rows: ``(compact, sup, mask)``."""
        l, r, s = lrs
        _, pop = self._partial(bitmaps, l, r, mode=mode, store=False)
        total = coll.all_reduce(pop, self.mesh, self.data_axis)
        sup = total if mode == MODE_TIDSET else s - total
        mask = (sup >= int(min_sup)).to(torch.int32)
        out, mask, _ = self._compact_rows(bitmaps, l, r, mask, int(n_valid),
                                          mode=mode)
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
                 inner: str = "fused", *, compact_min: int | None = None):
        super().__init__(mesh, bucket_min, inner=inner, compact_min=compact_min)
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
        lrs = torch.from_numpy(block).to(bitmaps.device)
        out, sup, mask = self._reduced_survivors(bitmaps, lrs, q, mode, min_sup)
        host = torch.stack((mask[:q], sup[:q])).cpu().numpy()
        m = host[0].astype(bool)
        return LevelResult(mask=m, supports=host[1][m].astype(np.int64),
                           bitmaps=self._slice_survivors(out, int(m.sum())))


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
                 compact_min: int | None = None):
        names = tuple(mesh.mesh_dim_names or ())
        missing = [a for a in (class_axis, data_axis) if a not in names]
        if missing:
            raise ValueError(
                f"grid backend needs a 2D ({class_axis!r}, {data_axis!r}) "
                f"mesh (launch.mesh.make_grid_mesh); this mesh has axes "
                f"{names}")
        super().__init__(mesh, bucket_min, inner=inner, compact_min=compact_min)
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
        lrs = torch.from_numpy(np.stack((lpad[c], rpad[c], spad[c]))).to(bitmaps.device)
        out, sup, _ = self._reduced_survivors(bitmaps, lrs, int(counts[c]),
                                              mode, min_sup)
        sups = coll.all_gather(sup, self.mesh, self.class_axis).cpu().numpy()
        return self._assemble(sups, out, counts, slot_of_pair, min_sup,
                              self.class_axis)


BACKENDS: Dict[str, Type[Engine]] = {
    "ref": RefEngine, "fused": FusedEngine, "sharded": ShardedEngine,
    "tidsharded": TidShardedEngine, "grid": GridShardedEngine}


def available_backends() -> List[str]:
    return sorted(BACKENDS)


def make_engine(backend: str, *, mesh=None, bucket_min: int = 128,
                inner: str = "fused") -> Engine:
    """Construct a backend by name; the mesh backends need a mesh (``grid``
    a 2D ``("class", "data")`` one) and run ``inner`` on each rank."""
    if backend in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"engine backend {backend!r} is not ported yet; "
            f"available: {available_backends()}")
    cls = BACKENDS.get(backend)
    if cls is None:
        raise ValueError(f"unknown engine backend {backend!r}; "
                         f"available: {available_backends()}")
    if backend in MESH_BACKENDS:
        if mesh is None:
            raise ValueError(f"{backend} backend requires a mesh")
        return cls(mesh, bucket_min, inner=inner)
    return cls(bucket_min)


def resolve_engine(backend: str, mesh=None, *, bucket_min: int = 128,
                   shard: str = "pairs") -> Engine:
    """Map a (backend name, mesh, shard mode) request onto an engine, with
    the reference's routing and errors.

    A mesh always means a mesh backend, with the named single-device
    backend (``ref`` or ``fused``) as its inner executor; ``shard`` picks
    the split: ``"pairs"`` (sharded), ``"words"`` (tidsharded) or
    ``"grid"``.  Naming a mesh backend implies its shard mode; combining it
    with a different non-default ``shard`` is refused.  A mesh backend
    without a mesh is the single-device default (``fused``), as in the
    reference."""
    shard_to_backend = {"pairs": "sharded", "words": "tidsharded",
                        "grid": "grid"}
    if shard not in shard_to_backend:
        raise ValueError(f"unknown shard mode {shard!r}; "
                         "expected 'pairs', 'words' or 'grid'")
    if backend not in BACKENDS:
        return make_engine(backend, bucket_min=bucket_min)  # raises
    implied = {"sharded": "pairs", "tidsharded": "words",
               "grid": "grid"}.get(backend)
    if implied is not None:
        # shard="pairs" is the config default, so only an explicit
        # disagreement is a conflict
        if shard not in ("pairs", implied):
            raise ValueError(
                f"backend {backend!r} implies shard={implied!r} but "
                f"shard={shard!r} was requested; drop one of the two")
        shard = implied
    if mesh is None:
        return make_engine("fused" if implied else backend,
                           bucket_min=bucket_min)
    inner = backend if backend in INNER else "fused"
    return make_engine(shard_to_backend[shard], mesh=mesh,
                       bucket_min=bucket_min, inner=inner)
