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

Pair batches are padded up to a half-power-of-two ladder
(``bucket_min`` x {1, 1.5, 2, 3, 4, 6, ...}), which caps padding waste at
~33% and keeps the set of batch shapes small; survivor blocks are padded the
same way from the ``compact_min`` floor.  The ladder, the padding rows and
``stats()["pair_padding"]`` match the reference package's engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Type

import numpy as np
import torch

from ..kernels.fused_intersect import (MODE_DIFFSET, MODE_TID_TO_DIFF,
                                       MODE_TIDSET, fused_intersect_compact,
                                       fused_intersect_compact_ref)

__all__ = [
    "MODE_TIDSET", "MODE_TID_TO_DIFF", "MODE_DIFFSET",
    "LevelResult", "Engine", "RefEngine", "FusedEngine", "BACKENDS",
    "available_backends", "make_engine", "bucket_size", "PairBuffers",
]

# backends of the reference package that this port does not have yet
UNPORTED_BACKENDS = ("auto", "batched", "sharded", "tidsharded", "grid")


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


class Engine:
    """Backend interface + shared accounting.

    The survivor compaction runs inside the intersection call, so on the
    card nothing returns to the host before it.  ``compact_min`` is the
    floor of the survivor ladder, separate from the pair floor because
    survivor counts collapse at deep levels.
    """

    name = "abstract"

    def __init__(self, bucket_min: int = 128, *,
                 compact_min: int | None = None):
        self.buffers = PairBuffers(bucket_min)
        self.compact_min = (min(self.buffers.floor, 128)
                            if compact_min is None else max(int(compact_min), 1))
        self.n_intersections = 0
        self.n_padded = 0
        self.level_padding: List[Tuple[int, int]] = []

    # the device function a backend supplies
    @staticmethod
    def _intersect_compact(bitmaps, left, right, sup_left, min_sup, n_valid,
                           *, mode):
        raise NotImplementedError

    def _record_padding(self, q: int, padded: int) -> None:
        self.n_padded += padded - q
        self.level_padding.append((int(q), int(padded)))

    def expand(self, bitmaps: torch.Tensor, left: np.ndarray,
               right: np.ndarray, sup_left: np.ndarray, *, mode: int,
               min_sup: int) -> LevelResult:
        """Intersect all (left[q], right[q]) frontier-row pairs, threshold at
        ``min_sup``, and return the device-compacted survivors."""
        q = int(left.shape[0])
        if q == 0:
            return self._empty(bitmaps)
        p = int(bitmaps.shape[0])
        # the CUDA kernels gather rows without bounds checks
        if (min(left.min(), right.min()) < 0
                or max(left.max(), right.max()) >= p):
            raise ValueError(f"pair indices outside the {p}-row frontier")
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

    def stats(self) -> dict:
        out = {
            "backend": self.name,
            "n_intersections": self.n_intersections,
            "n_padded": self.n_padded,
        }
        if self.level_padding:
            tot_q = sum(q for q, _ in self.level_padding)
            tot_p = sum(p for _, p in self.level_padding)
            out["pair_padding"] = {
                "per_level": [
                    {"pairs": q, "padded_to": p,
                     "efficiency": q / p if p else 1.0}
                    for q, p in self.level_padding
                ],
                "efficiency": tot_q / tot_p if tot_p else 1.0,
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


BACKENDS: Dict[str, Type[Engine]] = {"ref": RefEngine, "fused": FusedEngine}


def available_backends() -> List[str]:
    return sorted(BACKENDS)


def make_engine(backend: str, *, bucket_min: int = 128) -> Engine:
    """Construct a single-device backend by name."""
    if backend in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"engine backend {backend!r} is not ported yet; "
            f"available: {available_backends()}")
    cls = BACKENDS.get(backend)
    if cls is None:
        raise ValueError(f"unknown engine backend {backend!r}; "
                         f"available: {available_backends()}")
    return cls(bucket_min)
