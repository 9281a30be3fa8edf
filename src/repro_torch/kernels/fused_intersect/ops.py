"""Dispatch for the fused-intersect kernels: a CUDA tensor goes to the
hand-written kernel (:mod:`.fused_intersect`), a CPU tensor to the plain
torch version (:mod:`.ref`).  There is no fallback: on a CUDA tensor the
kernel runs or the call raises."""
from __future__ import annotations

import torch

from .fused_intersect import (compact_survivors_pairs,
                              fused_intersect_compact_pairs,
                              fused_intersect_pairs,
                              fused_intersect_partial_pairs)
from .ref import (compact_survivors_ref, fused_intersect_compact_ref,
                  fused_intersect_partial_ref, fused_intersect_ref)

__all__ = ["fused_intersect", "fused_intersect_compact",
           "fused_intersect_partial", "compact_survivors"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no fused-intersect path for device {t.device}")


def fused_intersect(bitmaps, left, right, sup_left, min_sup: int, *, mode: int,
                    plan=None):
    """Gather + intersect + popcount + threshold:
    ``((Q, W) inter, (Q,) sup, (Q,) mask)``.  ``plan``: the kernel's
    ``(tile, rows, chunk)`` (``(0, 0, 0)`` = its rule; ``None`` = the
    autotune table's plan for the shape, else the rule); the plain version
    has no tile."""
    if _on_cuda(bitmaps):
        return fused_intersect_pairs(bitmaps, left, right, sup_left,
                                     min_sup, mode=mode, plan=plan)
    return fused_intersect_ref(bitmaps, left, right, sup_left, min_sup,
                               mode=mode)


def fused_intersect_compact(bitmaps, left, right, sup_left, min_sup: int,
                            n_valid: int, *, mode: int, lanes=None):
    """The same with survivor compaction:
    ``(compact (Q, W), sup (Q,), mask (Q,), n_surv)``.  ``lanes``: the
    kernel's lanes per pair (8, 16, 32; 0 = its rule; ``None`` = the
    autotune table's pick for the shape, else the rule); the plain version
    has no tile."""
    if _on_cuda(bitmaps):
        return fused_intersect_compact_pairs(
            bitmaps, left, right, sup_left, min_sup, n_valid, mode=mode,
            lanes=lanes)
    return fused_intersect_compact_ref(bitmaps, left, right, sup_left,
                                           min_sup, n_valid, mode=mode)


def fused_intersect_partial(bitmaps, left, right, *, mode: int,
                            store: bool = True, plan=None):
    """Gather + intersect + raw popcount of a frontier word slice:
    ``((Q, W) inter or None, (Q,) partial popcount)``; ``store=False``
    leaves the intersections out; ``plan`` as above."""
    if _on_cuda(bitmaps):
        return fused_intersect_partial_pairs(bitmaps, left, right, mode=mode,
                                             store=store, plan=plan)
    return fused_intersect_partial_ref(bitmaps, left, right, mode=mode,
                                       store=store)


def compact_survivors(bitmaps, left, right, mask, n_valid: int, *, mode: int,
                      lanes=None):
    """Survivor compaction from a given int32 mask:
    ``(compact (Q, W), valid-masked mask, n_surv)``; ``lanes`` as above."""
    if _on_cuda(bitmaps):
        return compact_survivors_pairs(bitmaps, left, right, mask, n_valid,
                                       mode=mode, lanes=lanes)
    return compact_survivors_ref(bitmaps, left, right, mask, n_valid,
                                 mode=mode)
