"""Dispatch for the fused-intersect kernels: a CUDA tensor goes to the
hand-written kernel (:mod:`.fused_intersect`), a CPU tensor to the plain
torch version (:mod:`.ref`).  There is no fallback: on a CUDA tensor the
kernel runs or the call raises."""
from __future__ import annotations

import torch

from .fused_intersect import fused_intersect_compact_pairs, fused_intersect_pairs
from .ref import fused_intersect_compact_ref, fused_intersect_ref

__all__ = ["fused_intersect", "fused_intersect_compact"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no fused-intersect path for device {t.device}")


def fused_intersect(bitmaps, left, right, sup_left, min_sup: int, *, mode: int):
    """Gather + intersect + popcount + threshold:
    ``((Q, W) inter, (Q,) sup, (Q,) mask)``."""
    if _on_cuda(bitmaps):
        return fused_intersect_pairs(bitmaps, left, right, sup_left,
                                            min_sup, mode=mode)
    return fused_intersect_ref(bitmaps, left, right, sup_left, min_sup,
                                   mode=mode)


def fused_intersect_compact(bitmaps, left, right, sup_left, min_sup: int,
                            n_valid: int, *, mode: int):
    """The same with survivor compaction:
    ``(compact (Q, W), sup (Q,), mask (Q,), n_surv)``."""
    if _on_cuda(bitmaps):
        return fused_intersect_compact_pairs(
            bitmaps, left, right, sup_left, min_sup, n_valid, mode=mode)
    return fused_intersect_compact_ref(bitmaps, left, right, sup_left,
                                           min_sup, n_valid, mode=mode)
