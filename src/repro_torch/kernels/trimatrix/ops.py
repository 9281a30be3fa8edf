"""Dispatch for the co-occurrence kernel: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain torch version.  On a CUDA
tensor the kernel runs or the call raises."""
from __future__ import annotations

import torch

from .ref import trimatrix_ref
from .trimatrix import plan_for, trimatrix

__all__ = ["cooccurrence"]


def cooccurrence(bitmaps: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 words -> (N, N) int32 co-occurrence counts.  On the card
    the kernel's word split is the autotune table's for this shape class
    and card where it has one, else :func:`split_plan`'s."""
    if bitmaps.device.type == "cuda":
        from .. import autotune
        n, w = bitmaps.shape
        cfg = autotune.table_config("trimatrix", n, w, 0, bitmaps.device)
        plan = plan_for(w, cfg.split) if cfg is not None and cfg.split else None
        return trimatrix(bitmaps, plan=plan)
    if bitmaps.device.type == "cpu":
        return trimatrix_ref(bitmaps)
    raise ValueError(f"no co-occurrence path for device {bitmaps.device}")
