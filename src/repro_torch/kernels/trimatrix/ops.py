"""Dispatch for the co-occurrence kernel: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain torch version.  On a CUDA
tensor the kernel runs or the call raises."""
from __future__ import annotations

import torch

from .ref import trimatrix_ref
from .trimatrix import trimatrix

__all__ = ["cooccurrence"]


def cooccurrence(bitmaps: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 words -> (N, N) int32 co-occurrence counts."""
    if bitmaps.device.type == "cuda":
        return trimatrix(bitmaps)
    if bitmaps.device.type == "cpu":
        return trimatrix_ref(bitmaps)
    raise ValueError(f"no co-occurrence path for device {bitmaps.device}")
