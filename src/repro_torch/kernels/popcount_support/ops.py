"""Dispatch for the popcount-support kernel: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain torch version.  On a CUDA
tensor the kernel runs or the call raises."""
from __future__ import annotations

import torch

from .popcount_support import popcount_support
from .ref import popcount_support_ref

__all__ = ["intersect_support"]


def intersect_support(a: torch.Tensor, b: torch.Tensor):
    """Batched tidset AND + support of pre-gathered rows:
    ``((M, W) inter, (M,) support)``."""
    if a.device.type == "cuda":
        return popcount_support(a, b)
    if a.device.type == "cpu":
        return popcount_support_ref(a, b)
    raise ValueError(f"no popcount-support path for device {a.device}")
