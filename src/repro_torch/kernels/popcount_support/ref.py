"""Plain torch version of the popcount-support kernel: the oracle the CUDA
kernel is held to, and the path :mod:`.ops` takes for CPU tensors.  Same
contract as the reference package's ``popcount_support_ref``."""
from __future__ import annotations

import torch

from ...device import popcount_words

__all__ = ["popcount_support_ref"]


def popcount_support_ref(a: torch.Tensor, b: torch.Tensor):
    """(M, W) int32 words x2 -> ((M, W) int32 intersection, (M,) int32
    support)."""
    inter = a & b
    return inter, popcount_words(inter).sum(dim=-1, dtype=torch.int32)
