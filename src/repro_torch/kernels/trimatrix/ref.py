"""Plain torch version of the co-occurrence kernel: the oracle the CUDA
kernel is held to, and the path :mod:`.ops` takes for CPU tensors."""
from __future__ import annotations

import torch

from ...device import popcount_words

__all__ = ["trimatrix_ref"]


def trimatrix_ref(bitmaps: torch.Tensor, block_elems: int = 1 << 24) -> torch.Tensor:
    """(N, W) int32 words -> (N, N) int32 co-occurrence counts, computed in
    row blocks so the (rows, N, W) intermediate stays near ``block_elems``
    words."""
    n, w = bitmaps.shape
    out = torch.empty((n, n), dtype=torch.int32, device=bitmaps.device)
    rows = max(1, block_elems // max(n * w, 1))
    for s in range(0, n, rows):
        inter = bitmaps[s: s + rows, None, :] & bitmaps[None, :, :]
        out[s: s + rows] = popcount_words(inter).sum(dim=-1, dtype=torch.int32)
    return out
