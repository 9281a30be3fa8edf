"""Plain torch versions of the co-occurrence kernel: the oracle the CUDA
kernel is held to (and the path :mod:`.ops` takes for CPU tensors), and an
emulation of the card kernel's arithmetic for the tests."""
from __future__ import annotations

import torch

from ...device import popcount_words

__all__ = ["trimatrix_ref", "trimatrix_unpacked_ref"]


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


def trimatrix_unpacked_ref(bitmaps: torch.Tensor, splits: int = 1) -> torch.Tensor:
    """The card kernel's arithmetic: the words unpacked to the 0/1
    indicator ``D[i, 32 w + b] = bit b of word w`` and ``C = D D^T`` as
    integer products, one per range of words (the word axis cut into
    ``splits`` contiguous ranges, as the kernel's split-K does), the
    ranges' products summed.  (N, W) int32 words -> (N, N) int32."""
    n, w = bitmaps.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bitmaps.device)
    out = torch.zeros((n, n), dtype=torch.int64, device=bitmaps.device)
    for words in torch.arange(w, device=bitmaps.device).tensor_split(splits):
        if words.numel() == 0:
            continue
        dense = ((bitmaps[:, words, None] >> shifts) & 1).reshape(n, -1).to(torch.int64)
        out += dense @ dense.T
    return out.to(torch.int32)
