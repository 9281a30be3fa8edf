"""Triangular-matrix 2-itemset counting (the paper's Phase-2).

The paper updates a shared upper-triangular ``long[]`` through a Spark
accumulator while streaming the horizontal DB.  With packed bitmaps the
whole matrix is a popcount co-occurrence product

    C[i, j] = sum_w popcount(B[i, w] & B[j, w])

which the ``trimatrix`` CUDA kernel computes on the card (its plain torch
version on the host, and for the ``ref`` engine backend everywhere).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.trimatrix import cooccurrence, trimatrix_ref

__all__ = ["cooccurrence_counts", "frequent_pairs"]


def cooccurrence_counts(bitmaps: torch.Tensor, *, backend: str = "fused") -> np.ndarray:
    """Full (n, n) int32 co-occurrence count matrix of an (n, W) int32 word
    tensor, computed on the tensor's device and returned on the host.
    ``backend="ref"`` takes the plain torch version on every device."""
    if bitmaps.shape[0] == 0:
        return np.zeros((0, 0), np.int32)
    fn = trimatrix_ref if backend == "ref" else cooccurrence
    return fn(bitmaps).cpu().numpy()


def frequent_pairs(counts: np.ndarray, min_sup: int):
    """Upper-triangular (i < j) index pairs with count >= min_sup."""
    n = counts.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    keep = counts[iu, ju] >= int(min_sup)
    return iu[keep].astype(np.int64), ju[keep].astype(np.int64), counts[iu, ju][keep]
