"""Packed-bitmap tidsets — the vertical data format of the miner.

    B[i, w] : 32-bit word   bit t%32 of word t//32 set  <=>  item i in txn t

Intersection is a bitwise AND over words and support counting a popcount
reduction: fixed-shape work that the card runs in the ``fused_intersect``
kernel, and the paper's 2-itemset triangular matrix becomes the
``trimatrix`` popcount product.

The host side (encode, compact) is numpy on ``uint32`` arrays, as in the
reference package; on the device the same bits travel as ``int32`` tensors
(:mod:`repro_torch.device`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import popcount_words

WORD_BITS = 32
_WORD_DTYPE = np.uint32

__all__ = [
    "WORD_BITS",
    "n_words",
    "pack_bool_matrix",
    "unpack_bitmap",
    "pack_transactions",
    "scatter_transactions",
    "popcount_np",
    "support_np",
    "support",
    "column_compact",
]


def n_words(n_txn: int) -> int:
    """Number of 32-bit words needed for ``n_txn`` transaction columns."""
    return (int(n_txn) + WORD_BITS - 1) // WORD_BITS


def pack_bool_matrix(dense: np.ndarray) -> np.ndarray:
    """Pack a boolean ``(n_items, n_txn)`` matrix into ``(n_items, W)`` uint32.

    Bit layout: transaction ``t`` lives in word ``t // 32`` at bit ``t % 32``.
    """
    dense = np.asarray(dense, dtype=bool)
    if dense.ndim != 2:
        raise ValueError(f"expected 2-D bool matrix, got shape {dense.shape}")
    n_items, n_txn = dense.shape
    w = n_words(n_txn)
    padded = np.zeros((n_items, w * WORD_BITS), dtype=bool)
    padded[:, :n_txn] = dense
    packed = np.packbits(padded, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(_WORD_DTYPE)


def unpack_bitmap(packed: np.ndarray, n_txn: int) -> np.ndarray:
    """Inverse of :func:`pack_bool_matrix`."""
    packed = np.asarray(packed, dtype=_WORD_DTYPE)
    n_items, w = packed.shape
    bits = (packed[:, :, None] >> np.arange(WORD_BITS, dtype=_WORD_DTYPE)) & 1
    dense = bits.reshape(n_items, w * WORD_BITS).astype(bool)
    return dense[:, :n_txn]


def scatter_transactions(packed: np.ndarray, transactions, tid_offset: int = 0) -> None:
    """OR the bits of ``transactions`` (transaction ``k`` has tid
    ``tid_offset + k``) into ``packed`` in place.

    One flat ``(item, tid)`` list and one ``np.bitwise_or.at``: duplicate
    items within a transaction are harmless (OR is idempotent); an item
    outside ``[0, n_items)`` is rejected with its transaction id.
    """
    txns = [np.asarray(t if isinstance(t, (list, tuple, np.ndarray)) else list(t),
                       dtype=np.int64).reshape(-1) for t in transactions]
    if not txns:
        return
    items = np.concatenate(txns)
    if items.size == 0:
        return
    tids = np.repeat(np.arange(len(txns), dtype=np.int64) + int(tid_offset),
                     [a.size for a in txns])
    bad = (items < 0) | (items >= packed.shape[0])
    if bad.any():
        t = int(tids[int(np.argmax(bad))])
        raise ValueError(f"txn {t} has item outside [0, {packed.shape[0]})")
    np.bitwise_or.at(
        packed,
        (items, tids // WORD_BITS),
        _WORD_DTYPE(1) << (tids % WORD_BITS).astype(_WORD_DTYPE),
    )


def pack_transactions(transactions, n_items: int) -> np.ndarray:
    """Encode a horizontal database (iterable of item-id iterables) into the
    packed vertical bitmap ``(n_items, W)`` (the paper's Phase-1
    ``flatMapToPair -> groupByKey`` as one scatter)."""
    transactions = list(transactions)
    packed = np.zeros((n_items, n_words(len(transactions))), dtype=_WORD_DTYPE)
    scatter_transactions(packed, transactions)
    return packed


def popcount_np(x: np.ndarray) -> np.ndarray:
    """Per-element popcount for host-side uint32 arrays."""
    x = np.asarray(x, dtype=np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(np.int64)


def support_np(packed: np.ndarray) -> np.ndarray:
    """Host-side row supports of a packed bitmap ``(n, W)`` -> ``(n,)``."""
    return popcount_np(packed).sum(axis=-1)


def support(words: torch.Tensor) -> torch.Tensor:
    """Row supports ``(..., W)`` int32 words -> ``(...)`` int32, on the
    tensor's device."""
    return popcount_words(words).sum(dim=-1, dtype=torch.int32)


def column_compact(packed: np.ndarray, n_txn: int, keep_cols: np.ndarray):
    """Re-pack a bitmap keeping only ``keep_cols`` transaction columns.

    The bitmap form of the paper's filtered-transaction technique (EclatV2):
    transactions that became empty after dropping infrequent items are
    removed, shrinking W for every later AND/popcount.  Output bit ``j`` of
    each row is read from word ``keep_idx[j] // 32`` of the source and the
    selected bits are re-packed with ``np.packbits``, so the only
    intermediate is one byte per kept column.
    """
    packed = np.asarray(packed, dtype=_WORD_DTYPE)
    keep_cols = np.asarray(keep_cols)
    if keep_cols.dtype == bool:
        keep_idx = np.nonzero(keep_cols[:n_txn])[0]
    else:
        keep_idx = np.asarray(keep_cols, dtype=np.int64)
    n_items = packed.shape[0]
    k = int(keep_idx.shape[0])
    w_out = n_words(k)
    if k == 0:
        return np.zeros((n_items, 0), dtype=_WORD_DTYPE), 0
    src_word = (keep_idx // WORD_BITS).astype(np.int64)
    src_bit = (keep_idx % WORD_BITS).astype(_WORD_DTYPE)
    bits = ((packed[:, src_word] >> src_bit) & _WORD_DTYPE(1)).astype(np.uint8)
    pad = w_out * WORD_BITS - k
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    packed_bytes = np.ascontiguousarray(
        np.packbits(bits, axis=-1, bitorder="little"))
    out = packed_bytes.view("<u4").astype(_WORD_DTYPE)
    return out, k
