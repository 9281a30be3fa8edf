"""Sliding window of transactions as a device-resident ring of word-blocks.

The batch miner packs the whole database once (``bitmap.pack_transactions``)
and repacks from scratch on every change.  A sliding window makes that repack
the dominant cost, so the window is kept as a *ring of word-blocks* instead:

    ring[i, b*wpb : (b+1)*wpb]   words of block b for item i

Each micro-batch of transactions is packed into one block (``wpb`` words =
``block_txns`` transaction columns) and written over the expired block *in
place*: one upload of the block and one ``copy_`` into its word span, the
rest of the window bitmap never moves, on host or device.  Support counting
and intersection are per-word elementwise, so the physical word order of the
ring (which wraps) never matters: any column permutation and any all-zero pad
column leaves every support unchanged.  That invariance is what makes the
ring bit-exact with a batch ``mine()`` over the same window contents
(DESIGN.md §5).

The ring keeps a host mirror of the packed words (``uint32``, the logical
width) so per-item support deltas and the evicted block's co-occurrence delta
can be formed without reading the device ring back; the device ring carries
the same bits as ``int32`` (:mod:`repro_torch.device`).

On a mesh the device ring is word-sharded: each rank holds its
``(n_items, Ws)`` slice, ``Ws = padded_word_count(n_words, n_data) /
n_data`` — the slice ``dist.sharding.shard_words`` cuts, replicated over any
other mesh axis — and a push writes only the part of the block's word span
that falls in the rank's own word range.  No rank needs another's words, so a
push makes no collective call.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import bitmap as bm
from ..device import DeviceLike, resolve_device, words_to_numpy
from ..dist.sharding import axis_index, axis_size, padded_word_count

__all__ = ["WindowRing"]


class WindowRing:
    """Fixed-capacity sliding window: ``n_blocks`` blocks of ``block_txns``
    transaction columns each (``block_txns`` must be a positive multiple of
    32 so block boundaries are word boundaries).

    ``push(batch)`` packs the micro-batch into the next ring slot, evicting
    whatever block occupied it, and returns the (new, old) packed blocks so
    the caller can form incremental support/co-occurrence deltas.

    With a ``mesh`` the device ring is carried **word-sharded** over
    ``shard_axis`` (DESIGN.md §7): this rank holds every item row but only
    its word slice ``[word_lo, word_lo + local_words)`` of the word axis
    zero-padded to ``n_words_dev`` (a shard multiple; pad words are
    popcount-neutral); the host mirror stays at the logical ``n_words``.  On
    a 2D grid mesh (DESIGN.md §8) the slice is the same on every rank of the
    class axis, which is how the grid engine carries its frontier.
    """

    def __init__(self, n_items: int, n_blocks: int, block_txns: int,
                 keep_transactions: bool = True, mesh=None,
                 shard_axis: str = "data", device: DeviceLike = None):
        if n_blocks < 1:
            raise ValueError("need at least one block")
        if block_txns < bm.WORD_BITS or block_txns % bm.WORD_BITS:
            raise ValueError(f"block_txns must be a positive multiple of "
                             f"{bm.WORD_BITS}, got {block_txns}")
        self.n_items = int(n_items)
        self.n_blocks = int(n_blocks)
        self.block_txns = int(block_txns)
        self.wpb = self.block_txns // bm.WORD_BITS     # words per block
        self.n_words = self.n_blocks * self.wpb
        self.dev = resolve_device(device)
        self.words = np.zeros((self.n_items, self.n_words), np.uint32)
        if mesh is not None:
            n_shards = axis_size(mesh, shard_axis)
            self.n_words_dev = padded_word_count(self.n_words, n_shards)
            self.local_words = self.n_words_dev // n_shards
            self.word_lo = axis_index(mesh, shard_axis) * self.local_words
        else:
            self.n_words_dev = self.local_words = self.n_words
            self.word_lo = 0
        self.device = torch.zeros((self.n_items, self.local_words),
                                  dtype=torch.int32, device=self.dev)
        self.block_counts = np.zeros(self.n_blocks, np.int64)  # txns per slot
        self.head = 0            # next slot to (over)write
        self.filled = 0          # slots holding live data
        self._txns: Optional[List[List[Sequence[int]]]] = (
            [[] for _ in range(self.n_blocks)] if keep_transactions else None)

    # -- geometry -----------------------------------------------------------

    @property
    def n_txn(self) -> int:
        """Live transactions in the window (pad columns excluded)."""
        return int(self.block_counts.sum())

    @property
    def full(self) -> bool:
        return self.filled == self.n_blocks

    def _slot_span(self, slot: int) -> slice:
        return slice(slot * self.wpb, (slot + 1) * self.wpb)

    # -- the one mutating operation -----------------------------------------

    def _write_device(self, block: np.ndarray, start: int) -> None:
        """Write the words of ``block`` (global words ``[start, start +
        wpb)``) that fall in this rank's slice: one upload, one ``copy_``
        into the ring's span; nothing when the span misses the slice."""
        lo = max(start, self.word_lo)
        hi = min(start + self.wpb, self.word_lo + self.local_words)
        if lo >= hi:
            return
        part = np.ascontiguousarray(block[:, lo - start: hi - start]).view(np.int32)
        self.device[:, lo - self.word_lo: hi - self.word_lo].copy_(
            torch.from_numpy(part).to(self.dev))

    def push(self, batch: Sequence[Sequence[int]]):
        """Admit one micro-batch, evicting the expired block in place.

        Returns ``(new_block, old_block, n_evicted)`` — both ``(n_items, wpb)``
        uint32 host arrays (``old_block`` is all-zero while the window is
        still warming up).
        """
        if len(batch) > self.block_txns:
            raise ValueError(f"micro-batch of {len(batch)} txns exceeds "
                             f"block capacity {self.block_txns}")
        new_block = bm.pack_transactions(batch, self.n_items)
        if new_block.shape[1] < self.wpb:   # partial batch: zero-pad columns
            new_block = np.pad(
                new_block, ((0, 0), (0, self.wpb - new_block.shape[1])))
        slot = self.head
        span = self._slot_span(slot)
        old_block = self.words[:, span].copy()
        n_evicted = int(self.block_counts[slot])
        self.words[:, span] = new_block
        self._write_device(new_block, span.start)
        self.block_counts[slot] = len(batch)
        if self._txns is not None:
            self._txns[slot] = [list(t) for t in batch]
        self.head = (self.head + 1) % self.n_blocks
        self.filled = min(self.filled + 1, self.n_blocks)
        return new_block, old_block, n_evicted

    # -- introspection (tests / bench comparators) --------------------------

    def window_transactions(self) -> List[List[int]]:
        """The window's live transactions, oldest block first (requires
        ``keep_transactions=True``)."""
        if self._txns is None:
            raise RuntimeError("ring was built with keep_transactions=False")
        out: List[List[int]] = []
        oldest = self.head if self.full else 0
        for i in range(self.filled):
            slot = (oldest + i) % self.n_blocks
            out.extend(list(t) for t in self._txns[slot])
        return out

    def validate(self) -> None:
        """Host mirror == device ring (this rank's slice), pad words zero,
        per-slot supports consistent.

        Raises ``RuntimeError`` on any violation — these are real integrity
        checks (test hook *and* debugging aid), not ``assert`` statements,
        so they hold under ``python -O`` too.
        """
        dev = words_to_numpy(self.device)
        if dev.shape != (self.n_items, self.local_words):
            raise RuntimeError(
                f"device ring shape drifted: expected "
                f"{(self.n_items, self.local_words)}, got {dev.shape}")
        # this rank's words below n_words, and the shard padding beyond it
        n_real = max(0, min(self.local_words, self.n_words - self.word_lo))
        want = self.words[:, self.word_lo: self.word_lo + n_real]
        if not np.array_equal(dev[:, :n_real], want):
            bad = np.nonzero((dev[:, :n_real] != want).any(0))[0]
            raise RuntimeError(
                f"device ring diverged from host mirror in {bad.size} word "
                f"column(s), first at word {int(bad[0]) + self.word_lo}")
        if dev[:, n_real:].any():
            raise RuntimeError("shard-padding words beyond n_words must stay "
                               "all-zero but contain set bits")
        if (self.block_counts < 0).any() or \
                (self.block_counts > self.block_txns).any():
            raise RuntimeError(f"block_counts out of [0, {self.block_txns}]: "
                               f"{self.block_counts.tolist()}")
        for slot in range(self.n_blocks):
            span = self._slot_span(slot)
            per_item = bm.popcount_np(self.words[:, span]).sum(-1)
            if per_item.max(initial=0) > self.block_counts[slot]:
                raise RuntimeError(
                    f"slot {slot} holds an item with support "
                    f"{int(per_item.max())} > its {int(self.block_counts[slot])} "
                    f"live transactions — packed columns leaked past eviction")
