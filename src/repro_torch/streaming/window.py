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

The ring's serializable state (:class:`RingState`, DESIGN.md §10) is its
logical content only — the host mirror at the logical width (``uint32``,
as the reference writes it), per-slot transaction counts and the cursor —
so a snapshot taken on any mesh restores on any other: the rank's device
slice is re-cut from the host words and uploaded once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import bitmap as bm
from ..device import DeviceLike, resolve_device, words_from_numpy, words_to_numpy
from ..dist.sharding import axis_index, axis_size, padded_word_count

__all__ = ["WindowRing", "RingState"]


@dataclasses.dataclass
class RingState:
    """Serializable snapshot of a :class:`WindowRing` (DESIGN.md §10): the
    reference's fields and on-disk form.

    Holds *logical* content only: the host mirror at the logical word width,
    per-slot transaction counts, and the ring cursor.  The device ring —
    shard padding and this rank's slice included — is derived, recomputed on
    restore from (host words, restoring mesh), which is what lets a
    checkpoint taken on a 4-way word-sharded mesh restore onto 2 ranks, a
    2x2 grid or a single device bit-exactly.
    """
    n_items: int
    n_blocks: int
    block_txns: int
    words: np.ndarray                 # (n_items, n_words) uint32, logical
    block_counts: np.ndarray          # (n_blocks,) int64
    head: int
    filled: int
    n_advances: int
    txns: Optional[List[List[List[int]]]] = None   # per slot, if kept

    def to_tree(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """(array tree, JSON-able extra) for ``training.checkpoint``.  The
        ragged per-slot transaction lists are flattened to three int64
        vectors (slot counts / transaction lengths / item ids)."""
        tree: Dict[str, np.ndarray] = {
            "words": np.ascontiguousarray(self.words, dtype=np.uint32),
            "block_counts": np.asarray(self.block_counts, np.int64),
        }
        if self.txns is not None:
            tree["txn_slot_counts"] = np.asarray(
                [len(slot) for slot in self.txns], np.int64)
            tree["txn_lens"] = np.asarray(
                [len(t) for slot in self.txns for t in slot], np.int64)
            tree["txn_items"] = np.asarray(
                [i for slot in self.txns for t in slot for i in t], np.int64)
        extra = {"n_items": int(self.n_items),
                 "n_blocks": int(self.n_blocks),
                 "block_txns": int(self.block_txns),
                 "head": int(self.head), "filled": int(self.filled),
                 "n_advances": int(self.n_advances),
                 "has_txns": self.txns is not None}
        return tree, extra

    @classmethod
    def from_tree(cls, tree: Dict[str, np.ndarray], extra: dict) -> "RingState":
        txns = None
        if extra["has_txns"]:
            txns = []
            lens = iter(np.asarray(tree["txn_lens"], np.int64).tolist())
            items = np.asarray(tree["txn_items"], np.int64).tolist()
            pos = 0
            for count in np.asarray(tree["txn_slot_counts"], np.int64).tolist():
                slot = []
                for _ in range(count):
                    n = next(lens)
                    slot.append(items[pos: pos + n])
                    pos += n
                txns.append(slot)
        return cls(n_items=int(extra["n_items"]),
                   n_blocks=int(extra["n_blocks"]),
                   block_txns=int(extra["block_txns"]),
                   words=np.asarray(tree["words"], np.uint32),
                   block_counts=np.asarray(tree["block_counts"], np.int64),
                   head=int(extra["head"]), filled=int(extra["filled"]),
                   n_advances=int(extra["n_advances"]), txns=txns)


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
        self.n_advances = 0
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
            # staticcheck: sync=window.block_upload
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
        self.n_advances += 1
        return new_block, old_block, n_evicted

    # -- serializable state (DESIGN.md §10) ---------------------------------

    def snapshot_state(self) -> RingState:
        """Deep-copied logical state, from the host mirror alone (no device
        read); safe to serialize while the ring keeps sliding."""
        return RingState(
            n_items=self.n_items, n_blocks=self.n_blocks,
            block_txns=self.block_txns, words=self.words.copy(),
            block_counts=self.block_counts.copy(), head=self.head,
            filled=self.filled, n_advances=self.n_advances,
            txns=([[list(t) for t in slot] for slot in self._txns]
                  if self._txns is not None else None))

    def restore_state(self, state: RingState) -> "WindowRing":
        """Adopt a snapshot's logical content.  The device ring is re-derived:
        this rank's word slice ``[word_lo, word_lo + local_words)`` is cut
        from the host words (the pad words past ``n_words`` zero) and
        uploaded in one copy, so the snapshot may come from any mesh
        factorization, or none."""
        if (state.n_items, state.n_blocks, state.block_txns) != \
                (self.n_items, self.n_blocks, self.block_txns):
            raise ValueError(
                f"ring geometry mismatch: state has (items={state.n_items}, "
                f"blocks={state.n_blocks}, block_txns={state.block_txns}), "
                f"ring has ({self.n_items}, {self.n_blocks}, {self.block_txns})")
        words = np.asarray(state.words, np.uint32)
        if words.shape != (self.n_items, self.n_words):
            raise ValueError(f"ring words of shape {words.shape}, expected "
                             f"{(self.n_items, self.n_words)}")
        self.words = words.copy()
        self.block_counts = np.array(state.block_counts, np.int64, copy=True)
        self.head = int(state.head)
        self.filled = int(state.filled)
        self.n_advances = int(state.n_advances)
        self._txns = ([[list(t) for t in slot] for slot in state.txns]
                      if state.txns is not None else None)
        local = np.zeros((self.n_items, self.local_words), np.uint32)
        n_real = max(0, min(self.local_words, self.n_words - self.word_lo))
        local[:, :n_real] = self.words[:, self.word_lo: self.word_lo + n_real]
        self.device = words_from_numpy(local, self.dev)
        return self

    @classmethod
    def from_state(cls, state: RingState, mesh=None, shard_axis: str = "data",
                   device: DeviceLike = None) -> "WindowRing":
        """Rebuild a ring from a snapshot under a (possibly different) mesh,
        on ``device`` (``None`` = CUDA)."""
        ring = cls(state.n_items, state.n_blocks, state.block_txns,
                   keep_transactions=state.txns is not None, mesh=mesh,
                   shard_axis=shard_axis, device=device)
        return ring.restore_state(state)

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
