"""Plain torch version of the fused-intersect kernels: the oracle the CUDA
kernels are held to, and the path :mod:`.ops` takes for CPU tensors.

Same contract as the reference package's ``fused_intersect_ref``,
``fused_intersect_compact_ref`` and ``fused_intersect_partial_ref``; words are ``int32`` tensors holding the
``uint32`` bits.  The compaction uses no host round trip (cumsum + scatter +
``index_select``), so on a CUDA tensor it runs without synchronising.
"""
from __future__ import annotations

import torch

from ...device import popcount_words
from .fused_intersect import MODE_DIFFSET, MODE_TID_TO_DIFF, MODE_TIDSET

__all__ = ["fused_intersect_ref", "compact_epilogue",
           "fused_intersect_compact_ref", "fused_intersect_partial_ref",
           "compact_survivors_ref"]


def _intersect(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    if mode == MODE_TIDSET:
        return a & b
    if mode == MODE_TID_TO_DIFF:
        return a & ~b
    if mode == MODE_DIFFSET:
        return b & ~a
    raise ValueError(f"unknown mode {mode}")


def fused_intersect_partial_ref(bitmaps: torch.Tensor, left: torch.Tensor,
                                right: torch.Tensor, *, mode: int,
                                store: bool = True, plan=None):
    """(P, W) frontier (or a word slice of one) x (Q,) ->
    ``((Q, W) int32 intersections, or None with store=False; (Q,) int32
    raw popcounts)``: no support conversion and no threshold.  ``plan`` is
    the kernel's tile; the plain version has none and ignores it."""
    a = bitmaps.index_select(0, left.long())
    b = bitmaps.index_select(0, right.long())
    inter = _intersect(a, b, mode)
    pop = popcount_words(inter).sum(dim=-1, dtype=torch.int32)
    return (inter if store else None), pop


def fused_intersect_ref(bitmaps: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor, sup_left: torch.Tensor,
                        min_sup, *, mode: int, plan=None):
    """(P, W) x (Q,) -> ((Q, W) int32, (Q,) int32 sup, (Q,) int32 mask);
    ``plan`` is ignored, as above."""
    inter, pop = fused_intersect_partial_ref(bitmaps, left, right, mode=mode)
    sup = pop if mode == MODE_TIDSET else sup_left.to(torch.int32) - pop
    mask = (sup >= min_sup).to(torch.int32)
    return inter, sup, mask


def compact_epilogue(inter: torch.Tensor, sup: torch.Tensor,
                     mask: torch.Tensor, n_valid):
    """Survivor compaction: rows ``[:S]`` of the result are the rows of
    ``inter`` whose ``mask & (q < n_valid)`` is set, in ascending order;
    rows ``[S:]`` duplicate ``inter[0]``.  Returns
    ``(compact, sup, valid-masked mask, S)``."""
    q = mask.shape[0]
    dev = mask.device
    valid = torch.arange(q, device=dev) < n_valid
    m = (mask != 0) & valid
    pos = torch.cumsum(m, 0, dtype=torch.int64) - 1
    slot = torch.where(m, pos, torch.full_like(pos, q))   # q: a dump slot
    sel = torch.zeros(q + 1, dtype=torch.int64, device=dev)
    sel.scatter_(0, slot, torch.arange(q, device=dev))
    compact = inter.index_select(0, sel[:q])
    return compact, sup, m.to(torch.int32), m.sum(dtype=torch.int32)


def fused_intersect_compact_ref(bitmaps, left, right, sup_left, min_sup,
                                n_valid, *, mode: int, lanes=None):
    """The fused pass plus :func:`compact_epilogue`: returns
    ``(compact (Q, W), sup (Q,), mask (Q,), n_surv)``.  ``lanes`` is the
    kernel's tile; the plain version has none and ignores it."""
    inter, sup, mask = fused_intersect_ref(bitmaps, left, right, sup_left,
                                           min_sup, mode=mode)
    return compact_epilogue(inter, sup, mask, n_valid)


def compact_survivors_ref(bitmaps, left, right, mask, n_valid, *, mode: int,
                          lanes=None):
    """The compaction alone, from a mask computed elsewhere: returns
    ``(compact (Q, W), valid-masked mask (Q,), n_surv)``; ``lanes`` is
    ignored, as above."""
    inter, _ = fused_intersect_partial_ref(bitmaps, left, right, mode=mode)
    compact, _, m, n_surv = compact_epilogue(inter, mask, mask, n_valid)
    return compact, m, n_surv
