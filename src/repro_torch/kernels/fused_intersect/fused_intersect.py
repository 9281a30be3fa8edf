"""ctypes binding of the fused-intersect CUDA kernels
(``csrc/fused_intersect.cu``), with their launch counters and the launch
plan of K1 and K3.

The functions take CUDA tensors only (the CPU path is :mod:`.ref`, chosen
by :mod:`.ops`); they allocate their outputs with ``torch.empty``, launch on
the current stream and do not synchronise.

Launch counters, plain integers on the wrappers:

``fused_intersect_pairs.launches``          launches of ``fused_pairs_kernel``
                                            (``fused_intersect_pairs``,
                                            ``fused_support_pairs``)
``fused_intersect_compact_pairs.launches``  launches of the survivor
                                            compaction (``compact_pairs_kernel``),
                                            from either front end
``fused_intersect_partial_pairs.launches``  launches of ``partial_pairs_kernel``

The compacting path runs K1's arithmetic inside its own pass, so on the
miner's main path ``fused_intersect_pairs.launches`` stays 0.

K1 (``fused_pairs_kernel``) and K3 (``partial_pairs_kernel``) are one
device template with an epilogue flag.  A block takes a tile of consecutive
pairs and stages a window of consecutive frontier rows, from the tile's
first left row on, in shared memory (bulk copies of the TMA engine, no
tensor map); operand rows inside the window are read there, the others
gathered from the frontier.  The miner's pair lists are class-ordered
(``core.equivalence.segment_pairs``), so a tile's rows lie in one short run
and each is read about once per tile, not twice per pair.  Rows too wide
for the window are staged in word chunks, two in flight; a tile whose
operands mostly lie outside its window (random pairs) stages nothing.
:func:`window_plan` is the plan, the same function as the CUDA source's.

The caller guarantees ``0 <= left, right < P``: checking that here would
copy the indices back to the host and stall the stream, so the engine checks
its pair lists on the host before upload.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build

__all__ = ["MODE_TIDSET", "MODE_TID_TO_DIFF", "MODE_DIFFSET",
           "fused_intersect_pairs", "fused_support_pairs",
           "fused_intersect_compact_pairs", "compact_survivors_pairs",
           "fused_intersect_partial_pairs", "WindowPlan", "window_plan"]

MODE_TIDSET = 0
MODE_TID_TO_DIFF = 1
MODE_DIFFSET = 2

_P = ctypes.c_void_p

# K1 and K3's plan constants: csrc/fused_intersect.cu kWin*
WINDOW_THREADS = 256
WINDOW_TILE_NARROW = 256      # pairs of a tile of narrow rows: a thread each
WINDOW_TILE_WIDE = 16         # of wide rows: 16 lanes each
WINDOW_TILE_MIN = 8           # a warp per pair at most
WINDOW_NARROW = 128           # widest row a thread takes alone
WINDOW_ROWS_MAX = 256         # window rows
WINDOW_SMS = 132              # SMs of an H100 SXM
WINDOW_WHOLE_LIMIT = 100 * 1024   # bytes of whole rows staged
WINDOW_STAGE_BYTES = 48 * 1024    # bytes of a stage of row chunks


class WindowPlan(NamedTuple):
    """The launch plan of K1 and K3: ``tile`` consecutive pairs a block
    (its 256 threads in groups of ``256 // tile`` lanes, a pair each), a
    window of at most ``rows`` rows, ``chunk`` words of each row staged at
    once (W: whole rows, one stage; else ``stages`` = 2 in flight, row
    pitch ``chunk + 4`` words) and ``smem`` bytes of dynamic shared
    memory."""
    tile: int
    rows: int
    chunk: int
    stages: int
    smem: int


def window_plan(q: int, w: int) -> WindowPlan:
    """The plan for ``q`` pairs of ``w``-word rows, as
    ``csrc/fused_intersect.cu`` ``window_plan`` computes it: a thread per
    pair (256-pair tiles) for rows of at most 128 words, 16 lanes per pair
    (16-pair tiles) for wider ones, tiles halved (down to 8 pairs) while
    they are fewer than the card's SMs; a window of twice the tile's pairs
    in rows, at most 256; whole rows while the window's rows fit 100 KB,
    else two 48 KB stages of row chunks whose pitch is skewed by the lanes
    per pair (at least 4 words) past a multiple of 32 words."""
    tile = WINDOW_TILE_NARROW if w <= WINDOW_NARROW else WINDOW_TILE_WIDE
    while tile > WINDOW_TILE_MIN and -(-q // tile) < WINDOW_SMS:
        tile //= 2
    rows = min(2 * tile, WINDOW_ROWS_MAX)
    if rows * w * 4 <= WINDOW_WHOLE_LIMIT:
        return WindowPlan(tile, rows, w, 1, rows * w * 4 + 16)
    skew = max(WINDOW_THREADS // tile, 4) & 31
    pitch = WINDOW_STAGE_BYTES // (rows * 4)
    chunk = pitch - 4 - ((pitch - skew) & 31)
    return WindowPlan(tile, rows, chunk, 2, 2 * rows * (chunk + 4) * 4)


_BOUND = False
_STATE: dict = {}           # (device index, stream) -> [state words, last epoch]


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        lib.fused_pairs_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib.fused_pairs_launch.restype = ctypes.c_int
        lib.compact_state_words.argtypes = [ctypes.c_longlong]
        lib.compact_state_words.restype = ctypes.c_longlong
        lib.compact_max_epoch.restype = ctypes.c_ulonglong
        lib.compact_pairs_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, ctypes.c_int, _P, ctypes.c_ulonglong, _P,
            _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib.compact_pairs_launch.restype = ctypes.c_int
        lib.partial_pairs_launch.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _P]
        lib.partial_pairs_launch.restype = ctypes.c_int
        lib.window_plan_of.argtypes = [ctypes.c_longlong, ctypes.c_int, _P]
        lib.window_plan_of.restype = None
        _BOUND = True
    return lib


def cuda_window_plan(q: int, w: int) -> WindowPlan:
    """The plan as the built CUDA library computes it (for the tests that
    hold it to :func:`window_plan`)."""
    out = (ctypes.c_int * 5)()
    _lib().window_plan_of(int(q), int(w), ctypes.cast(out, _P))
    return WindowPlan(*out)


def _check_args(bitmaps, left, right, sup_left, mode, **more):
    """Validate the operands; ``sup_left`` may be None (the partial kernel
    has none) and ``more`` names further (Q,) int32 operands."""
    if bitmaps.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {bitmaps.device}")
    if bitmaps.ndim != 2:
        raise ValueError(f"expected a (P, W) frontier, got {tuple(bitmaps.shape)}")
    if sup_left is None:
        sup_left = left
    for name, t in (("bitmaps", bitmaps), ("left", left), ("right", right),
                    ("sup_left", sup_left), *more.items()):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != bitmaps.device:
            raise ValueError(f"{name} is on {t.device}, the frontier on {bitmaps.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (left.ndim != 1 or left.shape != right.shape
            or any(t.shape != left.shape for t in (sup_left, *more.values()))):
        raise ValueError("left/right/sup_left must share a (Q,) shape")
    if mode not in (MODE_TIDSET, MODE_TID_TO_DIFF, MODE_DIFFSET):
        raise ValueError(f"unknown mode {mode}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def _launch_pairs(bitmaps, left, right, sup_left, inter, sup, mask, min_sup, mode):
    q, w = left.shape[0], bitmaps.shape[1]
    if not -2**31 <= int(min_sup) < 2**31:
        raise ValueError(f"min_sup {min_sup} does not fit the kernel's int32")
    stream = torch.cuda.current_stream(bitmaps.device).cuda_stream
    code = _lib().fused_pairs_launch(
        _ptr(bitmaps), _ptr(left), _ptr(right), _ptr(sup_left), _ptr(inter),
        _ptr(sup), _ptr(mask), q, w, int(mode), int(min_sup),
        bitmaps.device.index, ctypes.c_void_p(stream))
    _build.check(code, "fused_pairs_kernel")
    fused_intersect_pairs.launches += 1


def fused_intersect_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                          right: torch.Tensor, sup_left: torch.Tensor,
                          min_sup: int, *, mode: int):
    """(P, W) int32 frontier x (Q,) int32 pair indices ->
    ((Q, W) int32 intersections, (Q,) int32 supports, (Q,) int32 mask).

    ``min_sup`` is a host integer and a runtime argument of the kernel.
    """
    _check_args(bitmaps, left, right, sup_left, mode)
    q, w = left.shape[0], bitmaps.shape[1]
    dev = bitmaps.device
    inter = torch.empty((q, w), dtype=torch.int32, device=dev)
    sup = torch.empty(q, dtype=torch.int32, device=dev)
    mask = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        _launch_pairs(bitmaps, left, right, sup_left, inter, sup, mask,
                      min_sup, mode)
    return inter, sup, mask


fused_intersect_pairs.launches = 0


def fused_support_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor, sup_left: torch.Tensor,
                        min_sup: int, *, mode: int):
    """:func:`fused_intersect_pairs` without the ``(Q, W)`` store:
    ``((Q,) int32 supports, (Q,) int32 mask)``."""
    _check_args(bitmaps, left, right, sup_left, mode)
    q = left.shape[0]
    sup = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    mask = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    if q:
        _launch_pairs(bitmaps, left, right, sup_left, None, sup, mask,
                      min_sup, mode)
    return sup, mask


def _state(lib, device: torch.device, stream: int, q: int):
    """The look-back state for a compaction of ``q`` pairs on ``stream``
    and the epoch of this launch: int64 words, zeroed once, whose statuses
    are told apart by epoch and whose counters the kernel resets, so no
    call pays for a memset (only a new, larger state, or an epoch past the
    largest, is zeroed)."""
    need = lib.compact_state_words(q)
    key = (device.index, stream)
    entry = _STATE.get(key)
    if entry is None or entry[0].numel() < need:
        entry = _STATE[key] = [torch.zeros(need, dtype=torch.int64, device=device), 0]
    entry[1] += 1
    if entry[1] > lib.compact_max_epoch():
        entry[0].zero_()
        entry[1] = 1
    return entry[0], entry[1]


def _compact(bitmaps, left, right, sup_left, sup, mask, mask_in, n_valid,
             min_sup, mode):
    """Launch the compaction (one kernel) and return ``(out, n_surv)``."""
    q, w = left.shape[0], bitmaps.shape[1]
    dev = bitmaps.device
    out = torch.empty((q, w), dtype=torch.int32, device=dev)
    if q == 0:
        return out, torch.zeros((), dtype=torch.int32, device=dev)
    n_surv = torch.empty((), dtype=torch.int32, device=dev)
    if not -2**31 <= int(min_sup) < 2**31:
        raise ValueError(f"min_sup {min_sup} does not fit the kernel's int32")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    state, epoch = _state(lib, dev, stream, q)
    code = lib.compact_pairs_launch(
        _ptr(bitmaps), _ptr(left), _ptr(right), _ptr(sup_left), _ptr(sup),
        _ptr(mask), int(mask_in), _ptr(state), epoch, _ptr(n_surv), _ptr(out),
        q, w, int(n_valid), int(min_sup), int(mode), dev.index,
        ctypes.c_void_p(stream))
    if code != 0:
        # a launch that failed may leave the state dirty: start afresh
        _STATE.pop((dev.index, stream), None)
    _build.check(code, "compact_pairs_kernel")
    fused_intersect_compact_pairs.launches += 1
    return out, n_surv


def fused_intersect_compact_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                                  right: torch.Tensor, sup_left: torch.Tensor,
                                  min_sup: int, n_valid: int, *, mode: int):
    """:func:`fused_intersect_pairs` with survivor compaction on the card:
    returns ``(compact (Q, W), sup (Q,), mask (Q,), n_surv ())``.

    Survivors are the pairs with ``mask & (q < n_valid)`` (pairs at or past
    ``n_valid`` are bucket padding).  ``compact[:n_surv]`` holds their
    intersections in ascending pair order, rows ``[n_surv:]`` duplicate the
    intersection of pair 0, and the returned mask is the valid-masked one.
    One launch computes, thresholds and compacts, pad rows included.  No
    host synchronisation happens inside.
    """
    _check_args(bitmaps, left, right, sup_left, mode)
    q = left.shape[0]
    sup = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    mask = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    out, n_surv = _compact(bitmaps, left, right, sup_left, sup, mask, False,
                           n_valid, min_sup, mode)
    return out, sup, mask, n_surv


def compact_survivors_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                            right: torch.Tensor, mask: torch.Tensor,
                            n_valid: int, *, mode: int):
    """The survivor compaction alone, from a mask computed elsewhere (the
    word-sharded backends reduce their counts over ranks first): returns
    ``(compact (Q, W), mask (Q,), n_surv ())`` as
    :func:`fused_intersect_compact_pairs` does.  ``mask`` (int32) is
    rewritten in place to the valid-masked flags."""
    _check_args(bitmaps, left, right, None, mode, mask=mask)
    out, n_surv = _compact(bitmaps, left, right, None, None, mask, True,
                           n_valid, 0, mode)
    return out, mask, n_surv


fused_intersect_compact_pairs.launches = 0


def fused_intersect_partial_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                                  right: torch.Tensor, *, mode: int,
                                  store: bool = True):
    """(P, Ws) int32 frontier word slice x (Q,) int32 pair indices ->
    ``((Q, Ws) int32 intersections or None, (Q,) int32 partial popcounts)``.

    The shard-local half of :func:`fused_intersect_pairs`: it stops at the
    raw popcount of this slice (no support conversion, no threshold), which
    the caller sums over the ranks that hold the other slices.  With
    ``store=False`` the (Q, Ws) intersections are not written.
    """
    _check_args(bitmaps, left, right, None, mode)
    q, w = left.shape[0], bitmaps.shape[1]
    dev = bitmaps.device
    inter = torch.empty((q, w), dtype=torch.int32, device=dev) if store else None
    pop = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().partial_pairs_launch(
            _ptr(bitmaps), _ptr(left), _ptr(right), _ptr(inter), _ptr(pop),
            q, w, int(mode), dev.index, ctypes.c_void_p(stream))
        _build.check(code, "partial_pairs_kernel")
        fused_intersect_partial_pairs.launches += 1
    return inter, pop


fused_intersect_partial_pairs.launches = 0
