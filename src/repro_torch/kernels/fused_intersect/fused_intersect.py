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
The plan ``(tile, rows, chunk)`` is a launch argument of both: ``plan=None``
takes the autotune table's plan for the shape class on this card, else the
rule; ``(0, 0, 0)`` the rule.  :func:`window_plan` is the rule and the check
of a given plan, the same functions as the CUDA source's; a plan the kernel
cannot run raises ``ValueError`` before any launch.

The caller guarantees ``0 <= left, right < P``: checking that here would
copy the indices back to the host and stall the stream, so the engine checks
its pair lists on the host before upload.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _build

__all__ = ["MODE_TIDSET", "MODE_TID_TO_DIFF", "MODE_DIFFSET",
           "fused_intersect_pairs", "fused_support_pairs",
           "fused_intersect_compact_pairs", "compact_survivors_pairs",
           "fused_intersect_partial_pairs", "launch_compact", "launch_pairs",
           "launch_partial", "WindowPlan", "window_plan", "window_skew",
           "RULE_PLAN", "COMPACT_LANES", "COMPACT_TILE_PAIRS",
           "COMPACT_UNROLL", "elem_words", "rule_lanes", "compact_shape"]

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
WINDOW_SMEM_MAX = 223 * 1024      # dynamic shared memory a given plan may take
RULE_PLAN = (0, 0, 0)             # the launch argument that takes the rule

# a given plan the kernel refuses: csrc/fused_intersect.cu kPlanBad* and
# the text cuda_error_string gives each
WINDOW_PLAN_ERRORS = {
    -1: "plan refused: the tile is not a power of two from 8 to 256 pairs",
    -2: "plan refused: the window's rows are not from 1 to 256",
    -3: ("plan refused: the chunk is not a positive word count whose row pitch "
         "(chunk + 4) lies the tile's bank skew past a multiple of 32 words "
         "(which keeps the staged rows' 16-byte loads)"),
    -4: ("plan refused: the plan's shared memory passes the 223 KB a block of 256 "
         "threads may take"),
}


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


def window_skew(tile: int) -> int:
    """The words past a multiple of 32 that a staged row's pitch
    ``chunk + 4`` lies at ``tile`` pairs a block: the lanes per pair
    ``256 // tile``, at least 4 (0 for a warp per pair), so the rows a warp
    reads at once start in different banks."""
    return max(WINDOW_THREADS // int(tile), 4) & 31


def skewed_chunk(pitch: int, tile: int) -> int:
    """The largest chunk whose row pitch ``chunk + 4`` is at most ``pitch``
    words and lies :func:`window_skew` past a multiple of 32."""
    return pitch - 4 - ((pitch - window_skew(tile)) & 31)


def rule_at_tile(w: int, tile: int) -> tuple:
    """The rule's ``(tile, rows, chunk)`` for ``w``-word rows once it has
    its tile: a window of twice the tile's pairs in rows, at most 256;
    whole rows while they fit 100 KB, else the skewed chunk of a 48 KB
    stage."""
    rows = min(2 * tile, WINDOW_ROWS_MAX)
    if rows * w * 4 <= WINDOW_WHOLE_LIMIT:
        return tile, rows, w
    return tile, rows, skewed_chunk(WINDOW_STAGE_BYTES // (rows * 4), tile)


def window_plan(q: int, w: int, plan=None) -> WindowPlan:
    """The plan of a K1 or K3 launch for ``q`` pairs of ``w``-word rows, as
    ``csrc/fused_intersect.cu`` computes it.

    ``plan=None`` or ``(0, 0, 0)``: the rule, ``window_plan`` there: a
    thread per pair (256-pair tiles) for rows of at most 128 words, 16 lanes
    per pair (16-pair tiles) for wider ones, tiles halved (down to 8 pairs)
    while they are fewer than the card's SMs; a window of twice the tile's
    pairs in rows, at most 256; whole rows while the window's rows fit 100
    KB, else two 48 KB stages of row chunks whose pitch is skewed by the
    lanes per pair (:func:`window_skew`) past a multiple of 32 words.

    A given ``(tile, rows, chunk)`` is checked as ``given_plan`` there
    checks it and reported the same way (a chunk of at least ``w`` words
    stages whole rows and is reported as ``w``); one the kernel cannot run
    raises ``ValueError`` with the library's text (:data:`WINDOW_PLAN_ERRORS`).
    No check depends on ``q``."""
    tile, rows, chunk = RULE_PLAN if plan is None else (int(x) for x in tuple(plan)[:3])
    if (tile, rows, chunk) == RULE_PLAN:
        tile = WINDOW_TILE_NARROW if w <= WINDOW_NARROW else WINDOW_TILE_WIDE
        while tile > WINDOW_TILE_MIN and -(-q // tile) < WINDOW_SMS:
            tile //= 2
        tile, rows, chunk = rule_at_tile(w, tile)
        if chunk >= w:
            return WindowPlan(tile, rows, w, 1, rows * w * 4 + 16)
        return WindowPlan(tile, rows, chunk, 2, 2 * rows * (chunk + 4) * 4)
    code = 0
    if not (WINDOW_TILE_MIN <= tile <= WINDOW_TILE_NARROW and tile & (tile - 1) == 0):
        code = -1
    elif not 1 <= rows <= WINDOW_ROWS_MAX:
        code = -2
    elif chunk < 1:
        code = -3
    elif chunk >= w:
        out = WindowPlan(tile, rows, w, 1, rows * w * 4 + 16)
    elif (chunk + 4) % 32 != window_skew(tile):
        code = -3
    else:
        out = WindowPlan(tile, rows, chunk, 2, 2 * rows * (chunk + 4) * 4)
    if code == 0 and out.smem > WINDOW_SMEM_MAX:
        code = -4
    if code:
        raise ValueError(f"{(tile, rows, chunk)} for {w}-word rows: "
                         f"{WINDOW_PLAN_ERRORS[code]}")
    return out


_BOUND = False
_STATE: dict = {}           # (device index, stream) -> [state words, last epoch]


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        lib.fused_pairs_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _P]
        lib.fused_pairs_launch.restype = ctypes.c_int
        lib.compact_state_words.argtypes = [ctypes.c_longlong]
        lib.compact_state_words.restype = ctypes.c_longlong
        lib.compact_max_epoch.restype = ctypes.c_ulonglong
        lib.compact_pairs_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, ctypes.c_int, _P, ctypes.c_ulonglong, _P,
            _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib.compact_pairs_launch.restype = ctypes.c_int
        lib.compact_shape_of.argtypes = [ctypes.c_int, ctypes.c_int, _P]
        lib.compact_shape_of.restype = ctypes.c_int
        lib.partial_pairs_launch.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib.partial_pairs_launch.restype = ctypes.c_int
        lib.window_plan_of.argtypes = [ctypes.c_longlong, ctypes.c_int, _P]
        lib.window_plan_of.restype = None
        lib.window_plan_check.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, _P]
        lib.window_plan_check.restype = ctypes.c_int
        _BOUND = True
    return lib


# K2's tiles (csrc/fused_intersect.cu Shape<G>), by lanes per pair: pairs a
# tile, pairs a group of lanes takes one after the other, elements of a row
# each lane has in flight per step of its loop, and the resident blocks per
# SM of the fused front end (its __launch_bounds__).  The CPU's cost model
# reads them here; on the card cuda_compact_shape holds them to the library.
COMPACT_LANES = (8, 16, 32)
COMPACT_TILE_PAIRS = {8: 128, 16: 64, 32: 8}
COMPACT_PAIRS_PER_GROUP = {8: 4, 16: 4, 32: 1}
COMPACT_UNROLL = {8: 4, 16: 4, 32: 8}
COMPACT_BLOCKS_PER_SM = {8: 3, 16: 4, 32: 1}


def elem_words(w: int) -> int:
    """Words of one element K2 loads for a ``w``-word row: 4 (16 bytes)
    where ``w`` is a multiple of 4, else 1.  (The kernel also needs the
    frontier and its output 16-byte aligned for 4, which the port's
    allocations are.)"""
    return 4 if w % 4 == 0 else 1


def rule_lanes(w: int) -> int:
    """K2's lanes per pair by its rule (``lanes=0``): 8 for rows of at most
    64 elements, else 32 (``csrc/fused_intersect.cu`` ``rule_lanes``)."""
    return 8 if w // elem_words(w) <= 64 else 32


def compact_shape(lanes: int) -> tuple:
    """K2's geometry at ``lanes`` lanes per pair as this module holds it:
    ``(lanes, pairs a tile, pairs a group, elements in flight per lane,
    blocks per SM of the fused front end)``."""
    g = int(lanes)
    return (g, COMPACT_TILE_PAIRS[g], COMPACT_PAIRS_PER_GROUP[g],
            COMPACT_UNROLL[g], COMPACT_BLOCKS_PER_SM[g])


def cuda_compact_shape(lanes: int, w: int) -> tuple:
    """K2's geometry as the built library has it (0 = the rule's lanes for
    ``w``): :func:`compact_shape`'s five fields, then the blocks per SM of
    the given-mask front end; for the checks that hold the two equal."""
    out = (ctypes.c_int * 6)()
    if _lib().compact_shape_of(int(lanes), int(w), ctypes.cast(out, _P)) != 0:
        raise ValueError(f"K2 takes no {lanes} lanes per pair")
    return tuple(out)


def cuda_window_plan(q: int, w: int, plan=None) -> WindowPlan:
    """The plan as the built CUDA library computes it: the rule
    (``window_plan_of``) for ``plan=None``, else the check of a given
    ``(tile, rows, chunk)`` (``window_plan_check``; a refusal raises
    ``ValueError`` with the library's text).  For the checks that hold it
    to :func:`window_plan`."""
    out = (ctypes.c_int * 5)()
    if plan is None:
        _lib().window_plan_of(int(q), int(w), ctypes.cast(out, _P))
        return WindowPlan(*out)
    tile, rows, chunk = (int(x) for x in tuple(plan)[:3])
    code = _lib().window_plan_check(int(q), int(w), tile, rows, chunk,
                                    ctypes.cast(out, _P))
    if code:
        raise ValueError(f"{(tile, rows, chunk)} for {w}-word rows: "
                         f"{_build.library().cuda_error_string(code).decode()}")
    return WindowPlan(*out)


def _plan(plan, kernel, q, w, mode, device) -> tuple:
    """The ``(tile, rows, chunk)`` of a K1 or K3 launch: ``plan`` as given
    (``(0, 0, 0)`` = the rule; the library checks it), or for ``None`` the
    autotune table's plan for this shape class on this card, else the rule.
    A host lookup, no synchronisation."""
    if plan is None:
        from .. import autotune
        cfg = autotune.table_config(kernel, q, w, mode, device)
        return tuple(cfg.plan) if cfg is not None else RULE_PLAN
    return tuple(int(x) for x in tuple(plan)[:3])


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


def launch_pairs(bitmaps, left, right, sup_left, min_sup: int, *, mode: int,
                 plan=RULE_PLAN, store: bool = True):
    """One launch of K1 with ``plan`` (``(tile, rows, chunk)``; ``(0, 0,
    0)`` = the rule), counted on no wrapper: the tuner's launches
    (``kernels.autotune``, which counts them itself) and the wrappers'.
    Returns ``(inter or None, sup, mask)``; a refused plan raises
    ``ValueError`` and launches nothing."""
    _check_args(bitmaps, left, right, sup_left, mode)
    q, w = left.shape[0], bitmaps.shape[1]
    dev = bitmaps.device
    inter = torch.empty((q, w), dtype=torch.int32, device=dev) if store else None
    sup = torch.empty(q, dtype=torch.int32, device=dev)
    mask = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        if not -2**31 <= int(min_sup) < 2**31:
            raise ValueError(f"min_sup {min_sup} does not fit the kernel's int32")
        tile, rows, chunk = (int(x) for x in tuple(plan)[:3])
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().fused_pairs_launch(
            _ptr(bitmaps), _ptr(left), _ptr(right), _ptr(sup_left), _ptr(inter),
            _ptr(sup), _ptr(mask), q, w, int(mode), int(min_sup), tile, rows,
            chunk, dev.index, ctypes.c_void_p(stream))
        _build.check(code, "fused_pairs_kernel")
    return inter, sup, mask


def fused_intersect_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                          right: torch.Tensor, sup_left: torch.Tensor,
                          min_sup: int, *, mode: int, plan=None):
    """(P, W) int32 frontier x (Q,) int32 pair indices ->
    ((Q, W) int32 intersections, (Q,) int32 supports, (Q,) int32 mask).

    ``min_sup`` is a host integer and a runtime argument of the kernel.
    ``plan``: ``(tile, rows, chunk)``, ``(0, 0, 0)`` for the rule, ``None``
    for the autotune table's plan of this shape on this card, else the
    rule; every plan gives the same bits.
    """
    _check_args(bitmaps, left, right, sup_left, mode)
    q, w = left.shape[0], bitmaps.shape[1]
    res = launch_pairs(bitmaps, left, right, sup_left, min_sup, mode=mode,
                       plan=_plan(plan, "pairs", q, w, mode, bitmaps.device))
    if q:
        fused_intersect_pairs.launches += 1
    return res


fused_intersect_pairs.launches = 0


def fused_support_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor, sup_left: torch.Tensor,
                        min_sup: int, *, mode: int, plan=None):
    """:func:`fused_intersect_pairs` without the ``(Q, W)`` store:
    ``((Q,) int32 supports, (Q,) int32 mask)``; ``plan`` as there."""
    _check_args(bitmaps, left, right, sup_left, mode)
    q, w = left.shape[0], bitmaps.shape[1]
    _, sup, mask = launch_pairs(bitmaps, left, right, sup_left, min_sup,
                                mode=mode, store=False,
                                plan=_plan(plan, "pairs", q, w, mode, bitmaps.device))
    if q:
        fused_intersect_pairs.launches += 1
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


def _lanes(lanes, kernel, q, w, mode, device) -> int:
    """The lanes per pair of a K2 launch: ``lanes`` as given (0 = the rule),
    or for ``None`` the autotune table's pick for this shape class on this
    card, else the rule.  A host lookup, no synchronisation."""
    if lanes is None:
        from .. import autotune
        cfg = autotune.table_config(kernel, q, w, mode, device)
        return cfg.lanes if cfg is not None and cfg.lanes else 0
    if lanes not in (0,) + COMPACT_LANES:
        raise ValueError(f"lanes must be one of {COMPACT_LANES} (or 0 for the "
                         f"rule), got {lanes!r}")
    return int(lanes)


def _compact(bitmaps, left, right, sup_left, sup, mask, mask_in, n_valid,
             min_sup, mode, lanes):
    """Launch the compaction (one kernel, ``lanes`` lanes per pair, 0 = the
    rule) and return ``(out, n_surv)``; the caller counts the launch."""
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
        q, w, int(n_valid), int(min_sup), int(mode), int(lanes), dev.index,
        ctypes.c_void_p(stream))
    if code != 0:
        # a launch that failed may leave the state dirty: start afresh
        _STATE.pop((dev.index, stream), None)
    _build.check(code, "compact_pairs_kernel")
    return out, n_surv


def launch_compact(bitmaps, left, right, sup_left, min_sup: int, n_valid: int,
                   *, mode: int, lanes: int):
    """One launch of K2's fused front end with ``lanes`` lanes per pair (0 =
    the rule), counted on no wrapper: the tuner's launches
    (``kernels.autotune``, which counts them itself).  Returns what
    :func:`fused_intersect_compact_pairs` returns."""
    _check_args(bitmaps, left, right, sup_left, mode)
    q = left.shape[0]
    sup = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    mask = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    out, n_surv = _compact(bitmaps, left, right, sup_left, sup, mask, False,
                           n_valid, min_sup, mode, lanes)
    return out, sup, mask, n_surv


def fused_intersect_compact_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                                  right: torch.Tensor, sup_left: torch.Tensor,
                                  min_sup: int, n_valid: int, *, mode: int,
                                  lanes: Optional[int] = None):
    """:func:`fused_intersect_pairs` with survivor compaction on the card:
    returns ``(compact (Q, W), sup (Q,), mask (Q,), n_surv ())``.

    Survivors are the pairs with ``mask & (q < n_valid)`` (pairs at or past
    ``n_valid`` are bucket padding).  ``compact[:n_surv]`` holds their
    intersections in ascending pair order, rows ``[n_surv:]`` duplicate the
    intersection of pair 0, and the returned mask is the valid-masked one.
    One launch computes, thresholds and compacts, pad rows included.  No
    host synchronisation happens inside.  ``lanes`` (8, 16 or 32 lanes per
    pair, 0 = the rule; ``None`` = the autotune table's pick for this shape
    on this card, else the rule) picks the tile; every tile gives the same
    bits.
    """
    _check_args(bitmaps, left, right, sup_left, mode)
    q, w = left.shape[0], bitmaps.shape[1]
    g = _lanes(lanes, "compact", q, w, mode, bitmaps.device)
    res = launch_compact(bitmaps, left, right, sup_left, min_sup, n_valid,
                         mode=mode, lanes=g)
    if q:
        fused_intersect_compact_pairs.launches += 1
    return res


def compact_survivors_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                            right: torch.Tensor, mask: torch.Tensor,
                            n_valid: int, *, mode: int,
                            lanes: Optional[int] = None):
    """The survivor compaction alone, from a mask computed elsewhere (the
    word-sharded backends reduce their counts over ranks first): returns
    ``(compact (Q, W), mask (Q,), n_surv ())`` as
    :func:`fused_intersect_compact_pairs` does.  ``mask`` (int32) is
    rewritten in place to the valid-masked flags.  ``lanes`` as there; the
    table's pick is the fused front end's for the same shape."""
    _check_args(bitmaps, left, right, None, mode, mask=mask)
    q, w = left.shape[0], bitmaps.shape[1]
    g = _lanes(lanes, "compact", q, w, mode, bitmaps.device)
    out, n_surv = _compact(bitmaps, left, right, None, None, mask, True,
                           n_valid, 0, mode, g)
    if q:
        fused_intersect_compact_pairs.launches += 1
    return out, mask, n_surv


fused_intersect_compact_pairs.launches = 0


def launch_partial(bitmaps, left, right, *, mode: int, plan=RULE_PLAN,
                   store: bool = True):
    """One launch of K3 with ``plan`` (``(0, 0, 0)`` = the rule), counted
    on no wrapper, as :func:`launch_pairs`.  Returns what
    :func:`fused_intersect_partial_pairs` returns."""
    _check_args(bitmaps, left, right, None, mode)
    q, w = left.shape[0], bitmaps.shape[1]
    dev = bitmaps.device
    inter = torch.empty((q, w), dtype=torch.int32, device=dev) if store else None
    pop = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        tile, rows, chunk = (int(x) for x in tuple(plan)[:3])
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().partial_pairs_launch(
            _ptr(bitmaps), _ptr(left), _ptr(right), _ptr(inter), _ptr(pop),
            q, w, int(mode), tile, rows, chunk, dev.index,
            ctypes.c_void_p(stream))
        _build.check(code, "partial_pairs_kernel")
    return inter, pop


def fused_intersect_partial_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                                  right: torch.Tensor, *, mode: int,
                                  store: bool = True, plan=None):
    """(P, Ws) int32 frontier word slice x (Q,) int32 pair indices ->
    ``((Q, Ws) int32 intersections or None, (Q,) int32 partial popcounts)``.

    The shard-local half of :func:`fused_intersect_pairs`: it stops at the
    raw popcount of this slice (no support conversion, no threshold), which
    the caller sums over the ranks that hold the other slices.  With
    ``store=False`` the (Q, Ws) intersections are not written.  ``plan`` as
    for :func:`fused_intersect_pairs`, from the ``partial`` shape class of
    the table for ``None``.
    """
    _check_args(bitmaps, left, right, None, mode)
    q, w = left.shape[0], bitmaps.shape[1]
    res = launch_partial(bitmaps, left, right, mode=mode, store=store,
                         plan=_plan(plan, "partial", q, w, mode, bitmaps.device))
    if q:
        fused_intersect_partial_pairs.launches += 1
    return res


fused_intersect_partial_pairs.launches = 0
