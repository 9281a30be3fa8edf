"""ctypes binding of the fused-intersect CUDA kernels
(``csrc/fused_intersect.cu``), with their launch counters.

Both functions take CUDA tensors only (the CPU path is :mod:`.ref`, chosen
by :mod:`.ops`); they allocate their outputs with ``torch.empty``, launch on
the current stream and do not synchronise.

Launch counters, plain integers on the wrappers:

``fused_intersect_pairs.launches``          launches of ``fused_pairs_kernel``,
                                            from any wrapper below
``fused_intersect_compact_pairs.launches``  launches of the survivor
                                            compaction (two-pass scan +
                                            gather)

The caller guarantees ``0 <= left, right < P``: checking that here would
copy the indices back to the host and stall the stream, so the engine checks
its pair lists on the host before upload.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["MODE_TIDSET", "MODE_TID_TO_DIFF", "MODE_DIFFSET",
           "fused_intersect_pairs", "fused_support_pairs",
           "fused_intersect_compact_pairs"]

MODE_TIDSET = 0
MODE_TID_TO_DIFF = 1
MODE_DIFFSET = 2

_P = ctypes.c_void_p
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        lib.fused_pairs_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib.fused_pairs_launch.restype = ctypes.c_int
        lib.survivor_scratch_ints.argtypes = [ctypes.c_longlong]
        lib.survivor_scratch_ints.restype = ctypes.c_longlong
        lib.survivor_compact_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
        lib.survivor_compact_launch.restype = ctypes.c_int
        _BOUND = True
    return lib


def _check_args(bitmaps, left, right, sup_left, mode):
    if bitmaps.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {bitmaps.device}")
    if bitmaps.ndim != 2:
        raise ValueError(f"expected a (P, W) frontier, got {tuple(bitmaps.shape)}")
    for name, t in (("bitmaps", bitmaps), ("left", left), ("right", right),
                    ("sup_left", sup_left)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != bitmaps.device:
            raise ValueError(f"{name} is on {t.device}, the frontier on {bitmaps.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if left.ndim != 1 or left.shape != right.shape or left.shape != sup_left.shape:
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
    ``((Q,) int32 supports, (Q,) int32 mask)``.  The compacting path runs
    this pass first."""
    _check_args(bitmaps, left, right, sup_left, mode)
    q = left.shape[0]
    sup = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    mask = torch.empty(q, dtype=torch.int32, device=bitmaps.device)
    if q:
        _launch_pairs(bitmaps, left, right, sup_left, None, sup, mask,
                      min_sup, mode)
    return sup, mask


def fused_intersect_compact_pairs(bitmaps: torch.Tensor, left: torch.Tensor,
                                  right: torch.Tensor, sup_left: torch.Tensor,
                                  min_sup: int, n_valid: int, *, mode: int):
    """:func:`fused_intersect_pairs` with survivor compaction on the card:
    returns ``(compact (Q, W), sup (Q,), mask (Q,), n_surv ())``.

    Survivors are the pairs with ``mask & (q < n_valid)`` (pairs at or past
    ``n_valid`` are bucket padding).  ``compact[:n_surv]`` holds their
    intersections in ascending pair order, rows ``[n_surv:]`` duplicate the
    intersection of pair 0, and the returned mask is the valid-masked one.
    No host synchronisation happens inside.
    """
    sup, mask = fused_support_pairs(bitmaps, left, right, sup_left, min_sup,
                                    mode=mode)
    q, w = left.shape[0], bitmaps.shape[1]
    dev = bitmaps.device
    out = torch.empty((q, w), dtype=torch.int32, device=dev)
    if q == 0:
        return out, sup, mask, torch.zeros((), dtype=torch.int32, device=dev)
    lib = _lib()
    scratch = torch.empty(lib.survivor_scratch_ints(q), dtype=torch.int32,
                          device=dev)
    n_surv = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.survivor_compact_launch(
        _ptr(bitmaps), _ptr(left), _ptr(right), _ptr(mask), _ptr(scratch),
        _ptr(n_surv), _ptr(out), q, w, int(n_valid), int(mode),
        dev.index, ctypes.c_void_p(stream))
    _build.check(code, "survivor compaction")
    fused_intersect_compact_pairs.launches += 1
    return out, sup, mask, n_surv


fused_intersect_compact_pairs.launches = 0
