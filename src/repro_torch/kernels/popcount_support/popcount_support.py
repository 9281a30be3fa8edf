"""ctypes binding of the popcount-support CUDA kernel
(``csrc/popcount_support.cu``), with its launch counter
``popcount_support.launches``."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["popcount_support"]

_P = ctypes.c_void_p
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        lib.popcount_support_launch.argtypes = [
            _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
        lib.popcount_support_launch.restype = ctypes.c_int
        _BOUND = True
    return lib


def popcount_support(a: torch.Tensor, b: torch.Tensor):
    """(M, W) int32 words x2 on the card -> ((M, W) int32 ``a & b``, (M,)
    int32 per-row popcount sums)."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if a.ndim != 2 or a.shape != b.shape or a.device != b.device:
        raise ValueError(f"expected matching (M, W) operands on one device, "
                         f"got {tuple(a.shape)} {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    m, w = a.shape
    inter = torch.empty((m, w), dtype=torch.int32, device=a.device)
    sup = torch.empty(m, dtype=torch.int32, device=a.device)
    if m:
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = _lib().popcount_support_launch(
            _P(a.data_ptr()), _P(b.data_ptr()), _P(inter.data_ptr()),
            _P(sup.data_ptr()), m, w, a.device.index, _P(stream))
        _build.check(code, "popcount_support_kernel")
        popcount_support.launches += 1
    return inter, sup


popcount_support.launches = 0
