"""ctypes binding of the co-occurrence CUDA kernel (``csrc/trimatrix.cu``),
with its launch counter ``trimatrix.launches``."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["trimatrix"]

_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        lib.trimatrix_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.trimatrix_launch.restype = ctypes.c_int
        _BOUND = True
    return lib


def trimatrix(bitmaps: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 words on the card -> (N, N) int32 co-occurrence counts
    ``C[i, j] = sum_w popcount(B[i, w] & B[j, w])`` (full symmetric matrix;
    the diagonal holds the row supports)."""
    if bitmaps.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {bitmaps.device}")
    if bitmaps.ndim != 2 or bitmaps.dtype != torch.int32:
        raise ValueError(f"expected (N, W) int32 words, got "
                         f"{tuple(bitmaps.shape)} {bitmaps.dtype}")
    bitmaps = bitmaps.contiguous()
    n, w = bitmaps.shape
    if n > 65535 * 64:
        raise ValueError(f"N={n} exceeds the kernel's grid (65535 tiles of 64)")
    out = torch.empty((n, n), dtype=torch.int32, device=bitmaps.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(bitmaps.device).cuda_stream
    code = _lib().trimatrix_launch(ctypes.c_void_p(bitmaps.data_ptr()),
                                   ctypes.c_void_p(out.data_ptr()), n, w,
                                   bitmaps.device.index, ctypes.c_void_p(stream))
    _build.check(code, "trimatrix_kernel")
    trimatrix.launches += 1
    return out


trimatrix.launches = 0
