"""ctypes binding of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``), with its launch counter
``flash_attention.launches``.

The kernel reads q, k and v and writes the output through their strides, so
a (B, H, S, D) view of the model's (B, S, H, D) activations
(``x.transpose(1, 2)``) is passed as it is, with no transpose copy; the
output takes q's memory layout (``torch.empty_like``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._layout import rows_of_16_bytes

__all__ = ["flash_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            vp, vp, vp, vp, i, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, i, vp]
        lib.flash_attention_launch.restype = ctypes.c_int
        _BOUND = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale=None) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, Hkv, S, D) on the card, float32 or
    bfloat16 -> (B, H, S, D) in q's dtype.  ``window`` 0 means no window
    (:func:`.ops.multi_head_attention` maps ``None`` to 0).  Self-attention
    only: k and v have q's sequence length."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {name} "
                             f"on {t.device}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"expected float32 or bfloat16 q, k, v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, s, d = q.shape
    _, hkv, sk, dk = k.shape
    if (k.shape != v.shape or k.shape[0] != b or dk != d or hkv == 0
            or h % hkv):
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    if sk != s:
        raise ValueError(f"self-attention only: k has {sk} rows, q {s}")
    if d % 8 or d > 256:
        raise ValueError(f"head_dim {d}: the kernel takes a multiple of 8 up "
                         "to 256")
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = none), got {window}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    q, k, v = rows_of_16_bytes(q), rows_of_16_bytes(k), rows_of_16_bytes(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, h, hkv, s, d, strides, float(sm_scale),
        int(bool(causal)), int(window), q.device.index, stream)
    _build.check(code, "flash_attention_kernel")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
