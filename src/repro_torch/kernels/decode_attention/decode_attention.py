"""ctypes binding of the grouped decode-attention CUDA kernel
(``csrc/decode_attention.cu``), with its launch counter
``decode_attention.launches``.

The cache is read through its strides (a layer's slice of the stacked
per-stage cache is passed as it is); ``length`` stays on the card and the
kernel reads it, so a decode step makes no host round trip.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._layout import rows_of_16_bytes

__all__ = ["decode_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUPS = (1, 2, 4, 8)
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [
            vp, vp, vp, vp, vp, i, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, vp]
        lib.decode_attention_launch.restype = ctypes.c_int
        _BOUND = True
    return lib


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, *, window: int = 0,
                     sm_scale=None) -> torch.Tensor:
    """q: (B, KV, G, D); k/v: (B, S, KV, D); length: (B,) int32, all on the
    card, q/k/v float32 or bfloat16 -> (B, KV, G, D) in q's dtype.  Rows
    ``s < length[b]`` count (and ``s > length[b] - 1 - window`` when
    ``window > 0``); a length above S counts as S.  G in {1, 2, 4, 8}."""
    for name, t in (("q", q), ("k", k), ("v", v), ("length", length)):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {name} "
                             f"on {t.device}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"expected q (B, KV, G, D) and k/v (B, S, KV, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != v.dtype or k.dtype not in _DTYPES:
        raise ValueError(f"expected float32 or bfloat16, got q {q.dtype}, "
                         f"k {k.dtype}, v {v.dtype}")
    if k.dtype != q.dtype:
        # the kernel reads q and the cache in one type; the model stores
        # the cache in its own dtype, which is q's
        raise ValueError(f"q ({q.dtype}) and the cache ({k.dtype}) differ")
    b, kv, g, d = q.shape
    _, s, kv2, d2 = k.shape
    if (kv2 != kv or d2 != d or v.shape != k.shape or k.shape[0] != b
            or tuple(length.shape) != (b,)):
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)} length={tuple(length.shape)}")
    if length.dtype != torch.int32:
        raise ValueError(f"length must be int32, got {length.dtype}")
    if g not in GROUPS:
        raise ValueError(f"group size {g}: the kernel takes {GROUPS}")
    if d % 8 or d > 256:
        raise ValueError(f"head_dim {d}: the kernel takes a multiple of 8 up "
                         "to 256")
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = none), got {window}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    q = rows_of_16_bytes(q.contiguous())
    k, v = rows_of_16_bytes(k), rows_of_16_bytes(v)
    length = length.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], b, kv, g, s, d, strides,
        float(sm_scale), int(window), q.device.index, stream)
    _build.check(code, "decode_attention_kernel")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
