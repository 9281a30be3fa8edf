"""ctypes binding of the grouped decode-attention CUDA kernel
(``csrc/decode_attention.cu``), with its launch counter
``decode_attention.launches`` and ``decode_attention.rows_launches``, the
launches by the rows of the cache they read (a self-attention cache's
capacity, or whisper's 1,500 encoder rows in a cross-attention step).

The cache is read through its strides (a layer's slice of the stacked
per-stage cache is passed as it is); ``length`` stays on the card and the
kernel reads it, so a decode step makes no host round trip.  The kernel
splits the cache into chunks of ``CHUNK`` rows over its blocks and merges
their fp32 partials in one launch: the partials go to scratch allocated
here with ``torch.empty``, and the last block of each (b, KV head) finds
itself through a ticket counter, an int32 buffer kept per (device, stream),
zeroed once and reset to zero by the kernel itself (no memset per call).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._layout import rows_of_16_bytes

__all__ = ["decode_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUPS = tuple(range(1, 9))   # query heads per KV head the kernel takes
CHUNK = 64                  # cache rows per block; csrc's kChunk
_BOUND = False
_TICKETS: dict = {}         # (device index, stream) -> int32 tickets


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
            i, i, vp]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_chunk.restype = ctypes.c_int
        if lib.decode_attention_chunk() != CHUNK:
            raise RuntimeError("decode_attention.CHUNK differs from the "
                               "CUDA source's chunk")
        _BOUND = True
    return lib


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 tickets for launches on ``stream``, all zero
    between launches (the kernel resets the ones it takes)."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, *, window: int = 0,
                     sm_scale=None, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, KV, G, D); k/v: (B, S, KV, D); length: (B,) int32, all on the
    card, q/k/v float32 or bfloat16 -> (B, KV, G, D) in q's dtype.  Rows
    ``s < length[b]`` count (and ``s > length[b] - 1 - window`` when
    ``window > 0``); a length above S counts as S.  G from 1 to 8.
    ``softcap`` > 0 caps each score x at ``softcap * tanh(x / softcap)``
    before the softmax (0 = none)."""
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
        raise ValueError(f"group size {g}: the kernel takes 1 to {GROUPS[-1]} "
                         "query heads per KV head")
    if d % 8 or d > 256:
        raise ValueError(f"head_dim {d}: the kernel takes a multiple of 8 up "
                         "to 256")
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = none), got {window}")
    if not softcap >= 0:
        raise ValueError(f"softcap must be >= 0 (0 = none), got {softcap}")
    if s == 0:
        raise ValueError("the cache has no rows")
    if sm_scale is None:
        sm_scale = d ** -0.5
    q = rows_of_16_bytes(q.contiguous())
    k, v = rows_of_16_bytes(k), rows_of_16_bytes(v)
    length = length.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    n_split = -(-s // CHUNK)    # blocks per (b, KV head), from the capacity
    part_acc = torch.empty((b * kv, n_split, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b * kv, n_split, g, 2), dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, b * kv)
    code = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        tickets.data_ptr(), _DTYPES[q.dtype], b, kv, g, s, d, strides,
        float(sm_scale), float(softcap), int(window), q.device.index, stream)
    _build.check(code, "decode_attention_split_kernel")
    decode_attention.launches += 1
    decode_attention.rows_launches[s] = decode_attention.rows_launches.get(s, 0) + 1
    return out


decode_attention.launches = 0
decode_attention.rows_launches = {}
