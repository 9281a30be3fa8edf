"""Dispatch for grouped decode attention: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain torch version.  On a CUDA
tensor the kernel runs or the call raises."""
from __future__ import annotations

from .decode_attention import decode_attention
from .ref import decode_attention_ref

__all__ = ["grouped_decode_attention"]


def grouped_decode_attention(q, k, v, length, *, window=0, sm_scale=None,
                             softcap=0.0):
    """q: (B, KV, G, D); k/v cache: (B, S, KV, D); length: (B,) int32 valid
    rows per sequence -> (B, KV, G, D).  ``window`` 0 means no window;
    ``softcap`` 0 means no logit soft-cap."""
    if q.device.type == "cuda":
        return decode_attention(q, k, v, length, window=window,
                                sm_scale=sm_scale, softcap=softcap)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, length, window=window,
                                    sm_scale=sm_scale, softcap=softcap)
    raise ValueError(f"no decode-attention path for device {q.device}")
