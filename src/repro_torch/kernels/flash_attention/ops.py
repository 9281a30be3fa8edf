"""Dispatch for flash attention: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the plain torch version.  On a CUDA tensor the
kernel runs or the call raises."""
from __future__ import annotations

from .flash_attention import flash_attention
from .ref import attention_ref

__all__ = ["multi_head_attention"]


def multi_head_attention(q, k, v, *, causal=True, window=None, sm_scale=None):
    """q: (B, H, S, D); k/v: (B, Hkv, S, D) -> (B, H, S, D).

    ``window`` 0 and ``None`` both mean no window: the model passes 0 for
    its global layers, the reference kernel tests ``window is not None``.
    This is the one place that maps the two.
    """
    window = window or None
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window or 0,
                               sm_scale=sm_scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)
    raise ValueError(f"no attention path for device {q.device}")
