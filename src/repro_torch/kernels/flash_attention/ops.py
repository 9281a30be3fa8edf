"""Dispatch for flash attention: a CUDA tensor goes to the hand-written
kernels, a CPU tensor to the plain torch version.  On a CUDA tensor the
kernels run or the call raises.

:class:`FlashAttentionFunction` makes the kernel differentiable: its
forward launches the forward kernel with the rows' log-sum-exp when an
input needs a gradient, and its backward launches the backward kernels.
On a CPU tensor autograd runs through :func:`.ref.attention_ref`.  Both
directions take the logit soft-cap (grok's 30): the backward kernels'
capped instances; and keys that are not the queries (Sk != S, whisper's
cross-attention), non-causal and without a window, as the forward does.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .._layout import rows_of_16_bytes
from .flash_attention import flash_attention, flash_attention_bwd
from .ref import attention_ref

__all__ = ["multi_head_attention", "FlashAttentionFunction"]


class FlashAttentionFunction(torch.autograd.Function):
    """K6 forward and backward on the card.  Saves the q, k and v the
    forward kernel read (their 16-byte-row copies where it made one), its
    output and ``lse``.  With ``train`` false (no input needs a gradient, or
    grad mode is off: serving, ``torch.no_grad``) the forward writes no
    ``lse`` and saves nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, softcap, train):
        ctx.attn = dict(causal=causal, window=window, sm_scale=sm_scale)
        ctx.softcap = softcap
        if not train:
            return flash_attention(q, k, v, softcap=softcap, **ctx.attn)
        q, k, v = rows_of_16_bytes(q), rows_of_16_bytes(k), rows_of_16_bytes(v)
        out, lse = flash_attention(q, k, v, softcap=softcap, return_lse=True,
                                   **ctx.attn)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         softcap=ctx.softcap, **ctx.attn)
        return dq, dk, dv, None, None, None, None, None


def multi_head_attention(q, k, v, *, causal=True, window=None, sm_scale=None,
                         softcap=0.0):
    """q: (B, H, S, D); k/v: (B, Hkv, Sk, D) -> (B, H, S, D), differentiable
    (Sk != S only with ``causal=False`` and no window: the kernels refuse
    the rest before they look for a card; the plain version on the CPU
    takes any).

    ``window`` 0 and ``None`` both mean no window: the model passes 0 for
    its global layers, the reference kernel tests ``window is not None``.
    This is the one place that maps the two.  ``softcap`` 0 means no logit
    soft-cap.
    """
    window = window or None
    if q.device.type == "cuda":
        # inside a Function's forward grad mode is off, so it is read here
        train = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v))
        return FlashAttentionFunction.apply(q, k, v, bool(causal), window or 0,
                                            sm_scale, float(softcap), train)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale, softcap=softcap)
    raise ValueError(f"no attention path for device {q.device}")
