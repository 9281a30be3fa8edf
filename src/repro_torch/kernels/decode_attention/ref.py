"""Plain torch version of grouped decode attention: the oracle the CUDA
kernel is held to, and the path :mod:`.ops` takes for CPU tensors.  Mirrors
the reference package's ``decode_attention_ref``."""
from __future__ import annotations

import torch

__all__ = ["decode_attention_ref"]


def decode_attention_ref(q, k, v, length, *, window=0, sm_scale=None):
    """q: (B, KV, G, D); k/v: (B, S, KV, D); length: (B,) -> (B, KV, G, D),
    fp32 math."""
    b, kv, g, d = q.shape
    s = k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * sm_scale
    cols = torch.arange(s, device=q.device)[None, :]
    length = length.to(q.device)[:, None]
    mask = cols < length
    if window:
        mask &= cols > (length - 1 - window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.tensor(-1e30, device=q.device))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgs,bskd->bkgd", p, v.float()).to(q.dtype)
