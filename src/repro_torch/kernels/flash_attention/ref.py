"""Plain torch version of flash attention (materializes the score matrix):
the oracle the CUDA kernel is held to, and the path :mod:`.ops` takes for
CPU tensors.  Mirrors the reference package's ``attention_ref``."""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, causal=True, window=None, sm_scale=None):
    """q: (B, H, S, D); k/v: (B, Hkv, S, D) -> (B, H, S, D), fp32 math.

    ``window=None`` means no window; ``window=w`` keeps the columns
    ``j > i - w`` (so ``w=0`` keeps none, as in the reference).
    """
    b, h, s, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * sm_scale
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(-1e30, device=q.device))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)
