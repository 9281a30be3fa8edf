"""Plain torch version of flash attention (materializes the score matrix):
the oracle the CUDA kernels are held to, and the path :mod:`.ops` takes for
CPU tensors.  Mirrors the reference package's ``attention_ref``.

:func:`attention_split_p_ref` emulates the arithmetic of the bf16 tensor-core
kernel (the probabilities split into two bf16 terms before the PV
product); only the tests and ``chip_smoke.py`` use it."""
from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_split_p_ref"]


def _probabilities(q, k, causal, window, sm_scale):
    """Unnormalised softmax numerators exp(s - rowmax) in fp32, (B, H, S, S),
    and the group size H / Hkv."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kk = k.repeat_interleave(group, dim=1)
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
    return torch.exp(scores - scores.amax(dim=-1, keepdim=True)), group


def attention_ref(q, k, v, *, causal=True, window=None, sm_scale=None):
    """q: (B, H, S, D); k/v: (B, Hkv, S, D) -> (B, H, S, D), fp32 math.

    ``window=None`` means no window; ``window=w`` keeps the columns
    ``j > i - w`` (so ``w=0`` keeps none, as in the reference).
    """
    p, group = _probabilities(q, k, causal, window, sm_scale)
    p = p / p.sum(dim=-1, keepdim=True)
    vv = v.repeat_interleave(group, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)


def attention_split_p_ref(q, k, v, *, causal=True, window=None,
                          sm_scale=None):
    """The bf16 kernel's arithmetic: scores in fp32 from the inputs' values,
    the probabilities p = exp(s - max) in fp32 split into two bf16 terms,
    p_hi = bf16(p) and p_lo = bf16(p - p_hi), as the kernel runs them
    through two PV products, the PV sums in fp32, normalised by the fp32
    sum of p.  Returns float32 (B, H, S, D): the caller rounds it as the
    kernel's store would.  Masks and ``window`` as in :func:`attention_ref`.
    The kernel takes the max per 64-column tile and rescales (online
    softmax); that changes p by fp32 roundings only."""
    p, group = _probabilities(q, k, causal, window, sm_scale)
    p_hi = p.to(torch.bfloat16)
    p_lo = (p - p_hi.float()).to(torch.bfloat16)
    vv = v.repeat_interleave(group, dim=1).float()
    out = (torch.einsum("bhqk,bhkd->bhqd", p_hi.float(), vv)
           + torch.einsum("bhqk,bhkd->bhqd", p_lo.float(), vv))
    return out / p.sum(dim=-1, keepdim=True)
