"""Plain torch version of flash attention (materializes the score matrix):
the oracle the CUDA kernels are held to, and the path :mod:`.ops` takes for
CPU tensors.  Mirrors the reference package's ``attention_ref``.

:func:`attention_split_p_ref` emulates the arithmetic of the bf16 tensor-core
kernel (the probabilities split into two bf16 terms before the PV
product); only the tests and ``chip_smoke.py`` use it.

:func:`attention_lse_ref` and :func:`attention_ref_bwd` are the plain
versions of the forward's row log-sum-exp and of the backward kernels
(``csrc/flash_attention_bwd.cu``); :func:`attention_bwd_bf16_ref` emulates
the arithmetic of the bf16 backward kernels (P and dS rounded once to
bf16), for the tests and ``chip_smoke.py``."""
from __future__ import annotations

import torch

from .._softcap import softcap as _capped

__all__ = ["attention_ref", "attention_split_p_ref", "attention_lse_ref",
           "attention_ref_bwd", "attention_bwd_bf16_ref"]


def _mask(s, sk, causal, window, device):
    """(S, Sk) bool: the columns each query row keeps (the reference
    model's ``flash_chunked`` masks)."""
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def _scores(q, k, causal, window, sm_scale, softcap=0.0):
    """Masked scores q k^T * scale in fp32, (B, H, S, Sk) (masked entries
    -1e30), the mask and the group size H / Hkv.  ``softcap`` > 0 caps the
    scaled scores at ``tanh(x / softcap) * softcap`` before the mask, as the
    reference model's ``flash_chunked`` does."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kk = k.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * sm_scale
    scores = _capped(scores, softcap)
    mask = _mask(s, k.shape[2], causal, window, q.device)
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(-1e30, device=q.device))
    return scores, mask, group


def _probabilities(q, k, causal, window, sm_scale, softcap):
    """Unnormalised softmax numerators exp(s - rowmax) in fp32, (B, H, S, Sk),
    and the group size H / Hkv."""
    scores, _, group = _scores(q, k, causal, window, sm_scale, softcap)
    return torch.exp(scores - scores.amax(dim=-1, keepdim=True)), group


def attention_ref(q, k, v, *, causal=True, window=None, sm_scale=None,
                  softcap=0.0):
    """q: (B, H, S, D); k/v: (B, Hkv, Sk, D) -> (B, H, S, D), fp32 math
    (Sk = S for self-attention; the kernel takes Sk != S non-causal only).

    ``window=None`` means no window; ``window=w`` keeps the columns
    ``j > i - w`` (so ``w=0`` keeps none, as in the reference).
    ``softcap`` 0 means no logit soft-cap.
    """
    p, group = _probabilities(q, k, causal, window, sm_scale, softcap)
    p = p / p.sum(dim=-1, keepdim=True)
    vv = v.repeat_interleave(group, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)


def attention_split_p_ref(q, k, v, *, causal=True, window=None,
                          sm_scale=None, softcap=0.0):
    """The bf16 kernel's arithmetic: scores in fp32 from the inputs' values,
    the probabilities p = exp(s - max) in fp32 split into two bf16 terms,
    p_hi = bf16(p) and p_lo = bf16(p - p_hi), as the kernel runs them
    through two PV products, the PV sums in fp32, normalised by the fp32
    sum of p.  Returns float32 (B, H, S, D): the caller rounds it as the
    kernel's store would.  Masks and ``window`` as in :func:`attention_ref`.
    The kernel takes the max per 64-column tile and rescales (online
    softmax); that changes p by fp32 roundings only.  ``softcap`` as in
    :func:`attention_ref` (the kernel forms the cap with tanhf)."""
    p, group = _probabilities(q, k, causal, window, sm_scale, softcap)
    p_hi = p.to(torch.bfloat16)
    p_lo = (p - p_hi.float()).to(torch.bfloat16)
    vv = v.repeat_interleave(group, dim=1).float()
    out = (torch.einsum("bhqk,bhkd->bhqd", p_hi.float(), vv)
           + torch.einsum("bhqk,bhkd->bhqd", p_lo.float(), vv))
    return out / p.sum(dim=-1, keepdim=True)


def attention_lse_ref(q, k, *, causal=True, window=None, sm_scale=None,
                      softcap=0.0):
    """(B, H, S) float32: each row's natural log-sum-exp of its kept scores
    q k^T * scale (capped where ``softcap`` > 0), the forward kernels'
    ``lse`` (``window`` as in :func:`attention_ref`)."""
    scores, mask, _ = _scores(q, k, causal, window, sm_scale, softcap)
    return torch.logsumexp(scores.masked_fill(~mask[None, None], float("-inf")),
                           dim=-1)


def _recomputed(q, k, lse, causal, window, sm_scale, softcap):
    """P = exp(c(s) - lse) of the kept pairs (0 elsewhere), (B, H, S, Sk)
    float32, the factor P c' of the chain rule through the cap (c' = 1 -
    t^2, t = tanh(s / softcap); P itself without a cap), the group size and
    the scale: what the backward kernels recompute from the forward's
    ``lse``."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    scores, mask, group = _scores(q, k, causal, window, sm_scale)
    zero = torch.zeros((), device=q.device)
    if softcap:
        t = torch.tanh(scores / softcap)
        p = torch.where(mask[None, None],
                        torch.exp(t * softcap - lse.float()[..., None]), zero)
        return p, p * (1.0 - t * t), group, sm_scale
    p = torch.where(mask[None, None], torch.exp(scores - lse.float()[..., None]),
                    zero)
    return p, p, group, sm_scale


def attention_ref_bwd(q, k, v, out, dout, lse, *, causal=True, window=None,
                      sm_scale=None, softcap=0.0):
    """Gradients of :func:`attention_ref` by the textbook formula, the plain
    version of the backward kernels: P recomputed from ``lse`` (the
    forward's row log-sum-exp, natural log), then ``dV = P^T dO``,
    ``dP = dO V^T``, ``dS = P c' * (dP - rowsum(dO * O))``, ``dQ = dS K *
    scale``, ``dK = dS^T Q * scale``; dK and dV summed over the G query
    heads of each KV head.  ``softcap`` > 0: the scores capped at ``c(x) =
    softcap tanh(x / softcap)`` as in the forward (``lse`` the forward's of
    the capped scores) and ``c' = 1 - tanh(x / softcap)^2``; 0: ``c' = 1``.
    q, out, dout: (B, H, S, D); k, v: (B, Hkv, Sk, D) -> ``(dq, dk, dv)``
    in float32 (Sk != S, keys that are not the queries, as the kernels
    take it: non-causal, no window).  ``window`` as in
    :func:`attention_ref` (``None`` = none)."""
    b, h, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    p, pc, group, sm_scale = _recomputed(q, k, lse, causal, window, sm_scale,
                                         softcap)
    qf, gf, of = q.float(), dout.float(), out.float()
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    delta = (gf * of).sum(-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vv)
    ds = pc * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * sm_scale
    dk = dk.reshape(b, hkv, group, sk, d).sum(2)
    dv = dv.reshape(b, hkv, group, sk, d).sum(2)
    return dq, dk, dv


def attention_bwd_bf16_ref(q, k, v, out, dout, lse, *, causal=True,
                           window=None, sm_scale=None, softcap=0.0):
    """The bf16 backward kernels' arithmetic: scores and dP in fp32 from the
    inputs' values, P = exp(c(s * scale) - lse) in fp32, ``delta`` the fp32
    rowsum of dout * out, ``dS = (P c') (dP - delta)`` from the fp32 P (the
    product P c' taken first, as the kernels hand it over; ``softcap`` and
    c' as in :func:`attention_ref_bwd`); then P
    (for dV) and dS (for dQ and dK) rounded once to bf16 before their
    products, the products summed in fp32, dK and dV summed over the G
    query heads of each KV head in head order (the kernels' split order:
    partials of consecutive heads added first to last), dQ and dK scaled
    after their sums.  Arguments as :func:`attention_ref_bwd`; returns
    float32 ``(dq, dk, dv)``: the caller rounds them as the kernels'
    stores would.  The kernels take exp2 of log2-scaled values; that
    changes P by fp32 roundings only."""
    b, h, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    p, pc, group, sm_scale = _recomputed(q, k, lse, causal, window, sm_scale,
                                         softcap)
    qf, gf, of = q.float(), dout.float(), out.float()
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    delta = (gf * of).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vv)
    ds = (pc * (dp - delta[..., None])).to(torch.bfloat16).float()
    p = p.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * sm_scale
    dk_h = torch.einsum("bhqk,bhqd->bhkd", ds, qf).reshape(b, hkv, group, sk, d)
    dv_h = torch.einsum("bhqk,bhqd->bhkd", p, gf).reshape(b, hkv, group, sk, d)
    dk, dv = dk_h[:, :, 0], dv_h[:, :, 0]
    for g in range(1, group):
        dk = dk + dk_h[:, :, g]
        dv = dv + dv_h[:, :, g]
    return dq, dk * sm_scale, dv
