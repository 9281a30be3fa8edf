"""Plain torch version of grouped decode attention: the oracle the CUDA
kernel is held to, and the path :mod:`.ops` takes for CPU tensors.  Mirrors
the reference package's ``decode_attention_ref``.

:func:`decode_attention_split_ref` emulates the kernel's split of the cache
into chunks and its merge in split order; only the tests use it."""
from __future__ import annotations

import torch

__all__ = ["decode_attention_ref", "decode_attention_split_ref"]


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


def decode_attention_split_ref(q, k, v, length, *, window=0, sm_scale=None,
                               chunk=64):
    """The kernel's arithmetic: the cache cut into chunks of ``chunk`` rows,
    each chunk's softmax partial (m, l, acc) over its rows in
    ``[start, length)`` in fp32, then the partials merged in chunk order
    with a running max M (num and den rescaled by exp(M_old - M_new), each
    chunk weighted by exp(m_i - M_new)); a chunk with no row in range is
    passed over.  Same arguments and result as :func:`decode_attention_ref`."""
    b, kv, g, d = q.shape
    s = k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    n_split = -(-s // chunk)
    length = length.to(q.device).long().clamp(0, s)
    start = (length - window).clamp(min=0) if window else torch.zeros_like(length)
    rows = torch.arange(n_split * chunk, device=q.device).reshape(n_split, chunk)
    keep = ((rows[None] >= start[:, None, None]) & (rows[None] < length[:, None, None]))
    pad = n_split * chunk - s
    kc = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vc = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kc = kc.reshape(b, n_split, chunk, kv, d)
    vc = vc.reshape(b, n_split, chunk, kv, d)
    scores = torch.einsum("bkgd,bnckd->bkgnc", q.float(), kc) * sm_scale
    mask = keep[:, None, None]                        # (B, 1, 1, n, chunk)
    scores = torch.where(mask, scores, torch.tensor(-torch.inf, device=q.device))
    m = scores.amax(dim=-1)                           # (B, KV, G, n)
    live = mask.any(dim=-1).expand_as(m)
    p = torch.where(mask, torch.exp(scores - torch.where(live, m, 0.0)[..., None]),
                    torch.tensor(0.0, device=q.device))
    l_part = p.sum(dim=-1)
    acc = torch.einsum("bkgnc,bnckd->bkgnd", p, vc)
    big_m = torch.full((b, kv, g), -torch.inf, device=q.device)
    num = torch.zeros((b, kv, g, d), device=q.device)
    den = torch.zeros((b, kv, g), device=q.device)
    for i in range(n_split):                          # split order
        on = live[..., i]
        m_new = torch.where(on, torch.maximum(big_m, m[..., i]), big_m)
        safe = torch.where(on, m_new, 0.0)
        c_old = torch.where(on, torch.exp(big_m - safe), 1.0)
        c_new = torch.where(on, torch.exp(m[..., i] - safe), 0.0)
        num = num * c_old[..., None] + c_new[..., None] * acc[..., i, :]
        den = den * c_old + c_new * l_part[..., i]
        big_m = m_new
    return (num / den.clamp(min=1e-30)[..., None]).to(q.dtype)
