"""Attention: GQA/MQA, global / sliding-window, prefill + decode paths.

The port of the reference package's ``models/attention.py`` on one device,
where its sharding constraints are the identity and are dropped.

On the card, full-sequence (prefill) attention runs the hand-written flash
kernel (:func:`..kernels.flash_attention.multi_head_attention`) and decode
attention the grouped decode kernel
(:func:`..kernels.decode_attention.grouped_decode_attention`), with the
valid length of each sequence kept on the card.  On the CPU the same calls
take the reference model's own plain versions, :func:`flash_chunked` and
:func:`_decode_attend`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.decode_attention import grouped_decode_attention
from ..kernels.flash_attention import multi_head_attention
from .layers import apply_rope, rope, softcap

__all__ = ["init_attention", "attention", "flash_chunked", "init_cache"]

NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg, dtype, stacked: int = 0,
                   device=None) -> dict:
    """Projection weights with the reference's scales, drawn from
    ``generator``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shp = (lambda *s: (stacked, *s)) if stacked else (lambda *s: s)
    pre = "stk_" if stacked else ""

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * scale).to(dtype)

    scale = d ** -0.5
    return {
        pre + "wq": normal(shp(d, h * hd), scale),
        pre + "wk": normal(shp(d, kv * hd), scale),
        pre + "wv": normal(shp(d, kv * hd), scale),
        pre + "wo": normal(shp(h * hd, d), (h * hd) ** -0.5),
    }


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def flash_chunked(q, k, v, *, causal: bool, window: int, sm_scale: float,
                  softcap_val: float = 0.0, q_chunk: int = 1024,
                  k_chunk: int = 1024):
    """(B, S, H, D) x (B, S, KV, D)^2 -> (B, S, H, D); online softmax, fp32
    accumulation, never more than (B, H, q_chunk, k_chunk) scores: the
    plain version of the flash kernel's path, as the reference model runs
    it (``window`` 0 = no window; soft-capping supported)."""
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qc, kc = min(q_chunk, s), min(k_chunk, sk)
    pad_q, pad_k = (-s) % qc, (-sk) % kc
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    sp, skp = q.shape[1], k.shape[1]
    nq, nk = sp // qc, skp // kc
    # (nq, B, KV, G, qc, D) grouped query blocks; (nk, B, KV, kc, D) keys
    qg = q.reshape(b, nq, qc, kvh, g, d).permute(1, 0, 3, 4, 2, 5)
    kg = k.reshape(b, nk, kc, kvh, d).permute(1, 0, 3, 2, 4)
    vg = v.reshape(b, nk, kc, kvh, d).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        qblk = qg[qi].float()
        rows = qi * qc + torch.arange(qc, device=q.device)
        m = torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, qc, d), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            scores = torch.einsum("bkgqd,bkcd->bkgqc", qblk,
                                  kg[ki].float()) * sm_scale
            if softcap_val:
                scores = softcap(scores, softcap_val)
            cols = ki * kc + torch.arange(kc, device=q.device)
            mask = (cols[None, :] < sk)
            if causal:
                mask = mask & (cols[None, :] <= rows[:, None])
            if window:
                mask = mask & (cols[None, :] > rows[:, None] - window)
            scores = torch.where(mask[None, None, None], scores,
                                 torch.tensor(NEG_INF, device=q.device))
            m_new = torch.maximum(m, scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vg[ki].float())
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    # (nq, B, KV, G, qc, D) -> (B, S, H, D)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sp, h, d)
    return out[:, :s]


def _decode_attend(q, ck, cv, length, sm_scale, window, cap):
    """q: (B, 1, H, D); cache: (B, S_max, KV, D); ``length`` the valid rows,
    one int for the batch (the reference's form) or a (B,) tensor.  The
    reference model's grouped decode (plain version of the decode kernel's
    path): scores in fp32, probabilities cast to the cache dtype before the
    PV product, as the reference does."""
    b, s, h, hd = q.shape
    kvh = ck.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), ck.float()) * sm_scale
    if cap:
        scores = softcap(scores, cap)
    col = torch.arange(ck.shape[1], device=q.device)[None, :]
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    mask = col < length                      # (B or 1, S_max)
    if window:
        mask = mask & (col > length - 1 - window)
    scores = torch.where(mask[:, None, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(cv.dtype).float(), cv.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def _prefill_attend(q, k, v, *, causal, window, sm_scale, cap):
    """(B, S, H, D) x (B, S, KV, D)^2 -> (B, S, H, D): the flash kernel on
    the card, :func:`flash_chunked` on the CPU."""
    if q.device.type != "cuda":
        return flash_chunked(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale, softcap_val=cap)
    # (B, H, S, D) views of the (B, S, H, D) tensors: the kernel reads and
    # writes through strides, so nothing is transposed in memory
    out = multi_head_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, sm_scale=sm_scale)
    return out.transpose(1, 2)


def attention(p: dict, x: torch.Tensor, cfg, *, window: int = 0,
              cache: Optional[dict] = None, pos: Optional[torch.Tensor] = None,
              causal: bool = True):
    """Unified attention layer.

    cache: {"k": (B, S_max, KV, D), "v": ...} with ``pos`` (B,) the write
    position of each sequence -> returns (out, cache).  Without cache:
    full-sequence attention, returns (out, None).

    The reference updates the cache functionally
    (``dynamic_update_slice`` into a new array); the port writes the new
    rows in place into the preallocated cache and returns the same dict.
    Each sequence writes at its own ``pos`` and decode attends over its own
    ``pos + 1`` rows; the reference takes ``pos[0]`` for the whole batch,
    which is the same whenever the positions agree, as the serving engine's
    always do.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cap = cfg.attn_logit_softcap
    if cap and x.device.type == "cuda":
        raise NotImplementedError(
            "attention logit soft-capping has no CUDA kernel (the reference's "
            "Pallas kernels have none either); it runs on the CPU only")
    q = _split_heads(x @ p["wq"], h, hd)
    k = _split_heads(x @ p["wk"], kv, hd)
    v = _split_heads(x @ p["wv"], kv, hd)
    if cfg.rope_theta:
        if pos is None:
            positions = torch.arange(s, device=x.device)
        else:
            positions = pos[:, None] + torch.arange(s, device=x.device)[None]
        cos, sin = rope(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    sm_scale = hd ** -0.5

    if cache is not None:
        k = k.to(cache["k"].dtype)
        v = v.to(cache["v"].dtype)
        if pos is None:
            pos = torch.zeros((b,), dtype=torch.int32, device=x.device)
        rows = (pos[:, None] + torch.arange(s, device=x.device)[None]).long()
        bidx = torch.arange(b, device=x.device)[:, None]
        cache["k"][bidx, rows] = k
        cache["v"][bidx, rows] = v
        if s == 1:
            if q.device.type == "cuda":
                length = (pos + 1).to(torch.int32)
                out = grouped_decode_attention(
                    q[:, 0].reshape(b, kv, h // kv, hd), cache["k"],
                    cache["v"], length, window=window, sm_scale=sm_scale)
                out = out.reshape(b, 1, h, hd)
            else:
                out = _decode_attend(q, cache["k"], cache["v"], pos + 1,
                                     sm_scale, window, cap)
        else:
            # prefill: self-attention within the prompt (which starts at
            # position 0: the flash kernel is self-attention only)
            out = _prefill_attend(q, k, v, causal=causal, window=window,
                                  sm_scale=sm_scale, cap=cap)
        return out.reshape(b, s, h * hd) @ p["wo"], cache

    out = _prefill_attend(q, k, v, causal=causal, window=window,
                          sm_scale=sm_scale, cap=cap)
    return out.reshape(b, s, h * hd) @ p["wo"], None


def init_cache(cfg, batch: int, s_max: int, n_layers: int,
               dtype=torch.bfloat16, device=None):
    """Stacked KV cache for one stage of ``n_layers`` attention layers."""
    shape = (n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
