"""Attention: GQA/MQA, global / sliding-window, prefill + decode paths.

The port of the reference package's ``models/attention.py``.  On one
device its sharding constraints are the identity and are dropped.  On a
mesh with a ``model`` axis (training only) the layer is tensor-parallel, as
the reference's placements make GSPMD run it (:func:`head_split` names the
three forms): ``wq`` is column-split, so when the axis divides the heads
each rank owns ``H / m`` contiguous query heads; ``wk``/``wv`` are
column-split too, and when the KV heads split over the ranks each rank's
KV heads are exactly those its query heads use (``"heads"``).  When they do
not but a rank's query heads share one KV head (``"group"``; MQA: one KV
head, its dims cut in two), the rank's k and v slices are all-gathered
over ``model`` before RoPE (which pairs dim ``i`` with ``i + hd / 2``), and
their gradient is summed back over the ranks.  When the axis does not
divide the heads (``"all"``; hymba-1.5b's 25 heads over 2 ranks: the
reference cuts ``wq``'s 1,600 columns at 800, mid-head), each rank's column
products of q, k and v are all-gathered over ``model`` (one all-gather,
its backward one reduce-scatter), every head runs on every rank, and the
rank keeps the output columns of its rows of ``wo``: the attention itself
is duplicated on each model rank, the price of the reference's placement.
``wo`` is row-parallel: each rank's partial product is all-reduced over
``model``.  The input is replicated over ``model`` and its gradient summed
over it (``dist.collectives.copy_to_axis``); under sequence parallelism
(``layers.SeqShard``) the input is instead gathered from the ranks' rows,
so RoPE and the causal mask see global positions, and the output is
reduce-scattered back to them (``layers.tp_enter``, ``layers.tp_leave``).
Cross-attention takes the same three forms: the rank's query heads of
``xwq`` (every head, its columns gathered, in the ``"all"`` form) over the
encoder's K/V that ``Model.cross_kv`` hands the rank (its KV heads, the
one its query heads share, or every one: :func:`kv_of_form`), then its rows
of ``xwo``.  A model axis that does not split the KV projections' columns
(:func:`projections_split`) leaves the layer to ``transformer``, which runs
it whole on every rank.

On the card, full-sequence (prefill) attention runs the hand-written flash
kernel (:func:`..kernels.flash_attention.multi_head_attention`) and decode
attention the grouped decode kernel
(:func:`..kernels.decode_attention.grouped_decode_attention`), with the
valid length of each sequence kept on the card.  Both kernels take the
config's attention logit soft-cap (``attn_logit_softcap``, grok's 30), so
with a cap too attention runs only through them on the card.  On the CPU
the same calls take the reference model's own plain versions,
:func:`flash_chunked` and :func:`_decode_attend`.

Cross-attention (whisper's decoder over its encoder, ``cross_kv``): the
``x``-prefixed projections give q, the encoder's precomputed K/V of Sk
rows are the keys, and neither gets rope, as in the reference.  A prompt
(S > 1) runs the flash kernel non-causally at Sk != S; a decode step
(S = 1) runs the decode kernel over all Sk rows (``length`` = Sk for
every sequence, made on the card) and writes no cache.  In training the
prompt's path carries the gradient to q and to the encoder's k and v.

The full-sequence path (no cache) is differentiable on both devices: on the
card through ``FlashAttentionFunction`` (the flash kernel's forward and its
hand-written backward, soft-capped and at Sk != S too), on the CPU through
autograd of :func:`flash_chunked`.
Training takes it; serving runs under ``torch.inference_mode``, where the
kernel writes no log-sum-exp.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dist import collectives as coll
from ..dist.sharding import axis_index, axis_size
from ..kernels.decode_attention import grouped_decode_attention
from ..kernels.flash_attention import multi_head_attention
from .layers import apply_rope, draw_normal, rope, softcap, tp_enter, tp_leave

__all__ = ["init_attention", "attention", "flash_chunked", "init_cache", "head_split",
           "projections_split", "kv_of_form"]

NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg, dtype, stacked: int = 0,
                   device=None, cross: bool = False) -> dict:
    """Projection weights with the reference's scales, drawn from
    ``generator``; ``cross`` names them ``xwq``, ``xwk``, ``xwv``, ``xwo``
    (whisper's cross-attention)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shp = (lambda *s: (stacked, *s)) if stacked else (lambda *s: s)
    pre = ("stk_" if stacked else "") + ("x" if cross else "")

    def normal(shape, scale):
        return draw_normal(generator, shape, scale, dtype, device)

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
    """(B, S, H, D) x (B, Sk, KV, D)^2 -> (B, S, H, D): the flash kernel on
    the card (its backward too, when a gradient is asked for),
    :func:`flash_chunked` on the CPU."""
    if q.device.type != "cuda":
        return flash_chunked(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale, softcap_val=cap)
    # (B, H, S, D) views of the (B, S, H, D) tensors: the kernel reads and
    # writes through strides, so nothing is transposed in memory
    out = multi_head_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, sm_scale=sm_scale, softcap=cap)
    return out.transpose(1, 2)


def head_split(cfg, m: int) -> str:
    """How a model axis of ``m`` ranks runs the heads: ``"heads"``, each
    rank its ``H / m`` query heads and their KV heads; ``"group"``, its
    query heads sharing one KV head that is gathered whole (MQA); ``"all"``,
    every head on every rank (the axis does not divide the heads, or a
    rank's heads span KV heads it does not hold)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if h % m:
        return "all"
    if kv % m == 0:
        return "heads"
    return "group" if (h // kv) % (h // m) == 0 and (kv * hd) % m == 0 else "all"


def projections_split(cfg, m: int) -> bool:
    """Whether the placement splits every projection over a model axis of
    ``m`` ranks (``dist.sharding.param_spec``: the KV columns divided, and
    with them the query columns, a multiple of theirs): the layer is then
    tensor-parallel in one of :func:`head_split`'s forms."""
    return (cfg.n_kv_heads * cfg.head_dim) % m == 0


def kv_of_form(k: torch.Tensor, v: torch.Tensor, cfg, mesh, form: str) -> tuple:
    """The K/V columns this rank's query heads read, from its column
    products ``k``, ``v`` (``(..., KV / m * D)``, any leading dims): its own
    (``"heads"``); the one KV head its query heads share, gathered whole
    (``"group"``); every KV head (``"all"``).  One all-gather of both over
    ``model`` in the last two forms, its gradient summed back and cut to the
    rank's columns."""
    if form == "heads":
        return k, v
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    kvf = coll.gather_over_axis(torch.stack([k, v]), mesh, "model", dim=-1)
    if form == "group":
        lo = (r * (h // m)) // (h // kv) * hd
        kvf = kvf[..., lo: lo + hd]
    return kvf[0], kvf[1]


def _tp_projections(p: dict, x: torch.Tensor, cfg, mesh, seq):
    """q, k, v on a mesh whose ``model`` axis splits the projections'
    columns, and the output columns this rank's rows of ``wo`` take (None:
    all of ``out``, the rank's own heads): the module docstring's three
    forms (:func:`head_split`).  ``x`` enters through ``layers.tp_enter``."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    x = tp_enter(x, mesh, seq)
    form = head_split(cfg, m)
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if form != "all":
        k, v = kv_of_form(k, v, cfg, mesh, form)
        return (_split_heads(q, h // m, hd), _split_heads(k, k.shape[-1] // hd, hd),
                _split_heads(v, v.shape[-1] // hd, hd), None)
    # every head on every rank: the ranks' q, k, v columns in one gather,
    # (B, S, m, local q | k | v) reassembled into whole q, k, v
    qw, kw = q.shape[-1], k.shape[-1]
    cols = coll.gather_over_axis(torch.cat([q, k, v], dim=-1), mesh, "model", dim=-1)
    cols = cols.reshape(*cols.shape[:-1], m, qw + 2 * kw)
    q, k, v = (cols[..., lo: lo + w].flatten(-2) for lo, w in
               ((0, qw), (qw, kw), (qw + kw, kw)))
    return (_split_heads(q, h, hd), _split_heads(k, kv, hd), _split_heads(v, kv, hd),
            slice(r * qw, (r + 1) * qw))


def _cross_attend(q, k, v, sm_scale, cap):
    """q (B, S, H, D) over the encoder's k, v (B, Sk, KV, D), every row
    kept: a decode step (S = 1) through the decode kernel with ``length``
    Sk for every sequence, a prompt (and a training sequence, whose
    gradient reaches q, k and v through K6's backward) through the flash
    kernel non-causally (their plain versions on the CPU)."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if s > 1:
        return _prefill_attend(q, k, v, causal=False, window=0,
                               sm_scale=sm_scale, cap=cap)
    if q.device.type != "cuda":
        return _decode_attend(q, k, v, sk, sm_scale, 0, cap)
    # made on the card, so the step waits for no copy
    length = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    out = grouped_decode_attention(q[:, 0].reshape(b, kv, h // kv, hd), k, v,
                                   length, sm_scale=sm_scale, softcap=cap)
    return out.reshape(b, 1, h, hd)


def attention(p: dict, x: torch.Tensor, cfg, *, window: int = 0,
              cache: Optional[dict] = None, pos: Optional[torch.Tensor] = None,
              cross_kv: Optional[tuple] = None, causal: bool = True,
              prefix: str = "", mesh=None, seq=None):
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

    cross_kv: the encoder's (k, v), each (B, Sk, KV, D), for whisper's
    cross-attention with the ``prefix`` ``"x"`` weights: no rope, every
    key kept, no cache (see the module docstring); returns (out, None).

    ``mesh``: full-sequence attention and cross-attention, tensor-parallel
    over its ``model`` axis (see the module docstring; ``cross_kv`` then
    holds what :func:`kv_of_form` gives the rank); ``seq`` (a
    ``layers.SeqShard``): ``x`` is the rank's rows of the sequence and so is
    the output.  A cache on a mesh raises ``NotImplementedError``.
    """
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cap = cfg.attn_logit_softcap
    sm_scale = hd ** -0.5
    tp = mesh is not None and "model" in (mesh.mesh_dim_names or ())
    if tp and cache is not None:
        raise NotImplementedError(
            "attention with a KV cache on a mesh (sharded serving) is not "
            "ported (ROADMAP item 12)")
    if cross_kv is not None:
        if cache is not None:
            raise ValueError("cross-attention reads the encoder's K/V and "
                             "takes no cache")
        cols = None
        if tp:
            x = tp_enter(x, mesh, seq)
        q = x @ p[prefix + "wq"]
        if tp and head_split(cfg, axis_size(mesh, "model")) == "all":
            # every head on every rank: the ranks' query columns gathered
            cols = slice(axis_index(mesh, "model") * q.shape[-1],
                         (axis_index(mesh, "model") + 1) * q.shape[-1])
            q = coll.gather_over_axis(q, mesh, "model", dim=-1)
        b, s, _ = x.shape
        out = _cross_attend(_split_heads(q, q.shape[-1] // hd, hd), *cross_kv,
                            sm_scale, cap).reshape(b, s, -1)
        out = (out if cols is None else out[..., cols]) @ p[prefix + "wo"]
        return (tp_leave(out, mesh, seq) if tp else out), None
    cols = None
    if tp:
        q, k, v, cols = _tp_projections(p, x, cfg, mesh, seq)
    else:
        q = _split_heads(x @ p["wq"], h, hd)
        k = _split_heads(x @ p["wk"], kv, hd)
        v = _split_heads(x @ p["wv"], kv, hd)
    b, s = q.shape[:2]
    if cfg.rope_theta:
        if pos is None:
            positions = torch.arange(s, device=x.device)
        else:
            positions = pos[:, None] + torch.arange(s, device=x.device)[None]
        cos, sin = rope(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

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
                    cache["v"], length, window=window, sm_scale=sm_scale,
                    softcap=cap)
                out = out.reshape(b, 1, h, hd)
            else:
                out = _decode_attend(q, cache["k"], cache["v"], pos + 1,
                                     sm_scale, window, cap)
        else:
            # prefill: self-attention within the prompt (which starts at
            # position 0: the kernel's causal mask counts from row 0)
            out = _prefill_attend(q, k, v, causal=causal, window=window,
                                  sm_scale=sm_scale, cap=cap)
        return out.reshape(b, s, h * hd) @ p["wo"], cache

    out = _prefill_attend(q, k, v, causal=causal, window=window,
                          sm_scale=sm_scale, cap=cap)
    out = out.reshape(b, s, q.shape[2] * hd)
    out = (out if cols is None else out[..., cols]) @ p["wo"]
    return (tp_leave(out, mesh, seq) if tp else out), None


def init_cache(cfg, batch: int, s_max: int, n_layers: int,
               dtype=torch.bfloat16, device=None):
    """Stacked KV cache for one stage of ``n_layers`` attention layers."""
    shape = (n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
