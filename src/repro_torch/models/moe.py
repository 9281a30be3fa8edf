"""Mixture-of-Experts: top-k routing, sort-based dispatch into per-expert
capacity buffers, the expert products, and the Eclat-style expert
placement.

The port of the reference package's ``models/moe.py`` on one card.

**One card means one group.**  The reference groups tokens by data shard
(``_n_groups``) and moves the capacity buffers between shards with one
all-to-all; without a mesh ``_n_groups`` returns 1 and its ``constrain`` is
the identity.  Here every token of the call is routed as that one group,
so ``moe_dispatch="local"`` and ``"global"`` (the reference's one flat
sort) give the same capacity and the same function, and both take the one
path; ``"global"`` keeps the reference's refusal of ``expert_split > 1``.
The data-shard groups and the all-to-all wait for mesh training (ROADMAP
item 12a).

Routing, as the reference computes it: the router in float32, softmax over
the experts, the top ``k`` gates renormalised to sum to 1, expert ids
permuted by the placement, each expert fissioned into ``expert_split``
slots of ``d_ff / expert_split`` (exact for gated FFNs: the slots' outputs
sum in the combine), a stable sort of the (token, choice) entries by slot,
and each slot keeping its first ``cap`` entries (the rest are dropped,
weight 0).  The expert products are ``torch.bmm`` in the model's dtype (the
reference leaves them to ``einsum``, outside any kernel); the combine sums
in float32 and casts to the input's dtype at the end.

**Determinism.**  Dispatch and combine are gathers, not scatter-adds of
floats: slot row ``c`` of slot ``s`` gathers its entry's token, and each
token gathers its ``k`` rows and sums them in a fixed order.  So two runs on
the card give the same bits, whatever the atomics' order would be.
Counts are integer scatter-adds into tensors of a fixed length (no
``bincount``, whose output length needs a read back to the host), so a
call makes no host sync.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.partitioners import greedy_partitioner

__all__ = ["init_moe", "expert_placement", "moe"]


def _normal(generator, shape, scale, dtype, device):
    """``randn(shape) * scale`` in ``dtype``, drawn in float32 one trailing
    matrix at a time, so a full-width draw never holds more than one
    matrix in float32 (grok's four stacked layers of expert weights are
    26 GB in float32)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for m in out.view(-1, *shape[-2:]):
        m.copy_(torch.randn(shape[-2:], generator=generator, dtype=torch.float32,
                            device=device) * scale)
    return out


def init_moe(generator: torch.Generator, cfg, dtype, stacked: int = 0,
             device=None) -> dict:
    """Router (float32) and expert weights with the reference's scales,
    drawn from ``generator``; ``expert_split`` slots of ``d_ff /
    expert_split`` per expert."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    split = cfg.expert_split
    slots, fs = e * split, f // split
    shp = (lambda *s: (stacked, *s)) if stacked else (lambda *s: s)
    pre = "stk_" if stacked else ""
    p = {
        pre + "router": torch.randn(shp(d, e), generator=generator,
                                    dtype=torch.float32, device=device) * d ** -0.5,
        pre + "experts_up": _normal(generator, shp(slots, d, fs), d ** -0.5, dtype,
                                    device),
        pre + "experts_down": _normal(generator, shp(slots, fs, d), f ** -0.5,
                                      dtype, device),
    }
    if cfg.mlp_act in ("swiglu", "geglu"):
        p[pre + "experts_gate"] = _normal(generator, shp(slots, d, fs), d ** -0.5,
                                          dtype, device)
    return p


def expert_placement(cfg, load_estimate: Optional[np.ndarray] = None) -> np.ndarray:
    """Static expert-id permutation balancing load across the reference's
    expert-parallel axis (greedy LPT, the paper's class partitioner);
    ``"default"`` is the identity."""
    e = cfg.n_experts
    if cfg.expert_placement == "default" or e == 0:
        return np.arange(e, dtype=np.int32)
    load = load_estimate if load_estimate is not None else np.ones(e)
    shards = 16 if e % 16 == 0 else max(1, e // 8)
    assign = greedy_partitioner(np.arange(e), shards,
                                work=np.asarray(load, np.float64))
    return np.argsort(assign, kind="stable").astype(np.int32)


def _dispatch_one_group(xf, probs, k, e, cap, placement, split: int = 1):
    """One group of tokens: xf (T, D), probs (T, E) float32 -> the capacity
    buffers (E split, cap, D) and the combine's metadata ``(dest, st, sg,
    keep)`` over the sorted entries (buffer row, token, gate, kept), as the
    reference's ``_dispatch_one_group`` returns them."""
    tg, d = xf.shape
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    if placement is not None:
        expert_ids = placement[expert_ids]
    if split > 1:
        # expert fission: expert -> its `split` slots, same gate weight each
        expert_ids = (expert_ids[..., None] * split
                      + torch.arange(split, device=xf.device)).reshape(tg, k * split)
        gate_vals = gate_vals.repeat_interleave(split, dim=-1)
        k = k * split
    n_slots, n = e * split, tg * k
    flat_e = expert_ids.reshape(n)
    flat_t = torch.arange(tg, device=xf.device).repeat_interleave(k)
    # stable, as jnp.argsort is: ties keep token order, so the same
    # entries overflow the capacity
    se, order = torch.sort(flat_e, stable=True)
    st, sg = flat_t[order], gate_vals.reshape(n)[order]
    count = _count(se, n_slots)
    seg_start = torch.cumsum(count, 0) - count          # first entry of each slot
    pos_in_e = torch.arange(n, device=xf.device) - seg_start[se]
    keep = pos_in_e < cap
    dest = se * cap + torch.clamp(pos_in_e, max=cap - 1)
    # slot s, row c holds sorted entry seg_start[s] + c while c < count[s]
    c = torch.arange(cap, device=xf.device)
    src = torch.clamp(seg_start[:, None] + c, max=max(n - 1, 0))
    filled = c < torch.clamp(count, max=cap)[:, None]
    buf = torch.where(filled[..., None], xf[st[src]],
                      torch.zeros((), dtype=xf.dtype, device=xf.device))
    return buf, (dest, st, sg, keep)


def _count(ids, n):
    """How often each of ``0..n-1`` occurs in ``ids``: (n,) int64, of a
    fixed length so no sync to the host (``bincount`` reads its max)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _combine_one_group(out_buf, meta, tg, d):
    """(E split, cap, D) expert outputs -> (T, D) float32: each token's
    ``k`` rows weighted by their gates (0 where dropped) and summed in the
    order of their sorted entries."""
    dest, st, sg, keep = meta
    k = st.shape[0] // max(tg, 1)
    rows = torch.argsort(st, stable=True).reshape(tg, k)   # each token's entries
    gathered = out_buf.reshape(-1, d)[dest[rows]].float()
    weights = torch.where(keep, sg, torch.zeros((), device=sg.device))[rows]
    return (gathered * weights[..., None]).sum(1)


def _experts(p, buf, cfg):
    """The gated FFN of every slot on its buffer: (slots, cap, D) ->
    (slots, cap, D) in the buffer's dtype."""
    up = torch.bmm(buf, p["experts_up"])
    if cfg.mlp_act in ("swiglu", "geglu"):
        gate = torch.bmm(buf, p["experts_gate"])
        act = (F.silu(gate) if cfg.mlp_act == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        hidden = act * up
    else:
        hidden = F.gelu(up, approximate="tanh")
    return torch.bmm(hidden, p["experts_down"])


def _capacity(tokens: int, k: int, cfg) -> int:
    return int(math.ceil(tokens * k / cfg.n_experts * cfg.capacity_factor))


def moe(p: dict, x: torch.Tensor, cfg, placement: Optional[torch.Tensor] = None):
    """x: (B, S, D) -> ((B, S, D), aux): ``aux`` holds the Switch-style
    load-balance loss ``aux_loss`` (float32), ``expert_load`` (the share of
    tokens whose top-1 is each expert) and ``dropped_frac`` (the share of
    routed entries over capacity).  ``placement``: (E,) int64 expert-id
    permutation on x's device, or None."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)   # (T, E)

    me = probs.mean(0)
    ce = _count(probs.argmax(-1), e).float() / t
    aux_loss = e * torch.sum(me * ce)

    if cfg.moe_dispatch == "global" and cfg.expert_split != 1:
        raise ValueError("moe_dispatch='global' has one slot per expert; "
                         f"expert_split={cfg.expert_split} needs 'local'")
    buf, meta = _dispatch_one_group(xf, probs, k, e, _capacity(t, k, cfg),
                                    placement, split=cfg.expert_split)
    out = _combine_one_group(_experts(p, buf, cfg), meta, t, d)
    dropped = 1.0 - meta[3].float().mean()
    out = out.reshape(b, s, d).to(x.dtype)
    return out, {"aux_loss": aux_loss, "expert_load": ce, "dropped_frac": dropped}
