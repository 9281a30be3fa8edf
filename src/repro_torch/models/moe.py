"""Mixture-of-Experts: top-k routing, sort-based dispatch into per-expert
capacity buffers, the expert products, and the Eclat-style expert
placement.

The port of the reference package's ``models/moe.py``.

**One card means one group.**  The reference groups tokens by data shard
(``_n_groups``) and moves the capacity buffers between shards with one
all-to-all; without a mesh ``_n_groups`` returns 1 and its ``constrain`` is
the identity.  Off a mesh every token of the call is routed as that one
group, so ``moe_dispatch="local"`` and ``"global"`` (the reference's one
flat sort) give the same capacity and the same function, and both take the
one path; ``"global"`` keeps the reference's refusal of ``expert_split >
1``.

**On a mesh** (``mesh`` with one data axis, ``data``, or two, ``pod`` and
``data``, and ``model``) the reference's groups are the product of the
data axes halved until it divides the global token count (``_n_groups``);
each group has its own capacity, so drops differ from one card's, as in the
reference.  A batch split over the data axes gives every data rank exactly
one group, its own tokens (data rank ``r`` the index over the data axes,
``pod`` major, as ``dist.sharding.batch_spec`` orders the rows); a batch
each data rank holds whole (``whole_batch``: one the data axes do not
divide) gives every rank all the groups.  The expert weights are placed by
the reference's rule (``dist.sharding.param_spec``):

* ``ep`` (llama4): slots split over ``data`` (the last data axis) and
  replicated over ``pod``, d_ff over ``model``.  Each rank dispatches its
  group, one all-to-all over ``data`` takes the buffers of its pod's groups
  from group-sharded to slot-sharded (no buffer crosses ``pod``: a group's
  products do not depend on another group's), the slots' products run on
  this rank's d_ff slice and their partial sums are reduced over
  ``model``, and a second all-to-all takes them back; the combine is
  local.  With a whole batch each rank takes its slots of every group's
  buffers and an all-gather over ``data`` brings the others' outputs.
* ``tp2d`` (grok): every slot on every rank, d_ff split over ``(pod, data,
  model)``.  The groups' buffers are gathered over the data axes, each
  rank runs its d_ff slice on all of them, and the partial sums are reduced
  over ``model`` and reduce-scattered over the data axes back to each
  rank's group (with a whole batch, all-reduced over them).
* ``moe_dispatch="global"``: the tokens are gathered over the data axes and
  routed as one group on every rank, the reference's function (its one
  flat sort); each rank keeps its rows of the result.

The load-balance loss is global, as the reference takes it: the top-1
counts are all-reduced over the data axes (with the kept entries, for
``dropped_frac``), and each rank's share of ``aux_loss``, its tokens' sum
of probabilities against the global counts (a whole batch: the loss over
the data ranks), is summed over the data axes with an identity backward, so
the train step's sum of the data ranks' gradients is the gradient of the
global loss.

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
from ..dist import collectives as coll
from ..dist.sharding import (axis_index, axis_size, data_axes, data_rank,
                             mesh_axes, param_spec, spec_axes)

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
    (slots, cap, D) in the buffer's dtype; (groups, slots, cap, D) buffers
    run each slot on all its groups' rows in one product."""
    if buf.ndim == 4:
        g, slots, cap, d = buf.shape
        flat = buf.transpose(0, 1).reshape(slots, g * cap, d)
        out = _experts(p, flat, cfg)
        return out.reshape(slots, g, cap, -1).transpose(0, 1)
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


def _n_groups(tokens: int, n_data: int) -> int:
    """The reference's routing groups: the data axes' size, halved until it
    divides the token count."""
    g = n_data
    while g > 1 and tokens % g:
        g //= 2
    return max(g, 1)


def _expert_axes(cfg, d, mesh):
    """(slot axes, d_ff axes) of this config's expert leaves on ``mesh``,
    by the reference's placement rule."""
    split = cfg.expert_split
    spec = param_spec("experts_up", (cfg.n_experts * split, d, cfg.d_ff // split),
                      mesh, cfg.expert_sharding)
    return spec_axes(spec[0]), spec_axes(spec[2])


def moe(p: dict, x: torch.Tensor, cfg, placement: Optional[torch.Tensor] = None,
        mesh=None, whole_batch: bool = False):
    """x: (B, S, D) -> ((B, S, D), aux): ``aux`` holds the Switch-style
    load-balance loss ``aux_loss`` (float32), ``expert_load`` (the share of
    tokens whose top-1 is each expert) and ``dropped_frac`` (the share of
    routed entries over capacity).  ``placement``: (E,) int64 expert-id
    permutation on x's device, or None.  On ``mesh`` (module docstring)
    ``x`` is this rank's block of the batch, or the whole batch when
    ``whole_batch``, and ``p`` holds this rank's blocks of the expert
    weights; the output is this rank's block and the statistics global."""
    if mesh is not None:
        return _moe_mesh(p, x, cfg, placement, mesh, whole_batch)
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


def _gather(t, mesh, axes, dim):
    """``t`` of every rank over ``axes`` concatenated along ``dim`` in the
    flattened order, the first axis major (one all-gather an axis, the
    last first)."""
    for a in reversed(axes):
        t = coll.gather_over_axis(t, mesh, a, dim)
    return t


def _moe_mesh(p, x, cfg, placement, mesh, whole_batch):
    """:func:`moe` on a mesh (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if cfg.moe_dispatch == "global" and cfg.expert_split != 1:
        raise ValueError("moe_dispatch='global' has one slot per expert; "
                         f"expert_split={cfg.expert_split} needs 'local'")
    daxes = data_axes(mesh)
    rank, nd = data_rank(mesh)
    model = "model" if mesh_axes(mesh).get("model", 1) > 1 else None
    xf = x.reshape(b * s, d)
    # the groups this rank routes: its own one (a split batch), or every
    # group on every data rank (a whole batch; "global": one, gathered)
    replicated = whole_batch or cfg.moe_dispatch == "global" or nd == 1
    if cfg.moe_dispatch == "global":
        if not whole_batch and nd > 1:
            xf = _gather(xf, mesh, daxes, 0)
        n_tokens, g = xf.shape[0], 1
    else:
        n_tokens = xf.shape[0] * (1 if replicated else nd)
        g = _n_groups(n_tokens, nd) if replicated else 1
    groups = xf.reshape(g, -1, d)
    tg = groups.shape[1]
    probs = torch.softmax(groups.float() @ p["router"].float(), dim=-1)

    # statistics over every group: the top-1 counts and kept entries summed
    # over the data axes (a split batch), then each rank's share of the aux
    # loss
    cap = _capacity(tg, k, cfg)
    dispatched = [_dispatch_one_group(groups[i], probs[i], k, e, cap, placement,
                                      split=cfg.expert_split) for i in range(g)]
    entries = sum(int(m[3].numel()) for _, m in dispatched)
    stats = torch.cat([_count(probs.argmax(-1).reshape(-1), e),
                       sum(m[3].long().sum() for _, m in dispatched).reshape(1)])
    if not replicated:
        for a in daxes:
            coll.all_reduce(stats, mesh, a)
        entries *= nd
    ce = stats[:e].float() / n_tokens
    share = e * torch.sum(probs.sum((0, 1)) / n_tokens * ce)
    if daxes:
        share = (share / nd if replicated else share).reshape(1)
        for a in daxes:
            share = coll.reduce_over_axis(share, mesh, a)
        share = share[0]
    dropped = 1.0 - stats[e].float() / entries

    slot_axes, ff_axes = _expert_axes(cfg, d, mesh)
    bufs = torch.stack([buf for buf, _ in dispatched])     # (g, slots, cap, D)
    slots = bufs.shape[1]
    # ep: the slots split over one data axis (the last), replicated over the
    # others; tp2d: d_ff split over every data axis (and model)
    ep = next((a for a in daxes if a in slot_axes), None)
    ff_data = tuple(a for a in daxes if a in ff_axes)
    n_ep = axis_size(mesh, ep) if ep else 1
    if ep and replicated:
        n = slots // n_ep
        bufs = bufs[:, axis_index(mesh, ep) * n:(axis_index(mesh, ep) + 1) * n]
    elif ep:        # group-sharded -> slot-sharded: (n_ep groups, my slots, ...)
        bufs = coll.all_to_all_over_axis(bufs.reshape(n_ep, slots // n_ep, cap, d),
                                         mesh, ep)
    elif ff_data and not replicated:
        bufs = _gather(bufs, mesh, ff_data, 0)
    if model and model in ff_axes:
        bufs = coll.copy_to_axis(bufs, mesh, model)
    out_buf = _experts(p, bufs, cfg)
    if model and model in ff_axes:
        out_buf = coll.reduce_over_axis(out_buf, mesh, model)
    if ep and replicated:
        out_buf = coll.gather_over_axis(out_buf, mesh, ep, 1)
    elif ep:        # back: (n_ep slot blocks, my group's rows) -> (1, slots, ...)
        out_buf = coll.all_to_all_over_axis(out_buf, mesh, ep).reshape(
            1, slots, cap, d)
    elif ff_data and replicated:
        for a in ff_data:
            out_buf = coll.reduce_over_axis(out_buf, mesh, a)
        for a in ff_data:
            out_buf = coll.copy_to_axis(out_buf, mesh, a)
    elif ff_data:   # each group's sum back to its data rank, the first axis major
        for a in ff_data:
            out_buf = coll.reduce_scatter_over_axis(out_buf, mesh, a, 0)
    out = torch.cat([_combine_one_group(out_buf[i], m, tg, d)
                     for i, (_, m) in enumerate(dispatched)])
    if cfg.moe_dispatch == "global" and not whole_batch and nd > 1:
        out = out.narrow(0, rank * b * s, b * s)
    out = out.reshape(b, s, d).to(x.dtype)
    return out, {"aux_loss": share, "expert_load": ce, "dropped_frac": dropped}
