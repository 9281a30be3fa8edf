"""Mamba-style selective SSM block (hymba's parallel-head SSM branch).

The port of the reference package's ``models/ssm.py``.  The sequence is
processed in chunks of :data:`CHUNK` positions with a sequential carry of
the (B, D_in, N) state between them.  Inside a chunk the recurrence
``h_t = decay_t * h_{t-1} + drive_t`` is a scan under the reference's
combine ``(l0 * r0, r0 * l1 + r1)``: the reference runs
``jax.lax.associative_scan``, the port a log-step (Hillis-Steele) scan over
the chunk axis, 7 vectorised steps for 128 positions.  No closed form
through a cumulative product and a division: the decays underflow over a
chunk, and dividing by them would overflow.  ``decay`` and ``drive`` are
built a chunk at a time (hymba's prefill at B = 2, S = 2,048: 52 MB each a
chunk, 839 MB for the whole sequence); the function computed is the
reference's.  ``ssm_a_log`` and ``ssm_d`` are float32 in every model dtype,
as the reference keeps them, and so is the state.

On a mesh with a ``model`` axis of ``m`` ranks (training only) the block is
tensor-parallel under the reference's placements: ``ssm_in_proj``'s
columns are split (with m = 2, xs on rank 0 and z on rank 1), so the
in-projection is gathered over ``model``; the depthwise conv and
``ssm_bc_proj`` (both replicated) run on the full ``Din`` on every rank;
the scan runs on the rank's ``Din / m`` channels, with their rows of the
replicated ``ssm_a_log`` and the rank's slice of ``ssm_d``; the
row-parallel ``ssm_out_proj``'s partial sums are all-reduced over
``model``.  Each rank's gradient of a replicated leaf covers its own
channels only, so ``ssm_conv``, ``ssm_bc_proj`` and ``ssm_a_log`` enter
through ``copy_to_axis`` (their gradients summed over ``model``) and the
ranks' copies stay equal.  Under sequence parallelism the block gathers the
sequence from the ranks' rows in front and reduce-scatters its output back
to them (``layers.tp_enter``, ``layers.tp_leave``).  Channels the axis does
not divide (:func:`ssm_split`) leave the block to ``transformer``, which
runs it whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import collectives as coll
from .layers import gather_columns, model_split, tp_enter, tp_leave

__all__ = ["CHUNK", "init_ssm", "ssm_block", "init_ssm_state", "ssm_split"]

CHUNK = 128


def ssm_split(cfg, m: int) -> bool:
    """Whether a model axis of ``m`` ranks splits the SSM's inner channels
    and leaves ``ssm_bc_proj`` replicated, the placement the block's
    tensor-parallel form takes (``dist.sharding.param_spec``)."""
    return (cfg.ssm_expand * cfg.d_model) % m == 0 and (2 * cfg.ssm_state + 1) % m != 0


def init_ssm(generator: torch.Generator, cfg, dtype, stacked: int = 0,
             prefix: str = "", device=None) -> dict:
    """Weights with the reference's keys and scales, drawn from
    ``generator``; ``ssm_a_log`` = log(1..N) for every channel and
    ``ssm_d`` = 1, both float32."""
    d = cfg.d_model
    din = cfg.ssm_expand * d
    n = cfg.ssm_state
    shp = (lambda *s: (stacked, *s)) if stacked else (lambda *s: s)
    pre = ("stk_" if stacked else "") + prefix

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * scale).to(dtype)

    a_init = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                    device=device))
    return {
        pre + "ssm_in_proj": normal(shp(d, 2 * din), d ** -0.5),
        pre + "ssm_bc_proj": normal(shp(din, 2 * n + 1), din ** -0.5),
        pre + "ssm_conv": normal(shp(cfg.ssm_conv, din), 0.3),
        pre + "ssm_a_log": a_init.expand(*shp(din, n)).contiguous(),
        pre + "ssm_d": torch.ones(shp(din), dtype=torch.float32, device=device),
        pre + "ssm_out_proj": normal(shp(din, d), din ** -0.5),
    }


def _causal_conv(x, w, state=None):
    """x: (B, S, Din); w: (K, Din) depthwise causal conv.

    state: (B, K-1, Din) trailing inputs from the previous step (decode).
    Returns (y, new_state), the new state in x's dtype."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+K-1, Din)
    y = sum(xp[:, i: i + x.shape[1]] * w[i][None, None] for i in range(k))
    new_state = (xp[:, -(k - 1):] if k > 1 else
                 torch.zeros((x.shape[0], 0, x.shape[2]), dtype=x.dtype,
                             device=x.device))
    return y, new_state


def _scan(dec, drv):
    """Inclusive scan along dim 1 of (B, L, Din, N) pairs under
    ``(l0 * r0, r0 * l1 + r1)`` (l the earlier element): log2(L) steps,
    each combining every position with the one ``offset`` before it."""
    offset = 1
    while offset < dec.shape[1]:
        d_cur, r_cur = dec[:, offset:], drv[:, offset:]
        dec, drv = (torch.cat([dec[:, :offset], dec[:, :-offset] * d_cur], dim=1),
                    torch.cat([drv[:, :offset], d_cur * drv[:, :-offset] + r_cur], dim=1))
        offset *= 2
    return dec, drv


def ssm_block(p: dict, x: torch.Tensor, cfg, *, state: dict | None = None,
              prefix: str = "", mesh=None, seq=None):
    """x: (B, S, D) -> ((B, S, D), state); state {"h": (B, Din, N), "conv":
    (B, K-1, Din)} enables stateful decode.  ``mesh``: tensor-parallel over
    its ``model`` axis, the scan on the rank's Din / m channels (the module
    docstring); ``seq`` (a ``layers.SeqShard``): ``x`` is the rank's rows
    of the sequence and so is the output."""
    ranks, r = model_split(mesh, state, "SSM")
    if ranks > 1:
        x = tp_enter(x, mesh, seq)
    b, s, d = x.shape
    din = cfg.ssm_expand * d
    n = cfg.ssm_state

    def g(name):
        w = p[prefix + name]
        replicated = name in ("ssm_conv", "ssm_bc_proj", "ssm_a_log")
        return coll.copy_to_axis(w, mesh, "model") if ranks > 1 and replicated else w

    xs, z = gather_columns(x @ g("ssm_in_proj"), mesh, ranks).split(din, dim=-1)
    xs, new_conv = _causal_conv(xs, g("ssm_conv"),
                                None if state is None else state["conv"])
    xs = F.silu(xs)

    bcd = xs @ g("ssm_bc_proj")                       # (B, S, 2N+1)
    b_t = bcd[..., :n].float()                        # (B, S, N)
    c_t = bcd[..., n: 2 * n].float()
    dt = F.softplus(bcd[..., -1:].float())            # (B, S, 1)
    # this rank's channels (all of them off a mesh)
    din //= ranks
    mine = slice(r * din, (r + 1) * din)
    xs, z = xs[..., mine], z[..., mine]
    a = -torch.exp(g("ssm_a_log")[mine])              # (Din, N)
    u = dt * xs.float()                               # (B, S, Din)

    h = (torch.zeros((b, din, n), dtype=torch.float32, device=x.device)
         if state is None else state["h"].float())
    if s == 1:
        h = torch.exp(dt[:, 0, :, None] * a) * h + u[:, 0, :, None] * b_t[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", h, c_t[:, 0])[:, None]
    else:
        ys = []
        for t0 in range(0, s, CHUNK):
            sl = slice(t0, t0 + CHUNK)
            decay = torch.exp(dt[:, sl, :, None] * a)     # (B, c, Din, N)
            drive = u[:, sl, :, None] * b_t[:, sl, None, :]
            dec_cum, drv_cum = _scan(decay, drive)
            h_all = dec_cum * h[:, None] + drv_cum        # (B, c, Din, N)
            ys.append(torch.einsum("bcdn,bcn->bcd", h_all, c_t[:, sl]))
            h = h_all[:, -1]
        y = torch.cat(ys, dim=1)

    y = y.to(x.dtype) + xs * g("ssm_d").to(x.dtype)[None, None]
    y = (y * F.silu(z)) @ g("ssm_out_proj")
    if ranks > 1:
        y = tp_leave(y, mesh, seq)
    return y, {"h": h, "conv": new_conv}


def init_ssm_state(cfg, batch: int, n_layers: int, device=None) -> dict:
    din = cfg.ssm_expand * cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((n_layers, batch, din, cfg.ssm_state), **f32),
            "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, din), **f32)}
