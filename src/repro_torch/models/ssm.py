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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "init_ssm", "ssm_block", "init_ssm_state"]

CHUNK = 128


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
              prefix: str = ""):
    """x: (B, S, D) -> ((B, S, D), state); state {"h": (B, Din, N), "conv":
    (B, K-1, Din)} enables stateful decode."""
    b, s, d = x.shape
    din = cfg.ssm_expand * d
    n = cfg.ssm_state

    def g(name):
        return p[prefix + name]

    xs, z = (x @ g("ssm_in_proj")).split(din, dim=-1)
    xs, new_conv = _causal_conv(xs, g("ssm_conv"),
                                None if state is None else state["conv"])
    xs = F.silu(xs)

    bcd = xs @ g("ssm_bc_proj")                       # (B, S, 2N+1)
    b_t = bcd[..., :n].float()                        # (B, S, N)
    c_t = bcd[..., n: 2 * n].float()
    dt = F.softplus(bcd[..., -1:].float())            # (B, S, 1)
    a = -torch.exp(g("ssm_a_log"))                    # (Din, N)
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
    y = y * F.silu(z)
    return y @ g("ssm_out_proj"), {"h": h, "conv": new_conv}


def init_ssm_state(cfg, batch: int, n_layers: int, device=None) -> dict:
    din = cfg.ssm_expand * cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((n_layers, batch, din, cfg.ssm_state), **f32),
            "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, din), **f32)}
