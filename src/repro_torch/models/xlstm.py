"""xLSTM blocks: chunkwise-parallel mLSTM and recurrent sLSTM.

The port of the reference package's ``models/xlstm.py``.  mLSTM (matrix
memory, xLSTM §2.3) runs in its chunkwise-parallel form: within a chunk of
:data:`CHUNK` positions a (chunk x chunk) score matrix per head, across
chunks the (head_dim x head_dim) matrix state ``c`` with its normalizer
``n``, both carried with the log-space stabilizer ``m`` so that the
exponential gates stay finite.  A ragged last chunk is padded as the
reference pads it (``log_i`` with -1e30, so a padded position adds nothing
to the state).  One position (``s == 1``, decode) takes the step
recurrence.  The reference's ``lax.scan`` over the chunks is a Python loop
here.  sLSTM (scalar memory) is a true sequential recurrence: the
reference's ``lax.scan`` over positions becomes a Python loop, in float32,
with the diagonal recurrent gate ``r * h_prev``.

The head width of both blocks is ``PROJ_FACTOR * d_model / n_heads`` (1,024
for xlstm-1.3b), not ``cfg.head_dim``.  States are float32 in every model
dtype.  With a state, the mLSTM step writes the new state into the given
tensors in place (the serving cache's slices: xlstm-1.3b's ``c`` is 33.5 MB
a layer at B = 2) and returns them; the chunkwise form and the sLSTM return
new tensors, which ``transformer.run_stage`` copies into the cache.

On a mesh with a ``model`` axis of ``m`` ranks (training only) both blocks
are tensor-parallel under the reference's placements, which split the
projections' columns (``m_in_proj``, ``m_wq``/``m_wk``/``m_wv``' last dim,
``m_wif``, ``s_w_in``) and the rows of the output projections: a rank's
column block is not its heads or channels (with m = 2, ``m_in_proj``'s
block on rank 0 is xs and on rank 1 z), so each rank gathers the
projections over ``model`` (``dist.collectives.gather_over_axis``: the
gradient summed back and cut to the rank's block).  The recurrence then
runs on the rank's ``H / m`` heads (mLSTM; a rank carries ``1 / m`` of the
``c`` state) or ``D / m`` channels (sLSTM, elementwise per channel, with
the rank's slice of ``s_r_gate``), and the row-parallel output projection's
partial sums are all-reduced over ``model``.  The input is replicated over
``model`` and its gradient summed over it (``copy_to_axis``); under
sequence parallelism the block gathers the sequence from the ranks' rows in
front and reduce-scatters its output back to them (``layers.tp_enter``,
``layers.tp_leave``).  A head width, head count or channel count the axis
does not divide (:func:`mlstm_split`, :func:`slstm_split`) leaves the
block to ``transformer``, which runs it whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import gather_columns, model_split, tp_enter, tp_leave

__all__ = ["CHUNK", "PROJ_FACTOR", "init_mlstm", "mlstm_block", "init_slstm",
           "slstm_block", "init_mlstm_state", "init_slstm_state", "mlstm_split",
           "slstm_split"]

CHUNK = 64
PROJ_FACTOR = 2
NEG = -1e30


def _shp(stacked):
    return (lambda *s: (stacked, *s)) if stacked else (lambda *s: s)


def _normal(generator, shape, scale, dtype, device):
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def mlstm_split(cfg, m: int) -> bool:
    """Whether a model axis of ``m`` ranks splits the mLSTM's heads and its
    head width (and with them every projection the placement splits): the
    block is then tensor-parallel."""
    hd = PROJ_FACTOR * cfg.d_model // cfg.n_heads
    return cfg.n_heads % m == 0 and hd % m == 0


def slstm_split(cfg, m: int) -> bool:
    """Whether a model axis of ``m`` ranks splits the sLSTM's channels."""
    return cfg.d_model % m == 0


def init_mlstm(generator: torch.Generator, cfg, dtype, stacked: int = 0,
               device=None) -> dict:
    """mLSTM weights with the reference's keys and scales, drawn from
    ``generator``; q/k/v are block-diagonal per head, (H, hd, hd)."""
    d = cfg.d_model
    din = PROJ_FACTOR * d
    h = cfg.n_heads
    hd = din // h
    shp = _shp(stacked)
    pre = "stk_" if stacked else ""
    return {
        pre + "m_in_proj": _normal(generator, shp(d, 2 * din), d ** -0.5, dtype, device),
        pre + "m_wq": _normal(generator, shp(h, hd, hd), hd ** -0.5, dtype, device),
        pre + "m_wk": _normal(generator, shp(h, hd, hd), hd ** -0.5, dtype, device),
        pre + "m_wv": _normal(generator, shp(h, hd, hd), hd ** -0.5, dtype, device),
        pre + "m_wif": _normal(generator, shp(din, 2 * h), din ** -0.5, dtype, device),
        pre + "m_out_proj": _normal(generator, shp(din, d), din ** -0.5, dtype, device),
    }


def _mlstm_chunk(qb, kb, vb, li, lf, c_in, n_in, m_in, tril):
    """One chunk of the chunkwise form: (B, c, H, hd) q/k/v, (B, c, H) gate
    logs, the carried (c, n, m) -> (y (B, c, H, hd), c, n, m at its end)."""
    lf_cum = torch.cumsum(lf, dim=1)                          # (B, c, H)
    a_log = lf_cum + m_in[:, None]                            # old state's decay
    # weight of position j in position t: exp(lf_cum_t - lf_cum_j + li_j)
    b_log = lf_cum[:, :, None] - lf_cum[:, None, :] + li[:, None]  # (B, t, j, H)
    m_new = torch.maximum(a_log, torch.where(tril, b_log, float("-inf")).amax(dim=2))
    scale_old = torch.exp(a_log - m_new)                      # (B, c, H)
    # masked before the exponential: above the diagonal b_log - m_new may
    # overflow, and a where after the exp would pass 0 * inf = nan back
    w_in = torch.exp(torch.where(tril, b_log - m_new[:, :, None], float("-inf")))
    scores = torch.einsum("bthd,bjhd->btjh", qb, kb) * w_in
    num_intra = torch.einsum("btjh,bjhd->bthd", scores, vb)
    num_inter = torch.einsum("bthd,bhde->bthe", qb, c_in) * scale_old[..., None]
    den_intra = scores.sum(dim=2)
    den_inter = torch.einsum("bthd,bhd->bth", qb, n_in) * scale_old
    den = torch.abs(den_intra + den_inter)
    y = (num_intra + num_inter) / torch.clamp(den, min=1.0)[..., None]
    # the state at the chunk's end
    m_end = m_new[:, -1]
    w_end = torch.exp(lf_cum[:, -1:] - lf_cum + li - m_end[:, None])
    kw = kb * w_end[..., None]
    carry = torch.exp(lf_cum[:, -1] + m_in - m_end)           # (B, H)
    c_out = carry[..., None, None] * c_in + torch.einsum("bjhd,bjhe->bhde", kw, vb)
    n_out = carry[..., None] * n_in + kw.sum(1)
    return y, c_out, n_out, m_end


def mlstm_block(p: dict, x: torch.Tensor, cfg, *, state: dict | None = None,
                mesh=None, seq=None):
    """x: (B, S, D) -> ((B, S, D), state); state {"c": (B, H, hd, hd), "n":
    (B, H, hd), "m": (B, H)}, float32, enables stateful decode.  The step
    (S = 1) updates a given state in place.  ``mesh``: tensor-parallel
    over its ``model`` axis (the module docstring; the returned state is
    the rank's heads'); ``seq`` (a ``layers.SeqShard``): ``x`` is the
    rank's rows of the sequence and so is the output."""
    ranks, r = model_split(mesh, state, "mLSTM")
    if ranks > 1:
        x = tp_enter(x, mesh, seq)
    b, s, d = x.shape
    din = PROJ_FACTOR * d
    hd = din // cfg.n_heads

    xs, z = gather_columns(x @ p["m_in_proj"], mesh, ranks).split(din, dim=-1)
    xh = xs.reshape(b, s, cfg.n_heads, hd)
    qkv = torch.stack([torch.einsum("bshd,hde->bshe", xh, p[w])
                       for w in ("m_wq", "m_wk", "m_wv")])   # (3, B, S, H, hd)
    qkv = gather_columns(qkv, mesh, ranks)
    gates = gather_columns(xs @ p["m_wif"], mesh, ranks).float()     # (B, S, 2H)
    # this rank's heads (all of them off a mesh) and their columns of z
    h = cfg.n_heads // ranks
    heads = slice(r * h, (r + 1) * h)
    qkv = qkv[:, :, :, heads].float()
    q, k, v = qkv[0] * hd ** -0.5, qkv[1] * hd ** -0.5, qkv[2]
    log_i = F.logsigmoid(gates[..., heads])
    log_f = F.logsigmoid(gates[..., cfg.n_heads:][..., heads])
    din //= ranks
    z = z[..., r * din: (r + 1) * din]

    if state is None:
        c0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
        m0 = torch.full((b, h), NEG, dtype=torch.float32, device=x.device)
    else:
        c0, n0, m0 = state["c"], state["n"], state["m"]

    if s == 1:
        li, lf = log_i[:, 0], log_f[:, 0]                     # (B, H)
        q0, k0, v0 = q[:, 0], k[:, 0], v[:, 0]                # (B, H, hd)
        m_new = torch.maximum(lf + m0, li)
        f_sc = torch.exp(lf + m0 - m_new)
        i_sc = torch.exp(li - m_new)
        # in place: c = f c + (i k) v^T as one rank-1 update per head
        c = c0.mul_(f_sc[..., None, None])
        c.view(b * h, hd, hd).baddbmm_((i_sc[..., None] * k0).reshape(b * h, hd, 1),
                                       v0.reshape(b * h, 1, hd))
        n = n0.mul_(f_sc[..., None]).add_(i_sc[..., None] * k0)
        m = m0.copy_(m_new)
        num = torch.matmul(q0[..., None, :], c)[..., 0, :]    # (B, H, hd)
        den = torch.abs((q0 * n).sum(-1))
        y = (num / torch.clamp(den, min=1.0)[..., None]).reshape(b, 1, din)
        new_state = {"c": c, "n": n, "m": m}
    else:
        chunk = min(CHUNK, s)
        pad = (-s) % chunk
        if pad:
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG)
            log_f = F.pad(log_f, (0, 0, 0, pad))
        tril = torch.ones((chunk, chunk), dtype=torch.bool,
                          device=x.device).tril()[None, :, :, None]
        c_in, n_in, m_in = c0, n0, m0
        ys = []
        for t0 in range(0, s + pad, chunk):
            sl = slice(t0, t0 + chunk)
            y_c, c_in, n_in, m_in = _mlstm_chunk(
                q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], log_f[:, sl],
                c_in, n_in, m_in, tril)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)[:, :s].reshape(b, s, din)
        new_state = {"c": c_in, "n": n_in, "m": m_in}

    y = (y.to(x.dtype) * F.silu(z)) @ p["m_out_proj"]
    if ranks > 1:
        y = tp_leave(y, mesh, seq)
    return y, new_state


def init_slstm(generator: torch.Generator, cfg, dtype, stacked: int = 0,
               device=None) -> dict:
    """sLSTM weights with the reference's keys and scales: the fused
    z|i|f|o input projection (d, 4d), the diagonal recurrent gate (d,),
    the output projection (d, d)."""
    d = cfg.d_model
    shp = _shp(stacked)
    pre = "stk_" if stacked else ""
    return {
        pre + "s_w_in": _normal(generator, shp(d, 4 * d), d ** -0.5, dtype, device),
        pre + "s_r_gate": _normal(generator, shp(d), 0.1, dtype, device),
        pre + "s_out_proj": _normal(generator, shp(d, d), d ** -0.5, dtype, device),
    }


def slstm_block(p: dict, x: torch.Tensor, cfg, *, state: dict | None = None,
                mesh=None, seq=None):
    """Sequential scalar-memory LSTM with exponential gating (sLSTM).

    state {"c", "n", "m", "h"}: (B, D) each, float32.  A Python loop over
    the positions, one step's elementwise ops at a time (a plain version:
    the reference has no kernel here either).  ``mesh``: tensor-parallel
    over its ``model`` axis, the rank's D / m channels (the module
    docstring); ``seq`` as for :func:`mlstm_block`."""
    ranks, rank = model_split(mesh, state, "sLSTM")
    if ranks > 1:
        x = tp_enter(x, mesh, seq)
    b, s, d = x.shape
    pre = gather_columns(x @ p["s_w_in"], mesh, ranks)        # (B, S, 4D)
    if ranks > 1:
        # z, i, f and o of this rank's channels
        d //= ranks
        pre = pre.unflatten(-1, (4, ranks, d))[..., rank, :].flatten(-2)
    pre = pre.float().transpose(0, 1).contiguous()            # (S, B, 4D)
    z_in, i_in, f_in, o_in = pre.split(d, dim=-1)
    # each position's rows as views made at once: an index per position
    # would be an autograd node of its own whose backward writes a zero
    # tensor of the whole sequence (1,024 of them a gate and layer)
    z_in, i_in, f_in, o_sig = (t.unbind(0) for t in (z_in, i_in, f_in,
                                                     torch.sigmoid(o_in)))
    r = p["s_r_gate"].float()

    if state is None:
        c = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        m = torch.full((b, d), NEG, dtype=torch.float32, device=x.device)
        h = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    else:
        c, n, m, h = state["c"], state["n"], state["m"], state["h"]

    hs = []
    for t in range(s):
        rh = r * h
        zt = torch.tanh(z_in[t] + rh)
        lfm = F.logsigmoid(f_in[t] + rh) + m                  # log f + m
        m_new = torch.maximum(lfm, i_in[t])
        i_sc = torch.exp(i_in[t] - m_new)
        f_sc = torch.exp(lfm - m_new)
        c = f_sc * c + i_sc * zt
        n = f_sc * n + i_sc
        h = o_sig[t] * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype) @ p["s_out_proj"]  # (B, S, D)
    if ranks > 1:
        y = tp_leave(y, mesh, seq)
    return y, {"c": c, "n": n, "m": m, "h": h}


def init_mlstm_state(cfg, batch: int, n_layers: int, device=None) -> dict:
    din = PROJ_FACTOR * cfg.d_model
    h = cfg.n_heads
    hd = din // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((n_layers, batch, h, hd, hd), **f32),
            "n": torch.zeros((n_layers, batch, h, hd), **f32),
            "m": torch.full((n_layers, batch, h), NEG, **f32)}


def init_slstm_state(cfg, batch: int, n_layers: int, device=None) -> dict:
    shape = (n_layers, batch, cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "m": torch.full(shape, NEG, **f32), "h": torch.zeros(shape, **f32)}
