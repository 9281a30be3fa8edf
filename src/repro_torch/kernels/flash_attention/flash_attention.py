"""ctypes binding of the flash-attention CUDA kernels: the forward
(``csrc/flash_attention.cu``) and its backward
(``csrc/flash_attention_bwd.cu``).

The forward's launch counter ``flash_attention.launches`` (every launch)
and one counter per variant in ``flash_attention.variant_launches``:
``wgmma_bf16`` (bfloat16 inputs, the tensor-core kernel the served model
runs) and ``fma_f32`` (float32 inputs, the CUDA-core kernel).  The dtype
picks the variant; neither falls back to the other, and a failed launch
raises.  ``flash_attention.mask_launches`` splits the launches by what a
call attends over: ``causal`` (a causal mask, with or without a window),
``full`` (non-causal over the queries' own rows, whisper's encoder) and
``cross`` (keys that are not the queries).  ``flash_attention(..., return_lse=True)`` also returns each row's
log-sum-exp, which the backward reads.

The backward's counters, ``flash_attention_bwd.launches``,
``flash_attention_bwd.variant_launches`` (``wgmma_bf16``: the tensor-core
kernels; ``fma_f32``: the CUDA-core kernels) and
``flash_attention_bwd.mask_launches`` (split as the forward's), count one
per call: a call launches its kernels together (bf16: delta, dK/dV, the
reduction of the dK/dV partials where the plan splits a group, dQ;
float32: the P/dS kernel, then the dK/dV and dQ kernel).  :func:`bwd_plan`
mirrors the CUDA plan of the bf16 path (how a group's query heads are
split over dK/dV blocks, the shared memory per block, the scratch) and
:func:`f32_plan` that of both float32 kernels (instances, blocks and
their order, shared memory, the scratch of kept tiles) for the tests.

Both directions take keys that are not the queries (whisper's
cross-attention: k and v of Sk rows against q of S rows) without a causal
mask or a window; the other combinations at Sk != S raise ``ValueError``
before any card is looked for.

The kernel reads q, k and v and writes the output through their strides, so
a (B, H, S, D) view of the model's (B, S, H, D) activations
(``x.transpose(1, 2)``) is passed as it is, with no transpose copy; the
output takes q's memory layout (``torch.empty_like``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from .._layout import rows_of_16_bytes

__all__ = ["flash_attention", "flash_attention_bwd", "bwd_plan", "BwdPlan",
           "bwd_dkdv_blocks", "f32_plan", "F32Plan", "f32_fwd_blocks",
           "f32_ds_blocks", "f32_grad_blocks", "f32_tile_index"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {torch.float32: "fma_f32", torch.bfloat16: "wgmma_bf16"}
_BWD_VARIANTS = {torch.float32: "fma_f32", torch.bfloat16: "wgmma_bf16"}
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library()
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_launch.argtypes = [
            vp, vp, vp, vp, i, i, i, i, i, i, i, strides, ctypes.c_float,
            ctypes.c_float, i, i, vp, i, vp]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, strides,
            ctypes.c_float, ctypes.c_float, i, i, i, vp]
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_launch_split.argtypes = [
            *lib.flash_attention_bwd_launch.argtypes, i]
        lib.flash_attention_bwd_launch_split.restype = ctypes.c_int
        lib.flash_attention_bwd_plan.argtypes = [
            i, i, i, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
        lib.flash_attention_bwd_plan.restype = ctypes.c_longlong
        lib.flash_attention_f32_plan.argtypes = [i, ctypes.POINTER(ctypes.c_longlong)]
        lib.flash_attention_f32_plan.restype = ctypes.c_int
        _BOUND = True
    return lib


def _check(named):
    """Device, rank and dtype checks shared by the forward and backward."""
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {name} "
                             f"on {t.device}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    dtypes = [t.dtype for _, t in named]
    if dtypes[0] not in _DTYPES or any(x != dtypes[0] for x in dtypes):
        raise ValueError(f"expected float32 or bfloat16 "
                         f"{', '.join(n for n, _ in named)} of one dtype, got "
                         f"{', '.join(str(x) for x in dtypes)}")


def _check_other_keys(q, k, causal, window):
    """The one rule of shapes that reads no device, checked first by both
    directions, so it holds (and is tested) on a host without a card too:
    keys that are not the queries (Sk != S) take neither a causal mask nor
    a window."""
    if (q.ndim == 4 and k.ndim == 4 and k.shape[2] != q.shape[2]
            and (causal or window)):
        raise ValueError(
            f"k has {k.shape[2]} rows and q {q.shape[2]}: keys that are not "
            f"the queries take neither a causal mask nor a window (got "
            f"causal={bool(causal)}, window={window})")


def _shapes(q, k, v, window):
    """(B, H, Hkv, S, Sk, D) of a call, checked: q (B, H, S, D), k and v
    (B, Hkv, Sk, D)."""
    b, h, s, d = q.shape
    _, hkv, sk, dk = k.shape
    if (k.shape != v.shape or k.shape[0] != b or dk != d or hkv == 0
            or h % hkv or (sk == 0 and s > 0)):
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"head_dim {d}: the kernel takes a multiple of 8 up "
                         "to 256")
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = none), got {window}")
    return b, h, hkv, s, sk, d


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    """An output in ``t``'s memory layout (a view of the model's (B, S, H,
    D) activations gets one too), contiguous where that layout does not give
    16-byte rows."""
    out = torch.empty_like(t)
    return out if out.numel() == 0 else rows_of_16_bytes(out)


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(st for t in ts for st in t.stride()[:3]))


def _mask_kind(s, sk, causal) -> str:
    """The key of a call in ``mask_launches``."""
    return "cross" if sk != s else "causal" if causal else "full"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale=None, softcap: float = 0.0,
                    return_lse: bool = False):
    """q: (B, H, S, D); k/v: (B, Hkv, Sk, D) on the card, float32 or
    bfloat16 -> (B, H, S, D) in q's dtype (bfloat16: the wgmma kernel;
    float32: the FMA kernel).  ``window`` 0 means no window
    (:func:`.ops.multi_head_attention` maps ``None`` to 0).  Sk != S (keys
    that are not the queries, whisper's cross-attention) only with
    ``causal=False`` and no window, the one such call the reference model
    makes; the other combinations raise ``ValueError``.  ``softcap`` > 0
    caps each scaled score x at ``softcap * tanh(x / softcap)`` before the
    softmax (0 = none).

    With ``return_lse`` returns ``(out, lse)``: ``lse`` (B, H, S) float32,
    each row's natural log-sum-exp of its kept (capped) scores times
    ``sm_scale`` (+inf for a row that keeps none)."""
    _check_other_keys(q, k, causal, window)
    _check((("q", q), ("k", k), ("v", v)))
    b, h, hkv, s, sk, d = _shapes(q, k, v, window)
    if not softcap >= 0:
        raise ValueError(f"softcap must be >= 0 (0 = none), got {softcap}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    q, k, v = rows_of_16_bytes(q), rows_of_16_bytes(k), rows_of_16_bytes(v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, h, hkv, s, sk, d, _strides(q, k, v, out),
        float(sm_scale), float(softcap), int(bool(causal)), int(window),
        None if lse is None else lse.data_ptr(), q.device.index, stream)
    variant = _VARIANTS[q.dtype]
    _build.check(code, f"flash_attention ({variant})")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    flash_attention.mask_launches[_mask_kind(s, sk, causal)] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(_VARIANTS.values(), 0)
flash_attention.mask_launches = dict.fromkeys(("causal", "full", "cross"), 0)


# the bf16 backward's plan (csrc/flash_attention_bwd.cu, wg::plan and the
# two kernels' shared-memory layouts), mirrored for the tests
_TILE = 64
_PANEL_BYTES = 64 * 128
_TARGET_BLOCKS = 256


class BwdPlan(NamedTuple):
    kd: int               # D padded to 64, 128 or 256
    n_kt: int             # 64-row k tiles, of Sk rows
    heads_per_block: int  # query heads of a group summed inside a dK/dV block
    n_split: int          # dK/dV blocks per (k tile, KV head, b)
    dkdv_blocks: int
    dq_blocks: int        # one per 64-row q tile (of S rows), head and b
    dkdv_smem: int        # dynamic shared memory bytes per block
    dq_smem: int
    scratch_floats: int   # delta, then the float32 partial dK and dV


def bwd_plan(b, h, hkv, s, d, window=0, heads_per_block=0, sk=None) -> BwdPlan:
    """The split of a bf16 backward call, a function of the shape alone:
    the largest divisor of the group G = H / Hkv that still gives 256
    dK/dV blocks (about two waves on the H100's 132 SMs, one block per SM;
    the fastest of the divisors at the shapes ``launch/bwd_splits.py``
    times), else one head per block.  ``heads_per_block`` > 0 overrides
    the rule.  ``sk``: the key rows (``None``: ``s``, self-attention); the
    dK/dV blocks and the partials follow them, the dQ blocks the ``s``
    query rows.  ``window`` is part of the signature; this rule does not
    read it."""
    del window
    sk = s if sk is None else sk
    group = h // hkv
    kd = 64 if d <= 64 else 128 if d <= 128 else 256
    n_kt = -(-sk // _TILE)
    hpb = heads_per_block or next(
        (x for x in range(group, 0, -1)
         if group % x == 0 and n_kt * hkv * b * (group // x) >= _TARGET_BLOCKS), 1)
    n_split = group // hpb
    tile = kd // 64 * _PANEL_BYTES
    slack = 64 + 1024                       # mbarriers, 1,024-byte alignment
    dkdv_smem = 2 * tile + 2 * 2 * tile + _TILE * _TILE * 4 + slack
    dq_smem = 2 * tile + 2 * 2 * tile + slack
    delta = -(-(b * h * s) // 64) * 64
    part = n_split * b * hkv * sk * d if n_split > 1 else 0
    return BwdPlan(kd, n_kt, hpb, n_split, n_kt * hkv * n_split * b,
                   -(-s // _TILE) * h * b, dkdv_smem, dq_smem, delta + 2 * part)


def bwd_dkdv_blocks(plan: BwdPlan, b, h, hkv):
    """(k tile, batch, query heads) of every dK/dV block, in launch order,
    by the kernel's index arithmetic: blockIdx = (hk * n_split + split, b,
    k tile)."""
    group = h // hkv
    for z in range(plan.n_kt):
        for y in range(b):
            for x in range(hkv * plan.n_split):
                hk, split = divmod(x, plan.n_split)
                h0 = hk * group + split * plan.heads_per_block
                yield z, y, tuple(range(h0, h0 + plan.heads_per_block))


# the float32 kernels' plan (csrc/flash_attention.cu f32::Fwd;
# csrc/flash_attention_bwd.cu bwd::DsLayout, bwd::GradLayout, grad_block;
# csrc/attention_f32.cuh tile_lo, tile_hi), mirrored for the tests
_F32_TILE = 64          # q rows of a forward block; the backward's tiles


class F32Plan(NamedTuple):
    b: int
    h: int
    hkv: int
    s: int
    sk: int
    d: int
    causal: bool
    window: int
    kd: int               # the instance: D rounded up to 16, 32, 64, 128 or 256
    fwd_threads: int      # 8 row groups x key groups
    fwd_bk: int           # keys per forward k tile (64 q rows a block)
    fwd_slots: int        # ring slots the K and V tiles take in turn
    fwd_smem: int         # dynamic shared memory bytes per block
    fwd_blocks: int       # one per (64-row q tile, head, b)
    ds_threads: int       # flash_attention_bwd_ds_kernel
    ds_smem: int
    ds_blocks: int        # one per (64-row q tile, head, b)
    grad_threads: int     # flash_attention_bwd_grad_kernel: dK/dV and dQ blocks
    grad_smem: int
    dkdv_blocks: int      # one per (64-row k tile, KV head, b), the group inside
    dq_blocks: int        # one per (64-row q tile, head, b)
    tiles_per_head: int   # kept 64 x 64 (q, k) tiles of one head
    scratch_floats: int   # a P and a dS tile of floats for each
    fwd_launches: int     # kernels a forward call launches
    bwd_launches: int     # kernels a backward call launches


def _f32_instance(d):
    return 16 if d <= 16 else 32 if d <= 32 else 64 if d <= 64 else 128 if d <= 128 else 256


def _tile_lo(qt, bq, bk, window):
    """The first k tile (of ``bk`` keys) q tile ``qt`` (of ``bq`` rows)
    keeps a pair of (csrc/attention_f32.cuh tile_lo)."""
    first = qt * bq - window + 1
    return first // bk if window > 0 and first > 0 else 0


def _tile_hi(qt, bq, bk, s, sk, causal):
    """The last k tile q tile ``qt`` keeps a pair of (tile_hi)."""
    last_tile = -(-sk // bk) - 1
    if not causal:
        return last_tile
    return min(min(qt * bq + bq - 1, s - 1) // bk, last_tile)


def _tiles_before(qt, s, sk, causal, window):
    return sum(_tile_hi(t, _F32_TILE, _F32_TILE, s, sk, causal)
               - _tile_lo(t, _F32_TILE, _F32_TILE, window) + 1 for t in range(qt))


def f32_plan(b, h, hkv, s, d, window=0, sk=None, causal=True) -> F32Plan:
    """The float32 forward's and backward's tiles, instance, blocks, shared
    memory, scratch and launches of a call, a function of the shape alone
    (``sk``: the key rows, ``None`` for ``s``; ``causal`` and ``window`` as
    in the call: they decide which 64 x 64 tiles the backward keeps)."""
    sk = s if sk is None else sk
    kd = _f32_instance(d)
    groups = 16 if kd >= 64 else kd // 4
    bk, slots = 4 * groups, 2 if kd >= 128 else 4
    nqt, nkt = -(-s // _F32_TILE), -(-sk // _F32_TILE)
    cols = min(32, kd)                      # head columns per ds-kernel item
    tc = 8 if kd >= 128 else 4              # output columns a grad-kernel thread
    tph = _tiles_before(nqt, s, sk, causal, window)
    return F32Plan(
        b, h, hkv, s, sk, d, bool(causal), window, kd,
        fwd_threads=8 * groups, fwd_bk=bk, fwd_slots=slots,
        fwd_smem=(_F32_TILE * kd + slots * bk * kd + bk * _F32_TILE) * 4,
        fwd_blocks=nqt * h * b,
        ds_threads=128, ds_smem=(3 * 4 * _F32_TILE * cols + 2 * _F32_TILE) * 4,
        ds_blocks=nqt * h * b,
        grad_threads=8 * (kd // tc), grad_smem=3 * 16 * (2 * _F32_TILE + 2 * kd) * 4,
        dkdv_blocks=nkt * hkv * b, dq_blocks=nqt * h * b,
        tiles_per_head=tph, scratch_floats=2 * _F32_TILE * _F32_TILE * b * h * tph,
        fwd_launches=1, bwd_launches=2)


def _f32_q_blocks(plan: F32Plan, bk):
    """(b, head, q tile, k tiles of ``bk`` keys) of every block of a grid
    (H, B, q tiles) in launch order: the q tile slowest and, causal, the
    last (heaviest) first."""
    nqt = -(-plan.s // _F32_TILE)
    for z in range(nqt):
        qt = nqt - 1 - z if plan.causal else z
        kts = range(_tile_lo(qt, _F32_TILE, bk, plan.window),
                    _tile_hi(qt, _F32_TILE, bk, plan.s, plan.sk, plan.causal) + 1)
        for bb in range(plan.b):
            for head in range(plan.h):
                yield bb, head, qt, kts


def f32_fwd_blocks(plan: F32Plan):
    """The forward's blocks, as ``_f32_q_blocks``: k tiles of
    ``plan.fwd_bk`` keys."""
    return _f32_q_blocks(plan, plan.fwd_bk)


def f32_ds_blocks(plan: F32Plan):
    """flash_attention_bwd_ds_kernel's blocks, as ``_f32_q_blocks``: 64-key
    tiles; each writes the P and dS tiles ``f32_tile_index`` names."""
    return _f32_q_blocks(plan, _F32_TILE)


def f32_tile_index(plan: F32Plan, bb, head, qt, kt):
    """The index of kept tile (qt, kt) of head ``head`` of batch ``bb`` in
    the backward's scratch (its P tile at 2 x 4,096 floats times it)."""
    return ((bb * plan.h + head) * plan.tiles_per_head
            + _tiles_before(qt, plan.s, plan.sk, plan.causal, plan.window)
            + kt - _tile_lo(qt, _F32_TILE, _F32_TILE, plan.window))


def f32_grad_blocks(plan: F32Plan):
    """Every flash_attention_bwd_grad_kernel block in launch order (the
    kernel's grad_block): ``("dkdv", k tile, KV head, b, [(head, q tile),
    ...])``, the q tiles that keep the k tile for each head of the group
    in order, or ``("dq", q tile, head, b, k tiles)``.  Causal: rank r
    holds the dK/dV blocks of k tile r, then the dQ blocks of q tile
    nqt - 1 - r; otherwise every dK/dV block, then every dQ block."""
    b, h, hkv = plan.b, plan.h, plan.hkv
    group = h // hkv
    nqt, nkt = -(-plan.s // _F32_TILE), -(-plan.sk // _F32_TILE)
    lo = [_tile_lo(t, _F32_TILE, _F32_TILE, plan.window) for t in range(nqt)]
    hi = [_tile_hi(t, _F32_TILE, _F32_TILE, plan.s, plan.sk, plan.causal)
          for t in range(nqt)]

    def dkdv(kt):
        qts = [t for t in range(nqt) if lo[t] <= kt <= hi[t]]
        for j in range(hkv * b):
            hk, bb = j % hkv, j // hkv
            yield ("dkdv", kt, hk, bb,
                   [(hk * group + gi, t) for gi in range(group) for t in qts])

    def dq(qt):
        for j in range(h * b):
            head, bb = j % h, j // h
            yield "dq", qt, head, bb, range(lo[qt], hi[qt] + 1)

    if plan.causal:
        for r in range(nqt):
            yield from dkdv(r)
            yield from dq(nqt - 1 - r)
    else:
        for kt in range(nkt):
            yield from dkdv(kt)
        for qt in range(nqt):
            yield from dq(qt)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0, sm_scale=None, softcap: float = 0.0):
    """Gradients of :func:`flash_attention` on the card: q, out, dout
    (B, H, S, D), k/v (B, Hkv, Sk, D), all float32 or all bfloat16, and the
    forward's ``lse`` (B, H, S) float32 -> ``(dq, dk, dv)`` in the inputs'
    dtype and memory layouts, summed in float32 (dk, dv over the G query
    heads of each KV head).  Pass the q, k, v and out the forward read and
    wrote.  Masks and ``softcap`` as in the forward (``window`` 0 = none,
    ``softcap`` 0 = none; pass the forward's ``lse`` of the capped scores;
    Sk != S only with ``causal=False`` and no window).
    bfloat16: the wgmma kernels, P and dS rounded once to bf16 before their
    products; float32: two FMA kernels through a scratch of the kept
    tiles' P and dS (:func:`f32_plan`)."""
    return _bwd(q, k, v, out, dout, lse, causal, window, sm_scale, softcap, 0)


def _bwd(q, k, v, out, dout, lse, causal, window, sm_scale, softcap,
         heads_per_block):
    """:func:`flash_attention_bwd` with the bf16 plan's ``heads_per_block``
    (0 = the rule; ``launch/bwd_splits.py`` times the alternatives)."""
    _check_other_keys(q, k, causal, window)
    _check((("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)))
    b, h, hkv, s, sk, d = _shapes(q, k, v, window)
    if not softcap >= 0:
        raise ValueError(f"softcap must be >= 0 (0 = none), got {softcap}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, s)):
        raise ValueError(f"lse must be ({b}, {h}, {s}) float32 on {q.device}, "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    q, k, v, out, dout = (rows_of_16_bytes(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    lib = _lib()
    n = lib.flash_attention_bwd_plan(_DTYPES[q.dtype], b, h, hkv, s, sk, d,
                                     int(bool(causal)), int(window),
                                     int(heads_per_block), None)
    if n < 0:
        raise ValueError(f"flash_attention_bwd: no plan for B={b} H={h} "
                         f"Hkv={hkv} S={s} Sk={sk} D={d} "
                         f"heads_per_block={heads_per_block}")
    scratch = torch.empty(n, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_bwd_launch_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, h, hkv, s, sk, d,
        _strides(q, k, v, out, dout, dq, dk, dv), float(sm_scale),
        float(softcap), int(bool(causal)), int(window), q.device.index, stream,
        int(heads_per_block))
    variant = _BWD_VARIANTS[q.dtype]
    _build.check(code, f"flash_attention_bwd ({variant})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.variant_launches[variant] += 1
    flash_attention_bwd.mask_launches[_mask_kind(s, sk, causal)] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.variant_launches = dict.fromkeys(_BWD_VARIANTS.values(), 0)
flash_attention_bwd.mask_launches = dict.fromkeys(("causal", "full", "cross"), 0)
