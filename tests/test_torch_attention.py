"""Attention kernels of the port (K6 flash attention, K7 grouped decode
attention) against the JAX package, on the CPU.

The port's plain versions (``ref.py``, which the CUDA kernels are held to on
the card) and the model's plain paths (``flash_chunked``,
``_decode_attend``) take the same numpy inputs as the reference's Pallas
kernels (run in interpret mode, as the reference's own tests run them),
its oracles and its model paths.  Everything is float32; the tolerance,
2e-5 absolute on outputs of magnitude below 4, covers sums taken in another
order by two frameworks.  K6's backward has no Pallas kernel: its plain
version (``attention_ref_bwd``) is held to ``jax.vjp`` of the reference
model's ``flash_chunked`` and to autograd of ``attention_ref`` within 1e-5.

The emulations of the CUDA kernels' arithmetic (``attention_split_p_ref``:
the bf16 kernel's probabilities split into two bf16 terms;
``decode_attention_split_ref``: the cache split into chunks merged in
order) are held to the reference package under the limits the card's
checks use.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.decode_attention import decode_attention_ref as j_decode_ref
from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models.attention import _decode_attend as j_decode_attend
from repro.models.attention import flash_chunked as j_flash_chunked
from repro_torch import kernels as tk
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref,
                                                  decode_attention_split_ref,
                                                  grouped_decode_attention)
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 attention_split_p_ref,
                                                 flash_attention,
                                                 multi_head_attention)
from repro_torch.models.attention import _decode_attend, flash_chunked

TOL = 2e-5


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _qkv(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, h, s, d)), _normal(rng, (b, hkv, s, d)),
            _normal(rng, (b, hkv, s, d)))


# (H, Hkv): G = 1, 2, 8 (8 is gemma-2b's MQA)
HEADS = [(4, 4), (4, 2), (8, 1)]


@pytest.mark.parametrize("s", [5, 37])
@pytest.mark.parametrize("h,hkv", HEADS)
@pytest.mark.parametrize("window", [None, 0, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_reference_kernel_and_oracle(causal, window, h, hkv, s):
    q, k, v = _qkv(2, h, hkv, s, 16, seed=s + h + hkv)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, j_attention_ref(jq, jk, jv, causal=causal, window=window))
    if window == 0:
        # window 0 (not None) masks every column.  The reference kernel then
        # averages v over its padded rows as well (zeros past S), its oracle
        # over the S rows only; the port's plain version follows the oracle,
        # and the model never passes 0 here (ops maps it to None).
        return
    _close(got, j_flash(jq, jk, jv, causal=causal, window=window,
                        block_q=16, block_k=16, interpret=True))


@pytest.mark.parametrize("s", [9, 40])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_ref_at_head_dim_256(window, s):
    """gemma3-4b's head_dim, at a small S."""
    q, k, v = _qkv(1, 4, 2, s, 256, seed=s)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=window or None)
    _close(got, j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, window=window or None, block_q=16,
                        block_k=16, interpret=True))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("h,hkv", HEADS)
def test_ops_maps_window_zero_to_none_and_matches_model_path(h, hkv, window):
    """``multi_head_attention`` reads window 0 as no window (the model's
    global layers pass 0) and agrees with the reference model's
    ``flash_chunked`` and the port's, whose layout is (B, S, H, D)."""
    q, k, v = _qkv(2, h, hkv, 37, 16, seed=h * 3 + window)
    tq, tk_, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = multi_head_attention(tq, tk_, tv, causal=True, window=window)
    if window == 0:
        assert torch.equal(got, multi_head_attention(tq, tk_, tv, causal=True,
                                                     window=None))
    _close(got, attention_ref(tq, tk_, tv, causal=True, window=window or None))
    bshd = [np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)]
    want = j_flash_chunked(*(jnp.asarray(x) for x in bshd), causal=True,
                           window=window, sm_scale=16 ** -0.5, q_chunk=8,
                           k_chunk=16)
    _close(got.transpose(1, 2), want)
    mine = flash_chunked(*(torch.from_numpy(x) for x in bshd), causal=True,
                         window=window, sm_scale=16 ** -0.5, q_chunk=8,
                         k_chunk=16)
    _close(mine, want)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("h,hkv", [(10, 2), (12, 2)])
def test_flash_ref_at_the_new_configs_groups(h, hkv, window):
    """G = 5 (llama4) and 6 (internlm2, grok) at their head_dim of 128."""
    q, k, v = _qkv(1, h, hkv, 40, 128, seed=h + window)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=window or None)
    _close(got, j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, window=window or None, block_q=16,
                        block_k=16, interpret=True))


# grok's soft-cap; the scaled scores of inputs 8x a standard normal reach it
CAP, CAP_Q = 30.0, 8.0


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
@pytest.mark.parametrize("h,hkv", [(4, 4), (12, 2)])
def test_soft_capped_flash_ref_matches_the_reference_model_path(h, hkv, causal,
                                                                 window):
    """K6's plain version with ``softcap=30`` (and its ``multi_head_attention``
    path) against the reference model's ``flash_chunked``, which is the
    only soft-capped attention the JAX package has; the cap changes the
    result."""
    q, k, v = _qkv(2, h, hkv, 29, 16, seed=h + window)
    q = q * CAP_Q
    tq, tk_, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = attention_ref(tq, tk_, tv, causal=causal, window=window or None,
                        softcap=CAP)
    bshd = [jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3))) for x in (q, k, v)]
    want = j_flash_chunked(*bshd, causal=causal, window=window,
                           sm_scale=16 ** -0.5, softcap_val=CAP, q_chunk=8,
                           k_chunk=16)
    _close(got.transpose(1, 2), want)
    via_ops = multi_head_attention(tq, tk_, tv, causal=causal, window=window,
                                   softcap=CAP)
    assert torch.equal(via_ops, got)
    assert float((got - attention_ref(tq, tk_, tv, causal=causal,
                                      window=window or None)).abs().max()) > 1e-2


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("kv,g", [(4, 1), (2, 6), (1, 5)])
def test_soft_capped_decode_ref_matches_the_reference_model_path(kv, g, window):
    """K7's plain version with ``softcap=30`` against the reference model's
    ``_decode_attend`` (one length for the batch, a float32 cache, so its
    cast of p to the cache's dtype rounds nothing)."""
    q, k, v = _decode_inputs(2, kv, g, 24, 16, seed=g + window)
    q = q * CAP_Q
    q1 = q.reshape(2, 1, kv * g, 16)
    want = j_decode_attend(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v),
                           19, 0.25, window, CAP)
    length = torch.full((2,), 19, dtype=torch.int32)
    args = dict(window=window, sm_scale=0.25, softcap=CAP)
    got = decode_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), length, **args)
    _close(got.reshape(2, 1, kv * g, 16), want)
    via_ops = grouped_decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                       length, **args)
    assert torch.equal(via_ops, got)
    split = decode_attention_split_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                       length, chunk=8, **args)
    _close(split.reshape(2, 1, kv * g, 16), want, tol=1e-5)


@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_flash_chunked_matches_reference_model_path(causal, window, cap):
    """The model's CPU prefill path, soft-capping included, at chunk sizes
    that leave ragged ends on both axes."""
    rng = np.random.default_rng(int(cap) + window)
    q = _normal(rng, (2, 29, 4, 16))
    k, v = _normal(rng, (2, 29, 2, 16)), _normal(rng, (2, 29, 2, 16))
    args = dict(causal=causal, window=window, sm_scale=0.25, softcap_val=cap,
                q_chunk=8, k_chunk=12)
    got = flash_chunked(*(torch.from_numpy(x) for x in (q, k, v)), **args)
    want = j_flash_chunked(*(jnp.asarray(x) for x in (q, k, v)), **args)
    _close(got, want)


def _decode_inputs(b, kv, g, s, d, seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, kv, g, d)), _normal(rng, (b, s, kv, d)),
            _normal(rng, (b, s, kv, d)))


@pytest.mark.parametrize("window", [0, 4, 30])
@pytest.mark.parametrize("kv,g", [(4, 1), (2, 2), (1, 8), (2, 3), (2, 5), (1, 6),
                                  (1, 7)])
def test_decode_ref_matches_reference_kernel_and_oracle(kv, g, window):
    """Mixed lengths within the batch, including 1 and the full cache."""
    q, k, v = _decode_inputs(4, kv, g, 40, 16, seed=kv * 10 + g + window)
    length = np.array([1, 17, 39, 40], np.int32)
    got = decode_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(length), window=window)
    jargs = [jnp.asarray(x) for x in (q, k, v, length)]
    _close(got, j_decode_ref(*jargs, window=window))
    _close(got, j_decode(*jargs, window=window, block_s=16, interpret=True))
    cpu = grouped_decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                   torch.from_numpy(length), window=window)
    assert torch.equal(cpu, got)


@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("kv,g", [(4, 1), (1, 8)])
def test_decode_attend_matches_reference_model_path(kv, g, window, cap):
    """The model's CPU decode path, in the reference model's layout
    (q (B, 1, H, D), one length for the batch), and the port's decode ref
    on the same rows when there is no soft-capping."""
    q, k, v = _decode_inputs(2, kv, g, 24, 16, seed=g + window)
    q1 = q.reshape(2, 1, kv * g, 16)
    got = _decode_attend(torch.from_numpy(q1), torch.from_numpy(k),
                         torch.from_numpy(v), 19, 0.25, window, cap)
    want = j_decode_attend(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v),
                           19, 0.25, window, cap)
    _close(got, want)
    if not cap:
        ref = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.full((2,), 19, dtype=torch.int32),
                                   window=window, sm_scale=0.25)
        _close(got.reshape(2, kv, g, 16), ref)


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    tk.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 8, 16, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
    qd, kd, vd = (torch.from_numpy(x) for x in _decode_inputs(1, 2, 2, 8, 16, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(qd, kd, vd, torch.tensor([3], dtype=torch.int32))
    multi_head_attention(q, k, v)
    grouped_decode_attention(qd, kd, vd, torch.tensor([3], dtype=torch.int32))
    assert not any(tk.launch_counts().values())
    assert not any(tk.shape_counts().values())


def test_reset_launch_counts_clears_the_attention_split_by_shape():
    """``kernels.shape_counts`` reads the counters K6, its backward and K7
    keep where they launch (K6 by its mask, K7 by its cache's rows);
    ``reset_launch_counts`` zeroes K6's and forgets K7's rows."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    tk.reset_launch_counts()
    zero = {f"{k}.{m}": 0 for k in ("flash_attention", "flash_attention_bwd")
            for m in ("causal", "full", "cross")}
    assert tk.shape_counts() == zero
    flash_attention.mask_launches["cross"] = 3
    flash_attention_bwd.mask_launches["cross"] = 1
    decode_attention.rows_launches[1500] = 2
    assert tk.shape_counts() == {**zero, "flash_attention.cross": 3,
                                 "flash_attention_bwd.cross": 1,
                                 "decode_attention.rows=1500": 2}
    tk.reset_launch_counts()
    assert not any(tk.shape_counts().values()) and not decode_attention.rows_launches


# ---------------------------------------------------------------------------
# the bf16 kernel's split-P arithmetic and the decode kernel's split cache

# bf16 outputs are held to half a bf16 unit of the float32 result plus the
# float32 order difference, the limit chip_smoke.py sets on the card
BF16_REL, BF16_ATOL = 2.0 ** -8, 1e-5

# (S, window): gemma3-4b's global and local layers at D = 256 with S cut to
# 512 (a window of 1,024 then masks nothing; 128 does), and a ragged S
SPLIT_P_CASES = [(512, None), (512, 1024), (512, 128), (333, 100)]


def _bf16_qkv(s, seed):
    """bf16 q, k, v (B=1, H=8, Hkv=4, D=256, gemma3-4b's heads) and their
    float32 values as numpy arrays."""
    q, k, v = _qkv(1, 8, 4, s, 256, seed=seed)
    tq, tk_, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    return (tq, tk_, tv), [t.float().numpy() for t in (tq, tk_, tv)]


def _bf16_limit_ratio(got, want):
    """Largest |got - want| / (2^-8 |want| + 1e-5) of a bf16 ``got``."""
    want = np.asarray(want, np.float64)
    err = np.abs(got.float().numpy().astype(np.float64) - want)
    return float((err / (BF16_REL * np.abs(want) + BF16_ATOL)).max())


def _reference_flash(qkv32, window):
    return np.asarray(j_flash(*(jnp.asarray(x) for x in qkv32), causal=True,
                              window=window, block_q=128, block_k=128,
                              interpret=True))


@pytest.mark.parametrize("s,window", [(256, None), (333, 100)])
def test_soft_capped_split_p_emulation_holds_the_bf16_limit(s, window):
    """The split-P emulation with grok's cap, rounded once to bf16, against
    the reference model's soft-capped ``flash_chunked`` in float32 on the
    same bf16 values (G = 6, D = 128, q drawn 8x larger so the cap bends
    the scores), under the card's bf16 limit."""
    q, k, v = _qkv(1, 12, 2, s, 128, seed=s)
    tq, tk_, tv = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in (q * CAP_Q, k, v))
    got = attention_split_p_ref(tq, tk_, tv, causal=True, window=window,
                                softcap=CAP)
    bshd = [jnp.asarray(np.ascontiguousarray(t.float().numpy().transpose(0, 2, 1, 3)))
            for t in (tq, tk_, tv)]
    want = j_flash_chunked(*bshd, causal=True, window=window or 0,
                           sm_scale=128 ** -0.5, softcap_val=CAP, q_chunk=128,
                           k_chunk=128)
    want = np.asarray(want).transpose(0, 2, 1, 3)
    assert _bf16_limit_ratio(got.to(torch.bfloat16), want) <= 1.0


@pytest.mark.parametrize("s,window", SPLIT_P_CASES)
def test_split_p_emulation_holds_the_bf16_limit(s, window):
    """p = p_hi + p_lo in bf16 before PV, the output rounded once to bf16,
    against the reference kernel in float32 on the same bf16 values."""
    qkv, qkv32 = _bf16_qkv(s, seed=s + (window or 0))
    got = attention_split_p_ref(*qkv, causal=True, window=window)
    assert got.dtype == torch.float32
    assert _bf16_limit_ratio(got.to(torch.bfloat16), _reference_flash(qkv32, window)) <= 1.0


def _p_rounded_once(q, k, v, window):
    """Attention with p = exp(s - max) rounded once to bf16 before the PV
    product (fp32 sums, normalised by the fp32 sum of p), float32 out."""
    group = q.shape[1] // k.shape[1]
    kk, vv = (t.float().repeat_interleave(group, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * q.shape[-1] ** -0.5
    i = torch.arange(q.shape[2])
    keep = i[None, :] <= i[:, None]
    if window is not None:
        keep &= i[None, :] > i[:, None] - window
    p = torch.exp(torch.where(keep, s, -1e30) - torch.where(keep, s, -1e30).amax(-1, keepdim=True))
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vv)
    return pv / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("s,window", SPLIT_P_CASES)
def test_one_bf16_rounding_of_p_breaks_the_bf16_limit(s, window):
    """The same inputs with p rounded once to bf16 (what flash kernels
    usually run through PV) miss the limit: why the kernel splits P."""
    qkv, qkv32 = _bf16_qkv(s, seed=s + (window or 0))
    got = _p_rounded_once(*qkv, window)
    assert _bf16_limit_ratio(got.to(torch.bfloat16), _reference_flash(qkv32, window)) > 1.0


# lengths at the 64-row chunk edges of a 200-row cache (4 chunks, the last
# ragged), the full cache, and 1 (three chunks wholly past the length)
EDGE_LENGTHS = np.array([1, 63, 64, 65, 128, 129, 199, 200], np.int32)


@pytest.mark.parametrize("window", [0, 1, 40, 64, 100, 1024])
@pytest.mark.parametrize("kv,g", [(4, 1), (2, 2), (1, 8)])
def test_decode_split_emulation_matches_reference_oracle(kv, g, window):
    """Chunks wholly past the length or before the window (weight 0) and
    windows that straddle chunk edges, against the reference oracle and
    the port's plain version within 1e-5 (float32)."""
    q, k, v = _decode_inputs(len(EDGE_LENGTHS), kv, g, 200, 16,
                             seed=kv * 7 + g + window)
    tq, tk_, tv = (torch.from_numpy(x) for x in (q, k, v))
    length = torch.from_numpy(EDGE_LENGTHS)
    got = decode_attention_split_ref(tq, tk_, tv, length, window=window)
    want = j_decode_ref(*(jnp.asarray(x) for x in (q, k, v, EDGE_LENGTHS)),
                        window=window)
    _close(got, want, tol=1e-5)
    _close(got, decode_attention_ref(tq, tk_, tv, length, window=window),
           tol=1e-5)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("kv,g", [(2, 5), (1, 6)])
def test_soft_capped_decode_split_emulation(kv, g, window):
    """The chunked emulation with grok's cap at every chunk-edge length,
    against the port's capped plain version (which the test above holds to
    the reference model's ``_decode_attend``) within 1e-5."""
    q, k, v = _decode_inputs(len(EDGE_LENGTHS), kv, g, 200, 16, seed=g + window)
    tq, tk_, tv = (torch.from_numpy(x) for x in (q * CAP_Q, k, v))
    length = torch.from_numpy(EDGE_LENGTHS)
    got = decode_attention_split_ref(tq, tk_, tv, length, window=window, softcap=CAP)
    _close(got, decode_attention_ref(tq, tk_, tv, length, window=window,
                                     softcap=CAP), tol=1e-5)


@pytest.mark.parametrize("chunk", [1, 16, 64, 256])
def test_decode_split_emulation_at_other_chunk_sizes(chunk):
    """One chunk per row, many chunks, and one chunk over the whole cache."""
    q, k, v = _decode_inputs(len(EDGE_LENGTHS), 2, 4, 200, 16, seed=chunk)
    tq, tk_, tv = (torch.from_numpy(x) for x in (q, k, v))
    length = torch.from_numpy(EDGE_LENGTHS)
    got = decode_attention_split_ref(tq, tk_, tv, length, window=30,
                                     chunk=chunk)
    want = j_decode_ref(*(jnp.asarray(x) for x in (q, k, v, EDGE_LENGTHS)),
                        window=30)
    _close(got, want, tol=1e-5)


# ---------------------------------------------------------------------------
# K6's backward: the plain version of the backward kernels
# ---------------------------------------------------------------------------

BWD_CASES = [  # (B, H, Hkv, S, D, causal, window)
    (2, 4, 4, 40, 16, True, 0),      # G = 1
    (1, 4, 2, 40, 16, True, 8),      # G = 2, a window
    (2, 8, 2, 37, 32, True, 0),      # G = 4, ragged S
    (1, 8, 1, 64, 16, True, 16),     # G = 8 (gemma-2b's MQA), a window
    (2, 8, 1, 29, 16, True, 0),      # G = 8, ragged S
    (1, 4, 1, 33, 16, False, 10),    # non-causal, a window
]


def _bwd_inputs(b, h, hkv, s, d, seed):
    q, k, v = _qkv(b, h, hkv, s, d, seed)
    dout = _normal(np.random.default_rng(seed + 1), (b, h, s, d))
    return q, k, v, dout


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", BWD_CASES)
def test_attention_ref_bwd_matches_the_vjp_of_flash_chunked(b, h, hkv, s, d,
                                                             causal, window):
    """The textbook backward (P from the row log-sum-exp, dK and dV summed
    over the group) against ``jax.vjp`` of the reference model's
    ``flash_chunked``, with 16-row chunks so the online softmax runs over
    several blocks; and the forward's lse against the plain scores'
    logsumexp.  Float32, 1e-5."""
    import jax
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     attention_ref_bwd)
    q, k, v, dout = _bwd_inputs(b, h, hkv, s, d, seed=s + h + d)
    scale = d ** -0.5

    def f(q_, k_, v_):   # (B, H, S, D) layout around the (B, S, H, D) model path
        out = j_flash_chunked(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                              v_.transpose(0, 2, 1, 3), causal=causal,
                              window=window, sm_scale=scale, q_chunk=16,
                              k_chunk=16)
        return out.transpose(0, 2, 1, 3)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk_, tv, tout, tdo = (torch.from_numpy(np.array(x))
                              for x in (q, k, v, out, dout))
    lse = attention_lse_ref(tq, tk_, causal=causal, window=window or None)
    got = attention_ref_bwd(tq, tk_, tv, tout, tdo, lse, causal=causal,
                            window=window or None)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        _close(g_, w_, tol=1e-5)
    scores = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, h // hkv, axis=1)) * scale
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    scores = np.where(keep, scores, -np.inf)
    top = scores.max(-1, keepdims=True)
    want_lse = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True)))[..., 0]
    _close(lse, want_lse, tol=1e-5)


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", BWD_CASES[:4])
def test_attention_ref_bwd_matches_autograd_of_attention_ref(b, h, hkv, s, d,
                                                             causal, window):
    """The same gradients as torch.autograd through ``attention_ref``, the
    path a CPU tensor takes through ``multi_head_attention``."""
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     attention_ref_bwd)
    q, k, v, dout = (torch.from_numpy(x) for x in _bwd_inputs(b, h, hkv, s, d, 3))
    for t in (q, k, v):
        t.requires_grad_()
    out = multi_head_attention(q, k, v, causal=causal, window=window)
    out.backward(torch.from_numpy(dout.numpy()))
    lse = attention_lse_ref(q.detach(), k.detach(), causal=causal,
                            window=window or None)
    got = attention_ref_bwd(q.detach(), k.detach(), v.detach(), out.detach(),
                            dout, lse, causal=causal, window=window or None)
    for g_, t in zip(got, (q, k, v)):
        _close(g_, t.grad.numpy(), tol=1e-5)


# the capped bf16 emulation against the capped float32 vjp (below)
CAP_BWD_EMU_REL = 7e-3
# soft-capped backward cases: grok's G = 6, G = 1, a window, non-causal
CAP_BWD_CASES = [(1, 12, 2, 29, 16, True, 0), (2, 4, 4, 33, 16, True, 0),
                 (1, 6, 1, 40, 16, True, 8), (1, 4, 2, 21, 32, False, 0)]


def _capped_vjp(q, k, v, dout, causal, window):
    """Output and ``jax.vjp`` of the reference model's ``flash_chunked``
    with ``softcap_val=CAP`` on (B, H, S, D) float32 inputs."""
    import jax
    d = q.shape[-1]

    def f(q_, k_, v_):
        out = j_flash_chunked(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                              v_.transpose(0, 2, 1, 3), causal=causal,
                              window=window, sm_scale=d ** -0.5, softcap_val=CAP,
                              q_chunk=16, k_chunk=16)
        return out.transpose(0, 2, 1, 3)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.array(out), [np.array(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", CAP_BWD_CASES)
def test_capped_attention_ref_bwd_matches_the_vjp_of_flash_chunked(b, h, hkv, s, d,
                                                                    causal, window):
    """``attention_ref_bwd(softcap=30)`` (P from the capped scores' lse,
    dS through c' = 1 - tanh^2) against ``jax.vjp`` of the reference
    model's soft-capped ``flash_chunked``, on scores that reach the cap
    (q 8x a standard normal), float32 within 1e-5 of the largest gradient
    entry (the gradients reach ~9 with q that large, and float32 roundings
    scale with them); the cap changes the gradients."""
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     attention_ref_bwd)
    q, k, v, dout = _bwd_inputs(b, h, hkv, s, d, seed=s + h + d)
    q = q * CAP_Q
    out, want = _capped_vjp(q, k, v, dout, causal, window)
    tq, tk_, tv, tout, tdo = (torch.from_numpy(np.array(x))
                              for x in (q, k, v, out, dout))
    args = dict(causal=causal, window=window or None, softcap=CAP)
    lse = attention_lse_ref(tq, tk_, **args)
    got = attention_ref_bwd(tq, tk_, tv, tout, tdo, lse, **args)
    uncapped = attention_ref_bwd(tq, tk_, tv, tout, tdo, lse, causal=causal,
                                 window=window or None)
    for g_, w_ in zip(got, want):
        _close(g_, w_, tol=1e-5 * max(1.0, float(np.abs(w_).max())))
    assert float((uncapped[0] - got[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", CAP_BWD_CASES)
def test_capped_bf16_bwd_emulation_matches_the_vjp_of_flash_chunked(
        b, h, hkv, s, d, causal, window):
    """The capped bf16 emulation ((P c') and dS rounded as the kernels
    round them) against the capped float32 vjp on the same bf16 values,
    each gradient rounded to bf16, within ``CAP_BWD_EMU_REL``: q 8x a
    standard normal makes the rows' softmax sharp, so a few large P and dS
    entries carry each gradient and their roundings weigh more; measured
    worst 5.4e-3 over CAP_BWD_CASES, still under the card's 1e-2 gate."""
    from repro_torch.kernels.flash_attention import (attention_bwd_bf16_ref,
                                                     attention_lse_ref)
    q, k, v, dout = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in _bwd_inputs(b, h, hkv, s, d, seed=s + h + d))
    q = (q.float() * CAP_Q).to(torch.bfloat16)
    out, want = _capped_vjp(*(t.float().numpy() for t in (q, k, v, dout)),
                            causal, window)
    out = torch.from_numpy(out).to(torch.bfloat16)
    args = dict(causal=causal, window=window or None, softcap=CAP)
    lse = attention_lse_ref(q.float(), k.float(), **args)
    got = attention_bwd_bf16_ref(q, k, v, out, dout, lse, **args)
    for g_, w_ in zip(got, want):
        w_ = torch.from_numpy(w_)
        rel = float((g_.to(torch.bfloat16).float() - w_).norm() / w_.norm())
        assert rel <= CAP_BWD_EMU_REL


def test_model_attention_is_differentiable_on_the_cpu():
    """The full-sequence path of the model's attention layer (no cache)
    takes the plain ``flash_chunked`` on the CPU and autograd runs through
    it, with no kernel launch counted."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models.attention import attention, init_attention
    cfg = reduced_config(get_config("gemma3-4b"))
    p = init_attention(torch.Generator().manual_seed(0), cfg, torch.float32)
    for t in p.values():
        t.requires_grad_()
    x = torch.randn(2, 12, cfg.d_model, requires_grad=True)
    tk.reset_launch_counts()
    out, cache = attention(p, x, cfg, window=cfg.window)
    out.square().sum().backward()
    assert cache is None and x.grad is not None
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in p.values())
    assert not any(tk.launch_counts().values())


@pytest.mark.parametrize("fn", ["forward", "backward"])
def test_the_kernel_wrappers_refuse_cpu_tensors(fn):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if fn == "forward":
            flash_attention(q, q, q, return_lse=True)
        else:
            flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 2, 8))


# ---------------------------------------------------------------------------
# K6's backward on the card in bf16: the emulation of its arithmetic and its
# split plan
# ---------------------------------------------------------------------------

# rel L2 of each bf16 gradient of the emulation against the float32 vjp of
# the reference on the same bf16 values; measured worst case over BWD_CASES
# 2.96e-3 (dk at B=2 H=8 Hkv=1 S=29), so the limit is half the card's 1e-2
BWD_EMU_REL = 5e-3


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", BWD_CASES)
def test_bf16_bwd_emulation_matches_the_vjp_of_flash_chunked(b, h, hkv, s, d,
                                                             causal, window):
    """``attention_bwd_bf16_ref`` (P and dS rounded once to bf16 before
    their products, fp32 sums, the group's dK and dV summed in split order)
    on bf16 q, k, v, dout and the bf16 output against ``jax.vjp`` of the
    reference's ``flash_chunked`` in float32 on the same values, each
    gradient rounded to bf16 as the kernels store it.  One rounding of P or
    dS moves an element by at most 2^-9 relative and the store by another
    2^-9; the measured worst rel L2 is 2.96e-3, under BWD_EMU_REL = 5e-3
    and well under the card's 1e-2 gate."""
    import jax
    from repro_torch.kernels.flash_attention import (attention_bwd_bf16_ref,
                                                     attention_lse_ref)
    q, k, v, dout = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in _bwd_inputs(b, h, hkv, s, d, seed=s + h + d))
    scale = d ** -0.5

    def f(q_, k_, v_):
        out = j_flash_chunked(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                              v_.transpose(0, 2, 1, 3), causal=causal,
                              window=window, sm_scale=scale, q_chunk=16,
                              k_chunk=16)
        return out.transpose(0, 2, 1, 3)

    out, vjp = jax.vjp(f, *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(dout.float().numpy()))
    out = torch.from_numpy(np.array(out)).to(torch.bfloat16)
    args = dict(causal=causal, window=window or None)
    lse = attention_lse_ref(q.float(), k.float(), **args)
    got = attention_bwd_bf16_ref(q, k, v, out, dout, lse, **args)
    for g_, w_, t in zip(got, want, (q, k, v)):
        assert g_.dtype == torch.float32 and g_.shape == t.shape
        w_ = torch.from_numpy(np.array(w_))
        rel = float((g_.to(torch.bfloat16).float() - w_).norm() / w_.norm())
        assert rel <= BWD_EMU_REL


def test_bf16_bwd_emulation_rounds_p_and_ds():
    """The emulation is not the float32 textbook backward: rounding P and
    dS to bf16 moves each gradient, by well under the limit."""
    from repro_torch.kernels.flash_attention import (attention_bwd_bf16_ref,
                                                     attention_lse_ref,
                                                     attention_ref_bwd)
    q, k, v, dout = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in _bwd_inputs(1, 8, 1, 64, 16, seed=5))
    out = attention_ref(q.float(), k.float(), v.float()).to(torch.bfloat16)
    lse = attention_lse_ref(q.float(), k.float())
    got = attention_bwd_bf16_ref(q, k, v, out, dout, lse)
    plain = attention_ref_bwd(q, k, v, out, dout, lse)
    for g_, p_ in zip(got, plain):
        rel = float((g_ - p_).norm() / p_.norm())
        assert 1e-4 < rel < BWD_EMU_REL


SMEM_PER_BLOCK = 232_448   # the H100's dynamic shared memory limit per block

# (B, H, Hkv, S, D, window): gemma-2b's and gemma3-4b's training layers, the
# card tests' shapes, and small grids where one head per block is forced
PLAN_CASES = [
    (4, 8, 1, 1024, 256, 0), (2, 8, 4, 2048, 256, 1024), (2, 8, 4, 1000, 256, 1024),
    (2, 8, 1, 200, 256, 0), (1, 8, 4, 130, 256, 50), (2, 4, 2, 64, 16, 8),
    (1, 4, 4, 97, 64, 0), (1, 2, 1, 1, 128, 0), (16, 8, 1, 4096, 256, 0),
    (8, 16, 2, 2048, 128, 0), (1, 8, 8, 8192, 256, 0), (3, 12, 4, 777, 96, 300),
]


@pytest.mark.parametrize("b,h,hkv,s,d,window", PLAN_CASES)
def test_bwd_plan_covers_every_k_tile_and_head_once(b, h, hkv, s, d, window):
    """The mirror of the CUDA plan: a function of the shape alone (the same
    plan from any call and any window), every (k tile, b, query head)
    covered by exactly one dK/dV block, the group split over whole blocks,
    the shared memory of both kernels within the card's per-block limit,
    and the scratch large enough for delta and the partials."""
    from collections import Counter
    from repro_torch.kernels.flash_attention import bwd_dkdv_blocks, bwd_plan
    plan = bwd_plan(b, h, hkv, s, d, window)
    assert plan == bwd_plan(b, h, hkv, s, d, window) == bwd_plan(b, h, hkv, s, d, 0)
    group = h // hkv
    assert plan.n_split * plan.heads_per_block == group
    assert plan.kd >= d and plan.kd in (64, 128, 256)
    blocks = list(bwd_dkdv_blocks(plan, b, h, hkv))
    assert len(blocks) == plan.dkdv_blocks
    cover = Counter((kt, bb, head) for kt, bb, heads in blocks for head in heads)
    want = {(kt, bb, head) for kt in range(-(-s // 64)) for bb in range(b)
            for head in range(h)}
    assert set(cover) == want and set(cover.values()) == {1}
    for kt, bb, heads in blocks:   # one block's heads share one KV head
        assert len({head // group for head in heads}) == 1
    assert max(plan.dkdv_smem, plan.dq_smem) <= SMEM_PER_BLOCK
    assert plan.dq_blocks == plan.n_kt * h * b
    assert plan.scratch_floats >= b * h * s + (
        2 * group * b * hkv * s * d if plan.n_split > 1 else 0) // plan.heads_per_block


@pytest.mark.parametrize("b,h,hkv,s,sk,d", [
    (16, 8, 8, 448, 1500, 64),    # whisper's cross-attention in training
    (1, 8, 2, 130, 65, 64),       # G = 4, fewer keys, split over blocks
    (2, 8, 1, 40, 300, 16)])      # G = 8, more keys
def test_bwd_plan_at_other_keys(b, h, hkv, s, sk, d):
    """At Sk != S the dK/dV blocks (and the partials) follow the Sk key
    rows, every (k tile, b, head) once, and the dQ blocks the S query
    rows; the plan of self-attention is the plan with ``sk=s``."""
    from collections import Counter
    from repro_torch.kernels.flash_attention import bwd_dkdv_blocks, bwd_plan
    plan = bwd_plan(b, h, hkv, s, d, sk=sk)
    assert bwd_plan(b, h, hkv, s, d) == bwd_plan(b, h, hkv, s, d, sk=s)
    assert plan.n_kt == -(-sk // 64) and plan.dq_blocks == -(-s // 64) * h * b
    cover = Counter((kt, bb, head) for kt, bb, heads in bwd_dkdv_blocks(plan, b, h, hkv)
                    for head in heads)
    assert set(cover) == {(kt, bb, head) for kt in range(-(-sk // 64))
                          for bb in range(b) for head in range(h)}
    assert set(cover.values()) == {1}
    part = plan.n_split * b * hkv * sk * d if plan.n_split > 1 else 0
    assert plan.scratch_floats == -(-(b * h * s) // 64) * 64 + 2 * part
    if (b, s, sk) == (16, 448, 1500):   # 24 k tiles x 8 heads x 16: no split
        assert (plan.n_split, plan.dkdv_blocks, plan.dq_blocks) == (1, 3072, 896)


def test_bwd_plan_fills_the_card_at_mqa():
    """gemma-2b's training layer (MQA, 64 k-tile blocks unsplit) splits its
    group in four, two heads per block (256 blocks); gemma3-4b's (G = 2)
    keeps its group whole, as G = 1 does: no reduction; a small grid splits
    one head per block; a large grid keeps whole groups in one block."""
    from repro_torch.kernels.flash_attention import bwd_plan
    gemma = bwd_plan(4, 8, 1, 1024, 256)
    assert (gemma.heads_per_block, gemma.n_split, gemma.dkdv_blocks) == (2, 4, 256)
    assert gemma.scratch_floats == 4 * 8 * 1024 + 2 * 4 * 4 * 1024 * 256
    assert bwd_plan(2, 8, 4, 2048, 256, 1024).n_split == 1
    assert bwd_plan(4, 8, 8, 1024, 256).n_split == 1
    assert bwd_plan(1, 8, 1, 1024, 256).heads_per_block == 1
    assert bwd_plan(16, 8, 1, 4096, 256).heads_per_block == 8
    assert bwd_plan(4, 8, 1, 1024, 256, heads_per_block=2).n_split == 4


# K6's float32 kernels (the forward, flash_attention_bwd_ds_kernel and
# flash_attention_bwd_grad_kernel), mirrored by f32_plan: (B, H, Hkv, S, Sk,
# causal, window) over causal and not, windows, keys that are not the
# queries (448 over 1,500), ragged S (150) and G = 1, 2, 5, 8; each at every
# head size of F32_PLAN_DS (96 rounds up to the 128 instance)
F32_PLAN_SHAPES = [
    (1, 1, 1, 150, None, True, 0),      # G = 1, ragged
    (2, 2, 1, 150, None, True, 0),      # G = 2, two batches
    (1, 5, 1, 300, None, True, 64),     # G = 5, a window
    (1, 8, 1, 200, None, False, 0),     # G = 8, non-causal
    (1, 8, 4, 150, None, True, 50),     # G = 2, a window inside a k tile
    (1, 2, 2, 448, 1500, False, 0),     # keys that are not the queries, G = 1
    (1, 8, 1, 448, 1500, False, 0),     # the same at G = 8
    (2, 5, 1, 130, None, False, 40),    # a window without causal, G = 5
    (1, 2, 1, 1, None, True, 0),        # one row
    (1, 2, 1, 2048, None, True, 0),     # the timed layer's length
]
F32_PLAN_DS = [16, 64, 96, 128, 256]
SM_SMEM = 233_472          # an H100 SM's shared memory for its blocks
BLOCK_RESERVED = 1_024     # what the card keeps back per block


def _keep(s, sk, causal, window):
    i, j = np.arange(s)[:, None], np.arange(sk)[None, :]
    keep = np.ones((s, sk), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    return keep


@pytest.mark.parametrize("d", F32_PLAN_DS)
@pytest.mark.parametrize("b,h,hkv,s,sk,causal,window", F32_PLAN_SHAPES)
def test_f32_plan_covers_every_kept_pair_once(b, h, hkv, s, sk, causal, window, d):
    """The mirror of the float32 kernels' plan: every kept (i, j) pair of
    every (b, head) is covered exactly once by the forward's blocks, by the
    backward's P/dS blocks, by its dK/dV blocks and by its dQ blocks; the
    scratch holds one P and one dS tile for each kept 64 x 64 tile, and no
    other; causal blocks run heaviest first within each kernel and kind
    (q tiles run last first, so with a window a ragged last q tile, whose
    window is cut short, may lead with fewer k tiles than the next);
    shared memory fits the card (two blocks an SM where D <= 128); the plan
    is a function of the shape alone."""
    from repro_torch.kernels.flash_attention import (f32_ds_blocks, f32_fwd_blocks,
                                                     f32_grad_blocks, f32_plan,
                                                     f32_tile_index)
    plan = f32_plan(b, h, hkv, s, d, window, sk=sk, causal=causal)
    assert plan == f32_plan(b, h, hkv, s, d, window, sk=sk, causal=causal)
    if sk is None:
        assert plan == f32_plan(b, h, hkv, s, d, window, sk=s, causal=causal)
    sk = plan.sk
    assert plan.kd >= d and plan.kd in (16, 32, 64, 128, 256) and plan.kd // 2 < max(d, 9)
    keep = _keep(s, sk, causal, window)
    group = h // hkv

    def covered(blocks_of_pairs):
        cover = np.zeros((b, h, s, sk), np.int32)
        for bb, head, rows, cols in blocks_of_pairs:
            cover[bb, head, rows.start:min(rows.stop, s), cols.start:min(cols.stop, sk)] += 1
        return cover[:, :, keep]

    tile = lambda t, n=64: range(t * n, (t + 1) * n)   # noqa: E731
    fwd = list(f32_fwd_blocks(plan))
    assert len(fwd) == plan.fwd_blocks
    assert (covered((bb, head, tile(qt), range(kts.start * plan.fwd_bk,
                                               kts.stop * plan.fwd_bk))
                    for bb, head, qt, kts in fwd) == 1).all()
    ds = list(f32_ds_blocks(plan))
    assert len(ds) == plan.ds_blocks
    assert (covered((bb, head, tile(qt), tile(kt)) for bb, head, qt, kts in ds
                    for kt in kts) == 1).all()
    index = [f32_tile_index(plan, bb, head, qt, kt) for bb, head, qt, kts in ds
             for kt in kts]
    assert sorted(index) == list(range(b * h * plan.tiles_per_head))
    assert plan.scratch_floats == 2 * 64 * 64 * len(index)
    # only tiles that keep a pair: the count from the mask itself
    kept_tiles = sum(keep[i:i + 64, j:j + 64].any() for i in range(0, s, 64)
                     for j in range(0, sk, 64))
    assert plan.tiles_per_head == kept_tiles
    grad = list(f32_grad_blocks(plan))
    dkdv = [blk[1:] for blk in grad if blk[0] == "dkdv"]
    dq = [blk[1:] for blk in grad if blk[0] == "dq"]
    assert (len(dkdv), len(dq)) == (plan.dkdv_blocks, plan.dq_blocks)
    assert len({(kt, hk, bb) for kt, hk, bb, _ in dkdv}) == len(dkdv)
    for kt, hk, bb, pairs in dkdv:   # a block sums its whole group, in order
        assert [head for head, _ in pairs] == sorted(head for head, _ in pairs)
        assert {head // group for head, _ in pairs} <= {hk}
        assert len({head for head, _ in pairs}) == group
    assert (covered((bb, head, tile(qt), tile(kt)) for kt, hk, bb, pairs in dkdv
                    for head, qt in pairs) == 1).all()
    assert (covered((bb, head, tile(qt), tile(kt)) for qt, head, bb, kts in dq
                    for kt in kts) == 1).all()
    if causal:   # heaviest first, by the tiles each block runs
        ragged = b * h if window and s % 64 else 0
        for work in ([len(kts) for *_, kts in fwd][ragged:],
                     [len(kts) for *_, kts in ds][ragged:],
                     [len(pairs) for *_, pairs in dkdv],
                     [len(kts) for *_, kts in dq][ragged:]):
            assert work == sorted(work, reverse=True)
    for smem in (plan.fwd_smem, plan.ds_smem, plan.grad_smem):
        assert smem <= SMEM_PER_BLOCK
        assert plan.kd > 128 or 2 * (smem + BLOCK_RESERVED) <= SM_SMEM
    assert (plan.fwd_launches, plan.bwd_launches) == (1, 2)


def test_f32_plan_tiles_at_the_timed_shapes():
    """The tiles of the H100 rows: at (2, 8, 4, 2,048, 256) one forward block
    of 128 threads per SM (213 KB: the resident Q and one K and one V tile of
    64 rows), 528 kept tiles a head (277 MB of scratch), 256 dK/dV and 512
    dQ blocks; at the reduced rank's (2, 2, 2, 64, 16) one warp a forward
    block over 16-key tiles, and one kept tile a head."""
    from repro_torch.kernels.flash_attention import f32_plan
    big = f32_plan(2, 8, 4, 2048, 256)
    assert (big.kd, big.fwd_threads, big.fwd_bk, big.fwd_slots) == (256, 128, 64, 2)
    assert big.fwd_smem == 212_992 and big.tiles_per_head == 32 * 33 // 2
    assert big.scratch_floats * 4 == 276_824_064
    assert (big.dkdv_blocks, big.dq_blocks, big.grad_threads) == (256, 512, 256)
    tiny = f32_plan(2, 2, 2, 64, 16)
    assert (tiny.kd, tiny.fwd_threads, tiny.fwd_bk, tiny.fwd_slots) == (16, 32, 16, 4)
    assert (tiny.tiles_per_head, tiny.dkdv_blocks, tiny.dq_blocks) == (1, 4, 4)
    assert f32_plan(1, 32, 32, 1024, 96).kd == 128
    assert f32_plan(1, 4, 4, 64, 8).kd == 16


def _emulate_f32_bwd(plan, q, k, v, out, dout, lse, cap):
    """The float32 backward's arithmetic, block by block as its plan runs
    it: the P/dS blocks fill the scratch tiles (each written once, every
    one written), then the dK/dV and dQ blocks read them."""
    t, group = 64, plan.h // plan.hkv
    scale = plan.d ** -0.5
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))  # noqa: E731
    sp, skp = -(-plan.s // t) * t, -(-plan.sk // t) * t
    qp, dop, outp = pad(q, sp), pad(dout, sp), pad(out, sp)
    kp, vp = pad(k, skp), pad(v, skp)
    lsep = torch.nn.functional.pad(lse, (0, sp - plan.s), value=float("inf"))
    delta = (dop * outp).sum(-1)
    keep = torch.from_numpy(_keep(plan.s, plan.sk, plan.causal, plan.window))
    keep = torch.nn.functional.pad(keep, (0, skp - plan.sk, 0, sp - plan.s))
    scratch = torch.full((plan.b * plan.h * plan.tiles_per_head, 2, t, t), float("nan"))
    from repro_torch.kernels.flash_attention import (f32_ds_blocks, f32_grad_blocks,
                                                     f32_tile_index)
    for bb, head, qt, kts in f32_ds_blocks(plan):
        rows = slice(qt * t, qt * t + t)
        for kt in kts:
            cols = slice(kt * t, kt * t + t)
            s_ = qp[bb, head, rows] @ kp[bb, head // group, cols].T * scale
            tt = torch.tanh(s_ / cap) if cap else None
            x = cap * tt if cap else s_
            p = torch.where(keep[rows, cols], torch.exp(x - lsep[bb, head, rows, None]), 0.0)
            dp = dop[bb, head, rows] @ vp[bb, head // group, cols].T
            dc = 1 - tt * tt if cap else 1.0
            idx = f32_tile_index(plan, bb, head, qt, kt)
            assert bool(scratch[idx].isnan().all())
            scratch[idx, 0] = p
            scratch[idx, 1] = p * dc * (dp - delta[bb, head, rows, None])
    assert not bool(scratch.isnan().any())
    dq, dk, dv = torch.zeros_like(qp), torch.zeros_like(kp), torch.zeros_like(vp)
    for kind, tile_, head, bb, work in f32_grad_blocks(plan):
        if kind == "dkdv":
            cols = slice(tile_ * t, tile_ * t + t)
            for h_, qt in work:
                rows = slice(qt * t, qt * t + t)
                idx = f32_tile_index(plan, bb, h_, qt, tile_)
                dv[bb, head, cols] += scratch[idx, 0].T @ dop[bb, h_, rows]
                dk[bb, head, cols] += scratch[idx, 1].T @ qp[bb, h_, rows]
        else:
            rows = slice(tile_ * t, tile_ * t + t)
            for kt in work:
                idx = f32_tile_index(plan, bb, head, tile_, kt)
                dq[bb, head, rows] += scratch[idx, 1] @ kp[bb, head // group,
                                                           kt * t:kt * t + t]
    return (dq[:, :, :plan.s] * scale, dk[:, :, :plan.sk] * scale, dv[:, :, :plan.sk])


@pytest.mark.parametrize("b,h,hkv,s,sk,d,causal,window,cap", [
    (1, 4, 2, 150, None, 16, True, 0, 0.0),     # G = 2, ragged: three q tiles
    (1, 5, 1, 130, None, 32, True, 40, 0.0),    # G = 5, a window
    (1, 2, 2, 70, 200, 16, False, 0, 0.0),      # keys that are not the queries
    (1, 6, 1, 70, None, 16, True, 0, CAP),      # grok's cap, G = 6
    (2, 8, 1, 65, None, 16, False, 30, 0.0)])   # G = 8, a window, not causal
def test_f32_plan_emulation_matches_the_vjp_of_flash_chunked(b, h, hkv, s, sk, d,
                                                             causal, window, cap):
    """The float32 backward's arithmetic run through its plan (scratch
    tiles by ``f32_tile_index``, the dK/dV blocks' group sums and the dQ
    blocks' k tiles by ``f32_grad_blocks``) against ``jax.vjp`` of the
    reference model's ``flash_chunked`` on the same numpy inputs, 1e-5."""
    import jax
    from repro_torch.kernels.flash_attention import attention_lse_ref, f32_plan
    sk_ = s if sk is None else sk
    rng = np.random.default_rng(s + h + d)
    q = _normal(rng, (b, h, s, d)) * (CAP_Q if cap else 1.0)
    k, v = _normal(rng, (b, hkv, sk_, d)), _normal(rng, (b, hkv, sk_, d))
    dout = _normal(rng, (b, h, s, d))

    def f(q_, k_, v_):
        o = j_flash_chunked(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                            v_.transpose(0, 2, 1, 3), causal=causal, window=window,
                            sm_scale=d ** -0.5, softcap_val=cap, q_chunk=16, k_chunk=16)
        return o.transpose(0, 2, 1, 3)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk_, tv, tout, tdo = (torch.from_numpy(np.array(x)) for x in (q, k, v, out, dout))
    lse = attention_lse_ref(tq, tk_, causal=causal, window=window or None, softcap=cap)
    plan = f32_plan(b, h, hkv, s, d, window, sk=sk, causal=causal)
    got = _emulate_f32_bwd(plan, tq, tk_, tv, tout, tdo, lse, cap)
    for g_, w_ in zip(got, want):   # capped: 1e-5 of the largest, as above
        _close(g_, w_, tol=1e-5 * (max(1.0, float(np.abs(w_).max())) if cap else 1.0))
