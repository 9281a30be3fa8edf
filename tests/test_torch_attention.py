"""Attention kernels of the port (K6 flash attention, K7 grouped decode
attention) against the JAX package, on the CPU.

The port's plain versions (``ref.py``, which the CUDA kernels are held to on
the card) and the model's plain paths (``flash_chunked``,
``_decode_attend``) take the same numpy inputs as the reference's Pallas
kernels (run in interpret mode, as the reference's own tests run them),
its oracles and its model paths.  Everything is float32; the tolerance,
2e-5 absolute on outputs of magnitude below 4, covers sums taken in another
order by two frameworks.
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
                                                  grouped_decode_attention)
from repro_torch.kernels.flash_attention import (attention_ref,
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
@pytest.mark.parametrize("kv,g", [(4, 1), (2, 2), (1, 8)])
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
