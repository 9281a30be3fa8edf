"""whisper-base in the port against the JAX package, on the CPU, at the
reduced config (2 encoder and 4 decoder layers, 16 encoder frames, 4 heads
of 16) in float32: the encoder, the cross K/V, prefill and decode logits,
decode matching prefill, greedy transcription; and flash attention over
keys that are not the queries (Sk != S), the cross-attention the decoder
runs, in the port's plain versions against the reference's
``flash_chunked(causal=False)``.

Inputs are made with numpy from a seed and the reference's weights carried
over with ``params_from_numpy``.  Tolerances: 1e-5 absolute on the encoder
output, the cross K/V, logits (float32 sums in another order through a few
layers; the values are below 2 in magnitude) and attention outputs;
decode-matches-prefill inside the port within the reference test's 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduced import reduced_config as j_reduced
from repro.models import Model as JModel
from repro.models import attention as j_attention
from repro.models import init_params as j_init_params
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                 multi_head_attention)
from repro_torch.models import Model, init_params, params_from_numpy
from repro_torch.models import attention as t_attention
from repro_torch.models.convert import param_shapes

ARCH = "whisper-base"
TOL = 1e-5


def _both(seed=1):
    jcfg = j_reduced(j_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu"), jp


def _inputs(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = (rng.normal(size=(b, cfg.encoder_len, cfg.d_model)) * 0.05).astype(np.float32)
    return toks, frames


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


def test_config_and_tree_equal_the_reference():
    """The config, its layer pattern (all ``xdec``), and the parameter tree
    (the encoder stage ``e0``, ``enc_final_norm``, ``enc_pos``, each
    decoder layer's ``normx`` and ``xw*``) key for key and shape for shape,
    from the port's own init and from ``param_shapes``."""
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(j_get_config(ARCH))
    cfg, jcfg, _, jp = _both()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_pattern() == jcfg.layer_pattern() == ["xdec"] * cfg.n_layers
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
    assert jax.tree.map(tuple, param_shapes(cfg),
                        is_leaf=lambda x: isinstance(x, tuple)) == shapes
    assert {"stk_normx_scale", "stk_normx_bias", "stk_xwq", "stk_xwo"} <= \
        set(mine["stages"]["s0"])


def test_encode_and_cross_kv_match_the_reference():
    cfg, jcfg, params, jp = _both()
    _, frames = _inputs(cfg)
    jm, m = JModel(jcfg), Model(cfg)
    jenc = jm.encode(jp, jnp.asarray(frames))
    enc = m.encode(params, torch.from_numpy(frames))
    _close(enc, jenc)
    jx, x = jm.cross_kv(jp, jenc), m.cross_kv(params, enc)
    assert sorted(x) == sorted(jx) == ["s0"]
    for got, want in zip(x["s0"], jx["s0"]):
        assert tuple(got.shape) == want.shape == (
            cfg.n_layers, 2, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
        _close(got, want)


def test_prefill_and_decode_logits_match_the_reference():
    """Prefill logits within 1e-5 of the reference's (the port's prefill
    with ``enc_embeds``, as the reference's, and with the precomputed
    cross K/V, which give the same bits); then a prefill of one token and
    11 decode steps over the same cross K/V, each step's logits within
    1e-5 of the reference's and the last within 2e-3 of the whole
    prefill's."""
    cfg, jcfg, params, jp = _both()
    toks, frames = _inputs(cfg)
    jm, m = JModel(jcfg), Model(cfg)
    jbatch = {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(frames)}
    want, _ = jm.prefill(jp, jbatch, 16)
    jx = jm.cross_kv(jp, jm.encode(jp, jbatch["enc_embeds"]))
    with torch.inference_mode():
        full, _ = m.prefill(params, {"tokens": torch.from_numpy(toks),
                                     "enc_embeds": torch.from_numpy(frames)}, 16)
        enc = m.cross_kv(params, m.encode(params, torch.from_numpy(frames)))
        again, _ = m.prefill(params, {"tokens": torch.from_numpy(toks)}, 16,
                             enc_out=enc)
        _close(full, want)
        assert torch.equal(full, again)
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(toks[:, :1])},
                                  16, enc_out=enc)
        jl, jc = jm.prefill(jp, {**jbatch, "tokens": jbatch["tokens"][:, :1]}, 16)
        _close(logits, jl)
        for t in range(1, toks.shape[1]):
            pos = torch.full((2,), t, dtype=torch.int32)
            logits, cache = m.decode_step(params, torch.from_numpy(toks[:, t:t + 1]),
                                          cache, pos, enc_out=enc)
            jl, jc = jm.decode_step(jp, jbatch["tokens"][:, t:t + 1], jc,
                                    jnp.full((2,), t, jnp.int32), enc_out=jx)
            _close(logits, jl)
    assert float((logits - full).abs().max()) < 2e-3


def test_decode_matches_prefill_in_the_port():
    """As ``tests/test_decode_consistency.py`` holds the reference: a
    prefill of the first token then decode steps reproduce the whole
    prefill's last logits within 2e-3, the cross K/V made once."""
    cfg = reduced_config(get_config(ARCH))
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks, frames = _inputs(cfg, seed=4)
    m = Model(cfg)
    with torch.inference_mode():
        enc = m.cross_kv(params, m.encode(params, torch.from_numpy(frames)))
        full, _ = m.prefill(params, {"tokens": torch.from_numpy(toks)}, 16, enc_out=enc)
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(toks[:, :1])},
                                  16, enc_out=enc)
        for t in range(1, toks.shape[1]):
            logits, cache = m.decode_step(params, torch.from_numpy(toks[:, t:t + 1]),
                                          cache, torch.full((2,), t, dtype=torch.int32),
                                          enc_out=enc)
    assert float((logits - full).abs().max()) < 2e-3


def test_transcribe_matches_a_greedy_loop_of_the_reference():
    """``launch.serve_profile.transcribe`` (encode and cross K/V once, the
    prompt's prefill, greedy decode steps) gives the reference's greedy
    tokens, token for token."""
    from repro_torch.launch.serve_profile import transcribe
    cfg, jcfg, params, jp = _both(seed=2)
    toks, frames = _inputs(cfg, b=3, s=4, seed=5)
    got, stats = transcribe(Model(cfg), params, torch.from_numpy(frames),
                            torch.from_numpy(toks).long(), 8, 12)
    assert got.shape == (3, 8) and got.dtype == np.int32
    assert stats["decode_steps"] == 7
    jm = JModel(jcfg)
    jx = jm.cross_kv(jp, jm.encode(jp, jnp.asarray(frames)))
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                    "enc_embeds": jnp.asarray(frames)}, 12)
    want = [np.asarray(logits[:, -1].argmax(-1))]
    for t in range(1, 8):
        logits, cache = jm.decode_step(jp, jnp.asarray(want[-1])[:, None], cache,
                                       jnp.full((3,), 4 + t - 1, jnp.int32), enc_out=jx)
        want.append(np.asarray(logits[:, -1].argmax(-1)))
    np.testing.assert_array_equal(got, np.stack(want, 1))


def test_the_serving_engine_refuses_an_encoder_decoder():
    """``ServingEngine`` takes token prompts only, as the reference's does
    (whose prefill would fail on the missing ``enc_embeds``): it refuses
    whisper by name and points at ``transcribe``."""
    from repro_torch.serving import ServingEngine
    cfg, _, params, _ = _both()
    with pytest.raises(ValueError, match="transcribe"):
        ServingEngine(Model(cfg), params, s_max=16)


@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_layer_matches_the_reference(s):
    """One decoder layer's cross-attention: q from the ``x`` weights with no
    rope, over the encoder's K/V: a prompt (S = 5) through the plain
    flash path non-causally, a decode step (S = 1) through the plain
    decode path over every row."""
    cfg, jcfg, params, jp = _both()
    lp = {k[4:]: v[0] for k, v in params["stages"]["s0"].items()}
    jlp = {k[4:]: v[0] for k, v in jp["stages"]["s0"].items()}
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(2, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    want, _ = j_attention.attention(jlp, jnp.asarray(x), jcfg,
                                    cross_kv=(jnp.asarray(k), jnp.asarray(v)),
                                    prefix="x")
    got, none = t_attention.attention(lp, torch.from_numpy(x), cfg,
                                      cross_kv=(torch.from_numpy(k), torch.from_numpy(v)),
                                      prefix="x")
    assert none is None
    _close(got, want)


# (B, S, Sk, H, KV, D): whisper's cross-attention at G = 1, a group of 4,
# fewer keys than queries, one query row
SK_CASES = [(2, 5, 37, 4, 4, 16), (1, 70, 150, 8, 2, 64), (2, 40, 9, 4, 1, 16),
            (1, 1, 300, 4, 4, 96)]


@pytest.mark.parametrize("b,s,sk,h,kv,d", SK_CASES)
def test_plain_attention_over_other_keys_matches_the_reference(b, s, sk, h, kv, d):
    """K6's plain versions at Sk != S, non-causal, against the reference's
    ``flash_chunked(causal=False)``: ``ref.attention_ref`` (the kernel's
    oracle, (B, H, S, D) layout) and the port's ``flash_chunked``, also
    with chunks that split both lengths."""
    rng = np.random.default_rng(s + sk)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, kv, d)).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    want = np.asarray(j_attention.flash_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False, window=0,
        sm_scale=scale))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    oracle = attention_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                           causal=False)
    _close(oracle.transpose(1, 2), want)
    via_ops = multi_head_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                   tv.transpose(1, 2), causal=False)
    _close(via_ops.transpose(1, 2), want)
    for chunk in (1024, 16):
        got = t_attention.flash_chunked(tq, tk, tv, causal=False, window=0,
                                        sm_scale=scale, q_chunk=chunk, k_chunk=chunk)
        _close(got, want)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8), (True, 8)])
def test_flash_kernel_refuses_other_keys_with_a_mask(causal, window):
    """Sk != S takes neither a causal mask nor a window: the wrapper refuses
    the call by name before it looks for a card."""
    q = torch.zeros((1, 2, 4, 64))
    k = torch.zeros((1, 2, 9, 64))
    with pytest.raises(ValueError, match="keys that are not the queries"):
        flash_attention(q, k, k, causal=causal, window=window)


def test_the_encoder_loss_raises_and_the_encoder_on_a_mesh_raises():
    """whisper's training (the loss's encoder branch) is not ported, nor the
    encoder-decoder on a mesh: both raise, naming ROADMAP item 12f."""
    from repro_torch.launch.mesh import named_mesh_layout
    from repro_torch.models.transformer import check_mesh
    cfg, _, params, _ = _both()
    toks, frames = _inputs(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12f"):
        Model(cfg).loss(params, {"tokens": torch.from_numpy(toks),
                                 "enc_embeds": torch.from_numpy(frames)})
    with pytest.raises(NotImplementedError, match="ROADMAP item 12f"):
        check_mesh(cfg, named_mesh_layout("tiny"))
