"""whisper-base in the port against the JAX package, on the CPU, at the
reduced config (2 encoder and 4 decoder layers, 16 encoder frames, 4 heads
of 16) in float32: the encoder, the cross K/V, prefill and decode logits,
decode matching prefill, greedy transcription; the loss (its encoder
branch) and every gradient, train steps and the runner with the frames in
the batch; and flash attention over keys that are not the queries
(Sk != S), the cross-attention the decoder runs, forward and backward, in
the port's plain versions against the reference's
``flash_chunked(causal=False)`` and its ``jax.vjp``.

Inputs are made with numpy from a seed and the reference's weights carried
over with ``params_from_numpy``.  Tolerances: 1e-5 absolute on the encoder
output, the cross K/V, logits (float32 sums in another order through a few
layers; the values are below 2 in magnitude), attention outputs and their
gradients; decode-matches-prefill inside the port within the reference
test's 2e-3; the loss, gradients and steps as ``tests/test_torch_training.py``
holds the decoders (loss 1e-5 relative, every gradient leaf 1e-4 absolute,
step losses and gradient norms 1e-4 relative); the bf16 emulation of the
card's backward as ``tests/test_torch_attention.py`` holds it (rel L2 5e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.configs.reduced import reduced_config as j_reduced
from repro.models import Model as JModel
from repro.models import attention as j_attention
from repro.models import init_params as j_init_params
from repro.training import RunnerConfig as JRunnerConfig
from repro.training import TrainingRunner as JTrainingRunner
from repro.training import adamw_init as j_adamw_init
from repro.training import make_train_step as j_make_train_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.kernels.flash_attention import (attention_bwd_bf16_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 attention_ref_bwd,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 multi_head_attention)
from repro_torch.models import Model, init_params, params_from_numpy
from repro_torch.models import attention as t_attention
from repro_torch.models.convert import param_shapes
from repro_torch.training import (RunnerConfig, TrainingRunner, adamw_init,
                                  make_train_step)
from repro_torch.training.train_step import value_and_grad

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


def _flat(tree, prefix=()):
    """{path: numpy} of a port tree or a reference pytree."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {"/".join(prefix): (tree.detach().numpy() if isinstance(tree, torch.Tensor)
                               else np.asarray(tree))}


def _assert_trees_close(got, want, atol):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)


def _batch(cfg, b=2, s=12, seed=0):
    """(port batch, reference batch) of tokens and frame embeddings."""
    toks, frames = _inputs(cfg, b=b, s=s, seed=seed)
    return ({"tokens": torch.from_numpy(toks), "enc_embeds": torch.from_numpy(frames)},
            {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(frames)})


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


@pytest.mark.parametrize("heads,form", [
    ({}, "heads"), (dict(n_heads=5, n_kv_heads=5, d_head=16), "all"),
    (dict(n_heads=4, n_kv_heads=1), "group")])
def test_the_encoder_decoder_builds_on_the_tiny_mesh_in_every_head_form(heads, form):
    """The encoder-decoder trains on the tiny mesh (its encoder and
    cross-attention tensor-parallel; ``tests/test_torch_mesh_training.py``
    holds it against the reference's mesh) in each of the three head forms
    of ``attention.head_split``: ``check_mesh`` takes the reduced whisper
    with its own heads, with 5 heads the model axis does not divide (every
    head on every rank) and with one KV head (each rank's query heads share
    it), and the cross K/V projections are column-split as self-attention's
    are."""
    from repro_torch.launch.mesh import named_mesh_layout
    from repro_torch.models import Model
    from repro_torch.models.attention import head_split
    from repro_torch.models.transformer import check_mesh
    cfg, _, _, _ = _both()
    cfg = dataclasses.replace(cfg, **heads)
    check_mesh(cfg, named_mesh_layout("tiny"))
    assert head_split(cfg, 2) == form
    specs = Model(cfg, mesh=named_mesh_layout("tiny")).specs
    xdec = next(s for s, sp in specs["stages"].items() if "stk_xwk" in sp)
    for name in ("stk_xwq", "stk_xwk", "stk_xwv"):
        assert specs["stages"][xdec][name] == (None, None, "model"), name


# ---------------------------------------------------------------------------
# training: the loss's encoder branch, the steps and the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_loss_and_gradients_match_the_reference(remat):
    """The loss's encoder branch (``encode``, ``cross_kv``, the decoder
    over them) within 1e-5 relative of the reference's and every gradient
    leaf, the encoder's and the cross-attention's included, within 1e-4 of
    ``jax.grad`` (the reference's ``remat="none"``: its modes recompute the
    same operations), under each of the port's ``remat`` modes."""
    cfg, jcfg, params, jp = _both(seed=3)
    batch, jbatch = _batch(cfg, seed=6)
    want_loss, want_g = jax.value_and_grad(JModel(jcfg).loss)(jp, jbatch)
    loss, grads = value_and_grad(lambda p, b_: Model(cfg).loss(p, b_, remat=remat),
                                 params, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _assert_trees_close(grads, want_g, atol=1e-4)
    # the gradient reaches the encoder through the cross-attention
    assert float(grads["enc_pos"].abs().max()) > 0
    assert float(grads["enc_stages"]["e0"]["stk_wq"].abs().max()) > 0


def _tcfg(cls, **kw):
    base = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5,
                remat="none", microbatches=1)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_the_reference(microbatches):
    """Three train steps on batches of tokens and frames (``enc_embeds``
    split with the tokens into microbatches): the port's step against the
    reference's, loss and gradient norm within 1e-4 relative."""
    cfg, jcfg, params, jp = _both(seed=4)
    step = make_train_step(Model(cfg), _tcfg(TrainConfig, microbatches=microbatches))
    jstep = jax.jit(j_make_train_step(JModel(jcfg), _tcfg(JTrainConfig,
                                                          microbatches=microbatches)))
    state, jstate = adamw_init(params), j_adamw_init(jp)
    for i in range(3):
        batch, jbatch = _batch(cfg, b=4, s=10, seed=10 + i)
        params, state, m = step(params, state, batch)
        jp, jstate, jm = jstep(jp, jstate, jbatch)
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) <= 1e-4 * abs(float(jm[key])), key
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_runner_carries_the_frames_and_matches_the_reference(tmp_path):
    """``TrainingRunner`` moves the frames with the tokens to the
    parameters' device, retries a failed step and checkpoints: the same
    losses as the reference's runner (1e-5 relative) on the same batches."""
    cfg, jcfg, params, jp = _both(seed=5)

    def batch_at(i):
        toks, frames = _inputs(cfg, b=2, s=10, seed=20 + i)
        return {"tokens": toks, "enc_embeds": frames}

    failed = []

    def inject(step):
        hit = step == 2 and not failed
        if hit:
            failed.append(step)
        return hit

    runner = TrainingRunner(
        RunnerConfig(str(tmp_path / "torch"), checkpoint_every=2, fail_injector=inject),
        make_train_step(Model(cfg), _tcfg(TrainConfig, total_steps=4)), params,
        adamw_init(params), batch_at)
    jrunner = JTrainingRunner(
        JRunnerConfig(str(tmp_path / "jax"), checkpoint_every=2),
        jax.jit(j_make_train_step(JModel(jcfg), _tcfg(JTrainConfig, total_steps=4))),
        jp, j_adamw_init(jp),
        lambda i: {k: jnp.asarray(v) for k, v in batch_at(i).items()})
    assert runner.run(4) == jrunner.run(4) == 4 and failed == [2]
    assert len(runner.metrics_log) == len(jrunner.metrics_log) == 4
    for m, jm in zip(runner.metrics_log, jrunner.metrics_log):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# K6's backward at Sk != S: the plain versions against the reference's vjp
# ---------------------------------------------------------------------------

def _vjp_over_other_keys(q, k, v, dout):
    """Output and ``jax.vjp`` of the reference's ``flash_chunked``
    (non-causal, 16-row chunks that split both lengths) in the (B, H, S, D)
    layout of the kernels."""
    scale = q.shape[-1] ** -0.5

    def f(q_, k_, v_):
        out = j_attention.flash_chunked(
            q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3), v_.transpose(0, 2, 1, 3),
            causal=False, window=0, sm_scale=scale, q_chunk=16, k_chunk=16)
        return out.transpose(0, 2, 1, 3)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.array(out), [np.array(g) for g in vjp(jnp.asarray(dout))]


def _other_keys_inputs(b, s, sk, h, kv, d):
    rng = np.random.default_rng(s + sk + h)
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, kv, sk, d)).astype(np.float32) for _ in range(2))
    dout = rng.normal(size=(b, h, s, d)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("b,s,sk,h,kv,d", SK_CASES)
def test_plain_backward_over_other_keys_matches_the_vjp(b, s, sk, h, kv, d):
    """``attention_ref_bwd`` at Sk != S, non-causal (G = 1 and G = 4, more
    and fewer keys than queries), against ``jax.vjp`` of the reference's
    ``flash_chunked``: dq (B, H, S, D), dk and dv (B, Hkv, Sk, D) summed
    over each group, within 1e-5; and the same gradients as autograd
    through ``multi_head_attention``, the path a CPU tensor takes."""
    q, k, v, dout = _other_keys_inputs(b, s, sk, h, kv, d)
    out, want = _vjp_over_other_keys(q, k, v, dout)
    tq, tk, tv, tout, tdo = (torch.from_numpy(x) for x in (q, k, v, out, dout))
    lse = attention_lse_ref(tq, tk, causal=False)
    got = attention_ref_bwd(tq, tk, tv, tout, tdo, lse, causal=False)
    for g_, w_, t in zip(got, want, (tq, tk, tv)):
        assert g_.dtype == torch.float32 and g_.shape == t.shape
        _close(g_, w_)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    multi_head_attention(*leaves, causal=False).backward(tdo)
    for g_, t in zip(got, leaves):
        _close(g_, t.grad.numpy())


@pytest.mark.parametrize("b,s,sk,h,kv,d", SK_CASES)
def test_bf16_backward_emulation_over_other_keys_matches_the_vjp(b, s, sk, h, kv, d):
    """``attention_bwd_bf16_ref`` (the card's bf16 arithmetic: P and dS
    rounded once) at Sk != S on bf16 values against the float32 ``jax.vjp``
    on the same values, each gradient rounded to bf16 as the kernels store
    it: rel L2 within 5e-3, as for self-attention."""
    q, k, v, dout = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in _other_keys_inputs(b, s, sk, h, kv, d))
    out, want = _vjp_over_other_keys(*(t.float().numpy() for t in (q, k, v, dout)))
    out = torch.from_numpy(out).to(torch.bfloat16)
    lse = attention_lse_ref(q.float(), k.float(), causal=False)
    got = attention_bwd_bf16_ref(q, k, v, out, dout, lse, causal=False)
    for g_, w_, t in zip(got, want, (q, k, v)):
        assert g_.shape == t.shape
        w_ = torch.from_numpy(w_)
        assert float((g_.to(torch.bfloat16).float() - w_).norm() / w_.norm()) <= 5e-3


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8), (True, 8)])
def test_flash_backward_refuses_other_keys_with_a_mask(causal, window):
    """The backward takes Sk != S under the forward's rule: a causal mask or
    a window at Sk != S is refused by name before any card is looked
    for."""
    q = torch.zeros((1, 2, 4, 64))
    k = torch.zeros((1, 2, 9, 64))
    with pytest.raises(ValueError, match="keys that are not the queries"):
        flash_attention_bwd(q, k, k, q, q, torch.zeros((1, 2, 4)), causal=causal,
                            window=window)
