"""The port's selective SSM (``models/ssm.py``) and the hymba-1.5b model
(attention beside the SSM in every layer) against the JAX package, on the
CPU, float32.

Inputs are made with numpy from a seed, and the reference's weights are
carried over with ``params_from_numpy``, so both packages run on the same
numbers.  Tolerances, each with its reason: a block's output and state
within 1e-5 absolute (float32 sums in another order: the port's in-chunk
scan is a log-step scan, the reference's ``associative_scan`` another
tree); logits within 1e-4 (the same through a few layers); decode against
prefill inside the port within the reference test's 2e-3; the loss within
1e-5 relative and every gradient leaf within 1e-4 absolute, as
``tests/test_torch_training.py`` holds the dense decoders.  ``CHUNK`` is
cut in both packages where a case must cross SSM chunk boundaries, to a
size that does not divide the sequence (the reference pads the last chunk,
the port runs it short).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as jssm
from repro.configs import get_config as j_get_config
from repro.configs.reduced import reduced_config as j_reduced
from repro.models import Model as JModel
from repro.models import init_params as j_init_params
from repro.models import transformer as j_transformer
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
import repro_torch.models.ssm as tssm
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import Model, init_params, params_from_numpy
from repro_torch.models import transformer as t_transformer
from repro_torch.models.convert import param_shapes
from repro_torch.serving import Request, ServingEngine
from repro_torch.training.train_step import value_and_grad

ARCH = "hymba-1.5b"


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def _cfgs(**changes):
    return (dataclasses.replace(reduced_config(get_config(ARCH)), **changes),
            dataclasses.replace(j_reduced(j_get_config(ARCH)), **changes))


def _both(seed=1, **changes):
    """(port cfg, JAX cfg, port params, JAX params) on the same weights."""
    cfg, jcfg = _cfgs(**changes)
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu"), jp


@contextlib.contextmanager
def _chunk(n):
    """SSM CHUNK set to ``n`` in both packages."""
    old = jssm.CHUNK, tssm.CHUNK
    jssm.CHUNK = tssm.CHUNK = n
    try:
        yield
    finally:
        jssm.CHUNK, tssm.CHUNK = old


def _ssm_params(seed=3):
    cfg, jcfg = _cfgs()
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return cfg, jcfg, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}, jp


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    din = cfg.ssm_expand * cfg.d_model
    return {"h": rng.standard_normal((b, din, cfg.ssm_state)).astype(np.float32),
            "conv": rng.standard_normal((b, cfg.ssm_conv - 1, din)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,with_state", [(1, True), (1, False), (9, False), (9, True)])
def test_causal_conv_matches_reference(s, with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state else None
    y, new = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if st is None else torch.from_numpy(st))
    jy, jnew = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
    _close(y, jy, 1e-6)
    _close(new, jnew, 0)


@pytest.mark.parametrize("s,chunk,with_state", [
    (1, 128, True), (1, 128, False), (9, 128, False), (9, 128, True),
    (10, 4, True), (11, 3, False)])
def test_ssm_block_matches_reference(s, chunk, with_state):
    """The step (S = 1), one chunk, and several chunks whose last is
    ragged (10 over 4, 11 over 3), with and without a carried state: the
    output and the returned ``h`` and conv tail."""
    cfg, jcfg, tp, jp = _ssm_params()
    x = np.random.default_rng(4).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    st = _state(cfg, 2, seed=5) if with_state else None
    with _chunk(chunk):
        y, state = tssm.ssm_block(
            tp, torch.from_numpy(x), cfg,
            state=None if st is None else {k: torch.from_numpy(v) for k, v in st.items()})
        jy, jstate = jssm.ssm_block(
            jp, jnp.asarray(x), jcfg,
            state=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    _close(y, jy, 1e-5)
    assert sorted(state) == sorted(jstate) == ["conv", "h"]
    assert state["h"].dtype == torch.float32
    _close(state["h"], jstate["h"], 1e-5)
    # the conv tail is the last K - 1 rows of the in-projection's output
    # (the carried tail in front, else zeros): bit for bit the port's own
    # pre-conv rows, and the reference's within 1e-5, since the two
    # packages sum the float32 product x @ ssm_in_proj in another order
    din = cfg.ssm_expand * cfg.d_model
    xs = (torch.from_numpy(x) @ tp["ssm_in_proj"])[..., :din]
    front = (torch.zeros((2, cfg.ssm_conv - 1, din)) if st is None
             else torch.from_numpy(st["conv"]))
    assert torch.equal(state["conv"],
                       torch.cat([front, xs], dim=1)[:, -(cfg.ssm_conv - 1):])
    _close(state["conv"], jstate["conv"], 1e-5)


def test_scan_is_the_sequential_recurrence():
    """The log-step scan at 128 positions (the served chunk) against the
    recurrence h_t = decay_t h_{t-1} + drive_t run one position at a time,
    float64; decays small enough that their running product underflows."""
    rng = np.random.default_rng(6)
    dec = torch.from_numpy(rng.uniform(0.0, 0.6, (2, 128, 3, 4)))
    drv = torch.from_numpy(rng.standard_normal((2, 128, 3, 4)))
    got_dec, got_drv = tssm._scan(dec, drv)
    h = torch.zeros((2, 3, 4), dtype=torch.float64)
    prod = torch.ones((2, 3, 4), dtype=torch.float64)
    for t in range(128):
        h = dec[:, t] * h + drv[:, t]
        prod = prod * dec[:, t]
        torch.testing.assert_close(got_drv[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_dec[:, t], prod, rtol=1e-12, atol=0)
    assert float(prod.abs().max()) < 1e-30


def test_init_ssm_has_the_reference_keys_shapes_dtypes_and_scales():
    cfg, jcfg = _cfgs()
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tssm.init_ssm(torch.Generator().manual_seed(0), cfg, dtype, stacked=2)
        want = jssm.init_ssm(jax.random.PRNGKey(0), jcfg, jdtype, stacked=2)
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        # log(1..N): torch's log and XLA's may differ in the last place
        _close(got["stk_ssm_a_log"], want["stk_ssm_a_log"], 3e-7)
        _close(got["stk_ssm_d"], want["stk_ssm_d"], 0)
        for k in ("stk_ssm_in_proj", "stk_ssm_bc_proj", "stk_ssm_conv", "stk_ssm_out_proj"):
            ratio = float(got[k].float().std()) / float(np.asarray(want[k], np.float32).std())
            assert abs(ratio - 1) < 0.2, (k, ratio)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_tree_dtypes_and_cache_are_the_references():
    cfg, jcfg, _, jp = _both()
    assert cfg.layer_pattern() == jcfg.layer_pattern() == ["hybrid"] * 4
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(tuple, param_shapes(cfg),
                        is_leaf=lambda x: isinstance(x, tuple)) == shapes
    tinit = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tinit) == shapes
    # bf16: the SSM's a_log and d stay float32 on both sides
    bcfg, bjcfg = _cfgs(dtype="bfloat16")
    bjp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), bjcfg))
    bp = params_from_numpy(bjp, bcfg, "cpu")
    leaves = bp["stages"]["s0"]
    assert leaves["stk_ssm_a_log"].dtype == leaves["stk_ssm_d"].dtype == torch.float32
    assert leaves["stk_ssm_in_proj"].dtype == torch.bfloat16
    assert init_params(bcfg, torch.Generator().manual_seed(0), "cpu")[
        "stages"]["s0"]["stk_ssm_a_log"].dtype == torch.float32
    cache = Model(cfg).init_cache(2, 16, torch.bfloat16)
    jcache = JModel(jcfg).init_cache(2, 16, jnp.bfloat16)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), cache) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jcache)


@pytest.mark.parametrize("chunk", [128, 3])
def test_prefill_and_decode_logits_match_reference(chunk):
    """Prefill of 10 tokens (past the reduced window of 8; with CHUNK 3:
    four chunks, the last short), every cache leaf it fills, then 6 decode
    steps."""
    cfg, jcfg, tp, jp = _both()
    assert cfg.window == 8
    model, jmodel = Model(cfg), JModel(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    with _chunk(chunk):
        logits, cache = model.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 20)
        jlogits, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, 20)
        _close(logits, jlogits, 1e-4)
        for s in cache:
            assert sorted(cache[s]) == sorted(jcache[s]) == ["conv", "h", "k", "v"]
            for k in cache[s]:
                _close(cache[s][k].float(), np.asarray(jcache[s][k], np.float32), 1e-5)
        for t in range(6):
            tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
            pos = np.full((2,), 10 + t, np.int32)
            logits, cache = model.decode_step(tp, torch.from_numpy(tok).long(), cache,
                                              torch.from_numpy(pos))
            jlogits, jcache = jmodel.decode_step(jp, jnp.asarray(tok), jcache,
                                                 jnp.asarray(pos))
            _close(logits, jlogits, 1e-4)


@pytest.mark.parametrize("chunk", [128, 3])
def test_decode_matches_prefill(chunk):
    """The invariant of tests/test_decode_consistency.py inside the port,
    past the window of 8 (with CHUNK 3 the whole prompt's scan runs four
    chunks)."""
    cfg = reduced_config(get_config(ARCH))
    model = Model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    with _chunk(chunk):
        full, _ = model.prefill(params, {"tokens": toks}, 16)
        logits, cache = model.prefill(params, {"tokens": toks[:, :1]}, 16)
        for t in range(1, 12):
            logits, cache = model.decode_step(params, toks[:, t:t + 1], cache,
                                              torch.full((2,), t, dtype=torch.int32))
    assert float((logits - full).abs().max()) < 2e-3


def test_bf16_decode_keeps_the_conv_tail_exactly():
    """A bf16 model's conv tail lands in the float32 cache unrounded: the
    cache holds the bf16 values of the layer's last inputs."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype="bfloat16")
    model = Model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)))
    _, cache = model.prefill(params, {"tokens": toks}, 8)
    conv = cache["s0"]["conv"]
    assert conv.dtype == torch.float32 and bool(conv.abs().sum() > 0)
    assert torch.equal(conv, conv.to(torch.bfloat16).float())


@pytest.mark.parametrize("chunk", [128, 5])
def test_loss_and_gradients_match_the_reference(chunk):
    """Model.loss within 1e-5 relative and every gradient leaf (the
    float32 a_log and d included) within 1e-4 absolute of jax.grad."""
    cfg, jcfg, params, jp = _both()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    with _chunk(chunk):
        want_loss, want_g = jax.value_and_grad(JModel(jcfg).loss)(
            jp, {"tokens": jnp.asarray(toks)})
        loss, grads = value_and_grad(Model(cfg).loss, params,
                                     {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, grads)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, want_g))
    for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(want_g)):
        _close(g, w, 1e-4)


def test_loss_and_last_logits_at_the_full_vocabulary(monkeypatch):
    """hymba's own odd vocabulary, 32,001, at the reduced width: the
    chunked loss (three 16-row chunks, the last padded) and the last
    position's logits against the reference."""
    monkeypatch.setattr(j_transformer, "LOSS_CHUNK", 16)
    monkeypatch.setattr(t_transformer, "LOSS_CHUNK", 16)
    cfg, jcfg, tp, jp = _both(vocab_size=32_001)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    loss = Model(cfg).loss(tp, {"tokens": torch.from_numpy(toks)})
    jloss = JModel(jcfg).loss(jp, {"tokens": jnp.asarray(toks)})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    logits, _ = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks[:, :9]).long()}, 12)
    jlogits, _ = JModel(jcfg).prefill(jp, {"tokens": jnp.asarray(toks[:, :9])}, 12)
    assert logits.shape == (2, 1, 32_001)
    _close(logits, jlogits, 1e-4)


def test_greedy_serve_equals_reference_at_the_config_group_size():
    """ServingEngine token for token against the reference's engine at
    hymba's own group size G = 5 (10 heads over 2 KV heads; the reduced 4
    heads are served in tests/test_torch_serving.py); prompts past the
    window of 8."""
    cfg, jcfg, tp, jp = _both(seed=0, n_heads=10, n_kv_heads=2)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (4, 9, 9, 13, 6, 4)]
    news = (5, 7, 3, 6, 6, 4)
    got, stats = ServingEngine(Model(cfg), tp, s_max=64).serve(
        [Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, news))], n_batches=2)
    want, _ = JServingEngine(JModel(jcfg), jp, s_max=64).serve(
        [JRequest(i, p, n) for i, (p, n) in enumerate(zip(prompts, news))], n_batches=2)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert stats["decode_steps"] > 0

