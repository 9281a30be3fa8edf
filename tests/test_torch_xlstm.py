"""The port's xLSTM blocks (``models/xlstm.py``) and the xlstm-1.3b model
against the JAX package, on the CPU, float32.

Inputs are made with numpy from a seed, and the reference's weights are
carried over with ``params_from_numpy`` (the blocks' own leaves turned into
tensors), so both packages run on the same numbers.  Tolerances, each with
its reason: a block's output and state within 1e-5 absolute (float32 sums
in another order); logits within 1e-4 (the same through a few layers, on
logits of magnitude below 10); decode against prefill inside the port
within the reference test's 2e-3 (``tests/test_decode_consistency.py``:
the chunkwise and the step forms of the mLSTM sum in different orders);
the loss within 1e-5 relative and every gradient leaf within 1e-4
absolute, as ``tests/test_torch_training.py`` holds the dense decoders.
``CHUNK`` is cut to 4 in both packages where a case must cross mLSTM
chunk boundaries (the reference's own multichunk test cuts it so).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as jx
from repro.configs import get_config as j_get_config
from repro.configs.reduced import reduced_config as j_reduced
from repro.models import Model as JModel
from repro.models import init_params as j_init_params
from repro.models import transformer as j_transformer
import repro_torch.models.xlstm as tx
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import Model, init_params, params_from_numpy
from repro_torch.models import transformer as t_transformer
from repro_torch.models.convert import param_shapes
from repro_torch.training.train_step import value_and_grad

ARCH = "xlstm-1.3b"


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
    """mLSTM CHUNK set to ``n`` in both packages."""
    old = jx.CHUNK, tx.CHUNK
    jx.CHUNK = tx.CHUNK = n
    try:
        yield
    finally:
        jx.CHUNK, tx.CHUNK = old


def _block_params(init, seed):
    cfg, jcfg = _cfgs()
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return cfg, jcfg, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}, jp


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _mlstm_state(cfg, b, seed):
    """A state as decode finds it: c, n of the size a few steps give, m a
    finite running maximum."""
    rng = np.random.default_rng(seed)
    h = cfg.n_heads
    hd = tx.PROJ_FACTOR * cfg.d_model // h
    return {"c": rng.standard_normal((b, h, hd, hd)).astype(np.float32),
            "n": rng.standard_normal((b, h, hd)).astype(np.float32),
            "m": rng.uniform(-3.0, 0.0, (b, h)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk,with_state", [
    (1, 64, True), (1, 64, False), (7, 64, False), (7, 64, True),
    (10, 4, True), (12, 4, False)])
def test_mlstm_block_matches_reference(s, chunk, with_state):
    """The step (S = 1), one chunk (S < CHUNK) and several chunks with a
    ragged last one (S = 10 over 4), each with and without a carried
    state; the output and the returned state."""
    cfg, jcfg, tp, jp = _block_params(jx.init_mlstm, seed=3)
    x = _x(cfg, 2, s, seed=4)
    st = _mlstm_state(cfg, 2, seed=5) if with_state else None
    with _chunk(chunk):
        y, state = tx.mlstm_block(
            tp, torch.from_numpy(x), cfg,
            state=None if st is None else {k: torch.from_numpy(v.copy())
                                           for k, v in st.items()})
        jy, jstate = jx.mlstm_block(
            jp, jnp.asarray(x), jcfg,
            state=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    _close(y, jy, 1e-5)
    assert sorted(state) == sorted(jstate) == ["c", "m", "n"]
    for k in state:
        assert state[k].dtype == torch.float32
        _close(state[k], jstate[k], 1e-5)


def test_mlstm_gradient_stays_finite_where_the_masked_weights_overflow():
    """Gates 60 times larger than the init's (as a full-width model's can
    be): the forget gates' logs summed over a 64-position chunk pass the
    float32 exponent, so above the diagonal exp(b_log - m_new) overflows.
    The reference takes the exp before its mask and its gradient is nan;
    the port masks first: the same output (within 1e-4: the larger gates
    make larger sums, taken in another order) and every gradient finite."""
    cfg, jcfg, tp, jp = _block_params(jx.init_mlstm, seed=3)
    tp["m_wif"] = tp["m_wif"] * 60.0
    jp = dict(jp, m_wif=jp["m_wif"] * 60.0)
    x = _x(cfg, 2, 64, seed=4)
    with _chunk(64):
        tp = {k: v.requires_grad_() for k, v in tp.items()}
        y, _ = tx.mlstm_block(tp, torch.from_numpy(x), cfg)
        grads = torch.autograd.grad(y.sum(), list(tp.values()))
        jy, _ = jx.mlstm_block(jp, jnp.asarray(x), jcfg)
        jg = jax.grad(lambda p: jx.mlstm_block(p, jnp.asarray(x), jcfg)[0].sum())(jp)
    _close(y, jy, 1e-4)
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jg))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_mlstm_step_updates_the_given_state_in_place():
    cfg, _, tp, _ = _block_params(jx.init_mlstm, seed=3)
    st = {k: torch.from_numpy(v) for k, v in _mlstm_state(cfg, 2, seed=6).items()}
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    before = {k: v.clone() for k, v in st.items()}
    _, new = tx.mlstm_block(tp, torch.from_numpy(_x(cfg, 2, 1, seed=7)), cfg, state=st)
    for k in st:
        assert new[k] is st[k] and new[k].data_ptr() == ptrs[k]
        assert not torch.equal(st[k], before[k])


@pytest.mark.parametrize("s,with_state", [(1, True), (9, False), (9, True)])
def test_slstm_block_matches_reference(s, with_state):
    cfg, jcfg, tp, jp = _block_params(jx.init_slstm, seed=8)
    x = _x(cfg, 2, s, seed=9)
    st = None
    if with_state:
        rng = np.random.default_rng(10)
        st = {k: rng.standard_normal((2, cfg.d_model)).astype(np.float32)
              for k in ("c", "n", "h")}
        st["m"] = rng.uniform(-3.0, 0.0, (2, cfg.d_model)).astype(np.float32)
    y, state = tx.slstm_block(
        tp, torch.from_numpy(x), cfg,
        state=None if st is None else {k: torch.from_numpy(v) for k, v in st.items()})
    jy, jstate = jx.slstm_block(
        jp, jnp.asarray(x), jcfg,
        state=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    _close(y, jy, 1e-5)
    assert sorted(state) == sorted(jstate) == ["c", "h", "m", "n"]
    for k in state:
        _close(state[k], jstate[k], 1e-5)


def test_block_inits_have_the_reference_keys_shapes_and_scales():
    cfg, jcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    for init, jinit in ((tx.init_mlstm, jx.init_mlstm), (tx.init_slstm, jx.init_slstm)):
        for stacked in (0, 3):
            got = init(gen, cfg, torch.float32, stacked=stacked)
            want = jinit(jax.random.PRNGKey(0), jcfg, jnp.float32, stacked=stacked)
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}
            for k in got:
                # the ratio of two sample deviations: wider for the
                # 64-element recurrent gate
                tol = 0.2 if got[k].numel() >= 4096 else 0.5
                ratio = float(got[k].std()) / float(np.asarray(want[k]).std())
                assert abs(ratio - 1) < tol, (k, ratio)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_config_tree_and_cache_are_the_references():
    cfg, jcfg, tp, jp = _both()
    assert cfg.layer_pattern() == jcfg.layer_pattern() == ["mlstm", "slstm"] * 2
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(tuple, param_shapes(cfg),
                        is_leaf=lambda x: isinstance(x, tuple)) == shapes
    tinit = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tinit) == shapes
    # the analytic count plus the final norm
    assert sum(t.numel() for t in jax.tree.leaves(tinit)) == cfg.param_count() + cfg.d_model
    cache = Model(cfg).init_cache(2, 16, torch.float32)
    jcache = JModel(jcfg).init_cache(2, 16, jnp.float32)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), cache) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jcache)
    _close(cache["s0"]["m"], jcache["s0"]["m"], 0)


@pytest.mark.parametrize("chunk", [64, 4])
def test_prefill_and_decode_logits_match_reference(chunk):
    """Prefill of 10 tokens (with CHUNK 4: three chunks, the last ragged),
    the states it leaves, then 6 decode steps."""
    cfg, jcfg, tp, jp = _both()
    model, jmodel = Model(cfg), JModel(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    with _chunk(chunk):
        logits, cache = model.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 20)
        jlogits, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, 20)
        _close(logits, jlogits, 1e-4)
        for s in cache:
            assert sorted(cache[s]) == sorted(jcache[s])
            for k in cache[s]:
                _close(cache[s][k], jcache[s][k], 1e-4)
        for t in range(6):
            tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
            pos = np.full((2,), 10 + t, np.int32)
            logits, cache = model.decode_step(tp, torch.from_numpy(tok).long(), cache,
                                              torch.from_numpy(pos))
            jlogits, jcache = jmodel.decode_step(jp, jnp.asarray(tok), jcache,
                                                 jnp.asarray(pos))
            _close(logits, jlogits, 1e-4)


@pytest.mark.parametrize("chunk", [64, 4])
def test_decode_matches_prefill(chunk):
    """The invariant of tests/test_decode_consistency.py inside the port:
    12 positions prefilled whole (with CHUNK 4: three chunks) against one
    prefilled and 11 decoded."""
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


@pytest.mark.parametrize("chunk", [64, 4])
def test_loss_and_gradients_match_the_reference(chunk):
    """Model.loss within 1e-5 relative and every gradient leaf within 1e-4
    absolute of jax.grad (with CHUNK 4 the 24 positions run as 6 chunks)."""
    cfg, jcfg, params, jp = _both()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    with _chunk(chunk):
        want_loss, want_g = jax.value_and_grad(JModel(jcfg).loss)(
            jp, {"tokens": jnp.asarray(toks)})
        loss, grads = value_and_grad(Model(cfg).loss, params,
                                     {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got, want = jax.tree.leaves(grads), jax.tree.leaves(want_g)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, grads)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, want_g))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_loss_and_last_logits_at_the_full_vocabulary(monkeypatch):
    """xlstm's own vocabulary, 50,304, at the reduced width: the chunked
    loss (three 16-row chunks, the last padded) and the last position's
    logits against the reference."""
    monkeypatch.setattr(j_transformer, "LOSS_CHUNK", 16)
    monkeypatch.setattr(t_transformer, "LOSS_CHUNK", 16)
    cfg, jcfg, tp, jp = _both(vocab_size=50_304)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    loss = Model(cfg).loss(tp, {"tokens": torch.from_numpy(toks)})
    jloss = JModel(jcfg).loss(jp, {"tokens": jnp.asarray(toks)})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    logits, _ = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks[:, :9]).long()}, 12)
    jlogits, _ = JModel(jcfg).prefill(jp, {"tokens": jnp.asarray(toks[:, :9])}, 12)
    assert logits.shape == (2, 1, 50_304)
    _close(logits, jlogits, 1e-4)

