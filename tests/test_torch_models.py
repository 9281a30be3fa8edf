"""The port's LM substrate (layers, MLP, attention layer, dense decoder)
against the JAX package, on the CPU, for the reduced gemma3-4b and gemma-2b
configs in float32.

Inputs are made with numpy from a seed, and the reference's weights are
carried over to the port with ``params_from_numpy``, so both packages run
on the same numbers.  Tolerances: 1e-5 absolute for single layers and 1e-4
on logits (float32 sums taken in another order through a few layers, on
logits of magnitude below 10); decode-matches-prefill inside the port is
held to the reference test's 2e-3.
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
from repro.models import init_params as j_init_params
from repro.models import layers as jl
from repro.models import mlp as jmlp
from repro.models.transformer import stages_meta as j_stages_meta
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import Model, init_params, params_from_numpy, stages_meta
from repro_torch.models import layers as tl
from repro_torch.models import mlp as tmlp
from repro_torch.models.convert import param_shapes

ARCHS = ["gemma3-4b", "gemma-2b"]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def _both(arch, seed=1, **changes):
    """(port cfg, JAX cfg, port params, JAX params) on the same weights."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu"), jp


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    cfg, jcfg = reduced_config(get_config(arch)), j_reduced(j_get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_pattern() == jcfg.layer_pattern()
    assert stages_meta(cfg) == j_stages_meta(jcfg)
    assert get_config(arch).param_count() == j_get_config(arch).param_count()


def test_registry_lists_only_ported_configs_and_raises_on_others():
    assert list_configs() == sorted(ARCHS)
    for name in ("grok-1-314b", "xlstm-1.3b", "whisper-base", "no-such-arch"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            get_config(name)


@pytest.mark.parametrize("changes", [
    dict(n_experts=4, top_k=2), dict(hybrid=True, ssm_state=4),
    dict(family="ssm"), dict(n_encoder_layers=2, encoder_len=16)])
def test_unported_layer_kinds_raise(changes):
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")), **changes)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        Model(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        init_params(cfg, torch.Generator().manual_seed(0), "cpu")


# ---------------------------------------------------------------------------
# layers and MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(24).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(24).astype(np.float32)
    got = tl.norm({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(x), kind)
    want = jl.norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    _close(got, want, 1e-5)
    init = tl.init_norm(24, kind, torch.float32)
    jinit = jl.init_norm(24, kind, jnp.float32)
    assert set(init) == set(jinit)


def test_bf16_norm_casts_back_like_the_reference():
    x = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    got = tl.rms_norm({"scale": torch.ones(64, dtype=torch.bfloat16)},
                      torch.from_numpy(x).to(torch.bfloat16))
    want = jl.rms_norm({"scale": jnp.ones(64, jnp.bfloat16)},
                       jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 2 ** -7)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("per_batch", [False, True])
def test_rope_matches(theta, per_batch):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [5]])) if per_batch else np.arange(7)
    cos, sin = tl.rope(torch.from_numpy(pos), 16, theta)
    jcos, jsin = jl.rope(jnp.asarray(pos), 16, theta)
    _close(cos, jcos, 1e-6)
    _close(sin, jsin, 1e-6)
    _close(tl.apply_rope(torch.from_numpy(x), cos, sin),
           jl.apply_rope(jnp.asarray(x), jcos, jsin), 1e-5)


def test_softcap_matches():
    x = np.linspace(-80, 80, 101, dtype=np.float32)
    _close(tl.softcap(torch.from_numpy(x), 30.0), jl.softcap(jnp.asarray(x), 30.0), 1e-5)
    assert torch.equal(tl.softcap(torch.from_numpy(x), 0.0), torch.from_numpy(x))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(act):
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")), mlp_act=act)
    jp = jmlp.init_mlp(jax.random.PRNGKey(3), cfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    _close(tmlp.mlp(tp, torch.from_numpy(x), cfg),
           jmlp.mlp(jp, jnp.asarray(x), cfg), 1e-5)
    port = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    cfg = reduced_config(get_config(arch))
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = j_init_params(jax.random.PRNGKey(0), j_reduced(j_get_config(arch)))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes
    assert jax.tree.map(tuple, param_shapes(cfg),
                        is_leaf=lambda x: isinstance(x, tuple)) == shapes
    n = sum(t.numel() for t in jax.tree.leaves(tp))
    assert n == cfg.param_count() + cfg.d_model     # + the final norm
    # the reference's scales: embed 0.02, projections d**-0.5
    assert abs(float(tp["embed"].std()) - 0.02) < 0.004
    wq = tp["stages"]["s0"]["stk_wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


def test_params_from_numpy_checks_keys_shapes_and_dtypes():
    cfg = reduced_config(get_config("gemma-2b"))
    tree = jax.tree.map(np.asarray, j_init_params(
        jax.random.PRNGKey(0), j_reduced(j_get_config("gemma-2b"))))
    params_from_numpy(tree, cfg, "cpu")
    bad_key = {**tree, "stages": {"s0": {**tree["stages"]["s0"], "stk_extra": np.zeros(1)}}}
    with pytest.raises(ValueError, match="unexpected keys"):
        params_from_numpy(bad_key, cfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing keys"):
        params_from_numpy(missing, cfg, "cpu")
    bad_shape = {**tree, "embed": tree["embed"][:-1]}
    with pytest.raises(ValueError, match="embed: shape"):
        params_from_numpy(bad_shape, cfg, "cpu")
    bad_dtype = {**tree, "embed": tree["embed"].astype(np.float64)}
    with pytest.raises(ValueError, match="embed: dtype"):
        params_from_numpy(bad_dtype, cfg, "cpu")


def test_params_from_numpy_carries_bf16():
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")), dtype="bfloat16")
    jcfg = dataclasses.replace(j_reduced(j_get_config("gemma-2b")), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(tree, cfg, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_matches_reference(arch):
    """Full-sequence forward without a cache (flash_chunked on both sides)."""
    cfg, jcfg, tp, jp = _both(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 11))
    model, jmodel = Model(cfg), JModel(jcfg)
    h, _ = model.backbone(tp, model.embed(tp, torch.from_numpy(toks)))
    jh, _, _ = jmodel.backbone(jp, jmodel.embed(jp, jnp.asarray(toks)))
    _close(h, jh, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    cfg, jcfg, tp, jp = _both(arch)
    model, jmodel = Model(cfg), JModel(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    logits, cache = model.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 20)
    jlogits, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, 20)
    _close(logits, jlogits, 1e-4)
    for s in cache:
        for kv in ("k", "v"):
            _close(cache[s][kv], jcache[s][kv], 1e-5)
    for t in range(6):    # past the reduced gemma3-4b's window of 8
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), 12 + t, np.int32)
        logits, cache = model.decode_step(tp, torch.from_numpy(tok).long(), cache,
                                          torch.from_numpy(pos))
        jlogits, jcache = jmodel.decode_step(jp, jnp.asarray(tok), jcache,
                                             jnp.asarray(pos))
        _close(logits, jlogits, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """The invariant of tests/test_decode_consistency.py, inside the port."""
    cfg = reduced_config(get_config(arch))
    model = Model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    full, _ = model.prefill(params, {"tokens": toks}, 16)
    logits, cache = model.prefill(params, {"tokens": toks[:, :1]}, 16)
    for t in range(1, 12):
        logits, cache = model.decode_step(params, toks[:, t:t + 1], cache,
                                          torch.full((2,), t, dtype=torch.int32))
    assert float((logits - full).abs().max()) < 2e-3


def test_sliding_window_decode():
    """Decode at position p ignores keys <= p - window (the reference's
    test_decode_consistency.py::test_sliding_window_decode, in the port)."""
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")),
                              attn_pattern="window", window=4, skip_shapes=())
    model = Model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 10)))
    full, _ = model.prefill(params, {"tokens": toks}, 12)
    logits, cache = model.prefill(params, {"tokens": toks[:, :1]}, 12)
    for t in range(1, 10):
        logits, cache = model.decode_step(params, toks[:, t:t + 1], cache,
                                          torch.full((1,), t, dtype=torch.int32))
    assert float((logits - full).abs().max()) < 2e-3


def test_per_sequence_positions_equal_separate_runs():
    """Each sequence writes and attends at its own position (the reference
    takes pos[0] for the batch): two sequences decoded together at
    different positions give what each gives alone."""
    cfg = reduced_config(get_config("gemma3-4b"))
    model = Model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    rng = np.random.default_rng(5)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))) for n in (6, 11)]
    solo = []
    caches = []
    for p in prompts:
        _, c = model.prefill(params, {"tokens": p}, 16)
        caches.append(c)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
    for i, p in enumerate(prompts):
        lg, _ = model.decode_step(params, nxt[i:i + 1], caches[i],
                                  torch.tensor([p.shape[1]], dtype=torch.int32))
        solo.append(lg)
    joint = {s: {kv: torch.cat([caches[0][s][kv], caches[1][s][kv]], dim=1)
                 for kv in ("k", "v")} for s in caches[0]}
    pos = torch.tensor([6, 11], dtype=torch.int32)
    lg, _ = model.decode_step(params, nxt, joint, pos)
    _close(lg, torch.cat(solo).numpy(), 1e-5)
