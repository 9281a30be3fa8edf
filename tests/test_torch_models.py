"""The port's LM substrate (layers, MLP, attention layer, decoders dense and
mixture-of-experts) against the JAX package, on the CPU, for the reduced
gemma3-4b, gemma-2b, internlm2-20b, command-r-35b, grok-1-314b and
llama4-maverick configs in float32, and at the true group sizes of
internlm2 and grok (G = 6) and llama4 (G = 5), which the reduced configs
(4 heads) leave out.

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

ARCHS = ["gemma3-4b", "gemma-2b", "internlm2-20b", "command-r-35b",
         "grok-1-314b", "llama4-maverick-400b-a17b"]
# the recurrent families: xlstm (mLSTM + sLSTM) and hymba (attention beside
# an SSM); their parity is in tests/test_torch_xlstm.py and test_torch_ssm.py
RECURRENT = ["xlstm-1.3b", "hymba-1.5b"]
# (arch, H, KV) at the config's own group size, the head dim left at the
# reduced 16
GROUPED = [("internlm2-20b", 12, 2), ("grok-1-314b", 12, 2),
           ("llama4-maverick-400b-a17b", 10, 2)]


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

@pytest.mark.parametrize("arch", ARCHS + RECURRENT)
def test_configs_equal_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    cfg, jcfg = reduced_config(get_config(arch)), j_reduced(j_get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_pattern() == jcfg.layer_pattern()
    assert stages_meta(cfg) == j_stages_meta(jcfg)
    assert get_config(arch).param_count() == j_get_config(arch).param_count()


def test_registry_lists_only_ported_configs_and_raises_on_others():
    """Every architecture of the reference is registered, whisper and
    phi3-vision (ported since) with them, each equal to the reference's;
    an unknown name raises a KeyError, as the reference's registry does."""
    from repro.configs import list_configs as j_list_configs
    assert list_configs() == sorted(ARCHS + RECURRENT + ["whisper-base",
                                                         "phi-3-vision-4.2b"])
    assert list_configs() == j_list_configs()
    for name in ("whisper-base", "phi-3-vision-4.2b"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name))
    with pytest.raises(KeyError, match="no-such-arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("changes", [
    dict(family="ssm", slstm_every=2), dict(hybrid=True, ssm_state=4),
    dict(family="ssm"), dict(n_encoder_layers=2, encoder_len=16)])
def test_unported_layer_kinds_raise(changes):
    """The kinds beyond attention's, on gemma-2b's reduced decoder: the
    recurrent and hybrid kinds (mLSTM + sLSTM, hybrid, mLSTM alone) and the
    encoder-decoder's ``enc`` and ``xdec`` build on the tiny mesh (their
    blocks, the encoder and the cross-attention are tensor-parallel;
    before, they raised there), the encoder-decoder with gemma-2b's one KV
    head too (each rank's query heads share it, the cross K/V columns
    gathered).  On one device each builds and runs a
    forward, with the reference's layer pattern and tree, and an ``xdec``
    stack reads the encoder's cross K/V (``Model.encode``,
    ``Model.cross_kv``) and refuses to run without them."""
    from repro_torch.launch.mesh import named_mesh_layout
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")), **changes)
    jcfg = dataclasses.replace(j_reduced(j_get_config("gemma-2b")), **changes)
    assert {k for k, _ in stages_meta(cfg)} <= {"mlstm", "slstm", "hybrid", "xdec"}
    assert stages_meta(cfg) == j_stages_meta(jcfg)
    if cfg.n_encoder_layers:
        specs = Model(cfg, mesh=named_mesh_layout("tiny")).specs
        assert specs["enc_pos"] == (None, None)
        assert specs["stages"]["s0"]["stk_xwk"] == (None, None, "model")
    else:
        assert Model(cfg, mesh=named_mesh_layout("tiny")).specs is not None
    model = Model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5)))
    enc = None
    if cfg.n_encoder_layers:
        with pytest.raises(ValueError, match="cross K/V"):
            model.backbone(params, model.embed(params, toks))
        frames = torch.from_numpy(np.random.default_rng(1).normal(
            size=(2, cfg.encoder_len, cfg.d_model)).astype(np.float32))
        enc = model.cross_kv(params, model.encode(params, frames))
    h, _, aux = model.backbone(params, model.embed(params, toks), enc_out=enc)
    assert h.shape == (2, 5, cfg.d_model) and aux is None
    assert bool(torch.isfinite(h).all())


@pytest.mark.parametrize("arch,changes", [
    ("xlstm-1.3b", {}), ("hymba-1.5b", {}),
    ("gemma-2b", dict(family="ssm"))])
def test_check_mesh_refuses_the_recurrent_and_hybrid_kinds(arch, changes):
    """The mLSTM, sLSTM and hybrid kinds train on a mesh since their blocks
    are tensor-parallel: ``check_mesh`` and ``Model(cfg, mesh=...)`` take
    the three reduced configs on the tiny mesh (``Model.specs`` places
    every leaf), where before they raised naming ROADMAP item 12 (the name
    kept from then); a model axis the heads or channels do not split is
    still refused (next test)."""
    from repro_torch.launch.mesh import named_mesh_layout
    from repro_torch.models.transformer import check_mesh
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    kinds = {k for k, _ in stages_meta(cfg)}
    assert kinds & {"mlstm", "slstm", "hybrid"}
    check_mesh(cfg, named_mesh_layout("tiny"))
    model = Model(cfg, mesh=named_mesh_layout("tiny"))
    assert sorted(model.specs["stages"]) == [f"s{i}" for i in range(len(stages_meta(cfg)))]


@pytest.mark.parametrize("arch,changes,leaf,split", [
    ("hymba-1.5b", dict(d_ff=5505), "stk_w_up", "mlp"),
    ("xlstm-1.3b", dict(d_model=2050), "stk_m_wq", "mlstm"),
    ("hymba-1.5b", dict(n_heads=24, n_kv_heads=6, d_model=1601, ssm_expand=1,
                        vocab_size=32000), "stk_ssm_out_proj", "ssm")])
def test_check_mesh_takes_a_model_axis_the_heads_or_channels_do_not_split(
        arch, changes, leaf, split):
    """A d_ff, an mLSTM head width or an SSM width the tiny mesh's model
    axis of 2 does not divide is taken (before, it was refused): the
    placement replicates the leaf, as the reference's does, and the part
    of the layer that holds it is not split (its layer runs it whole on
    every rank; ``tests/test_torch_mesh_training.py`` trains such configs
    against the reference's mesh)."""
    from repro_torch.launch.mesh import named_mesh_layout
    from repro_torch.models.mlp import mlp_split
    from repro_torch.models.ssm import ssm_split
    from repro_torch.models.transformer import check_mesh
    from repro_torch.models.xlstm import mlstm_split
    cfg = dataclasses.replace(get_config(arch), **changes)
    check_mesh(cfg, named_mesh_layout("tiny"))
    specs = Model(cfg, mesh=named_mesh_layout("tiny")).specs
    assert all(e is None for e in specs["stages"]["s0"][leaf]), leaf
    splits = {"mlp": mlp_split, "mlstm": mlstm_split, "ssm": ssm_split}
    assert not splits[split](cfg, 2)
    assert splits[split](get_config(arch), 2)


@pytest.mark.parametrize("arch,replicated", [
    ("whisper-base", ["embed"]), ("phi-3-vision-4.2b", []),
    ("hymba-1.5b", ["embed"])])
def test_full_width_configs_build_on_the_tiny_mesh(arch, replicated):
    """whisper-base, phi-3-vision-4.2b and hymba-1.5b at full width build on
    the tiny mesh: the leaves the model axis of 2 does not divide are
    replicated, as the reference places them (whisper's vocabulary of
    51,865, hymba's 32,001), and hymba's 25 heads run whole on every rank
    (wq's 1,600 columns cut at 800, mid-head)."""
    from repro_torch.launch.mesh import named_mesh_layout
    from repro_torch.models.attention import head_split
    from repro_torch.models.transformer import check_mesh
    cfg = get_config(arch)
    check_mesh(cfg, named_mesh_layout("tiny"))
    specs = Model(cfg, mesh=named_mesh_layout("tiny")).specs
    for name in ("embed", "lm_head"):
        if name in specs:
            assert (specs[name] == (None, None)) == (name in replicated), name
    assert specs["stages"]["s0"]["stk_wq"] == (None, None, "model")
    assert head_split(cfg, 2) == ("all" if arch == "hymba-1.5b" else "heads")


@pytest.mark.parametrize("arch", ["gemma3-4b", "hymba-1.5b", "xlstm-1.3b"])
def test_on_stage_hook_sees_every_stage_and_has_attention_names_its_layers(arch):
    """``Model.on_stage`` is entered once per stage, in order, with the
    stage's kind; ``has_attention`` holds for exactly the stages whose
    weights and decode cache have attention's leaves."""
    import contextlib
    from repro_torch.models.transformer import has_attention
    cfg = reduced_config(get_config(arch))
    model = Model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    model.on_stage = lambda kind: contextlib.nullcontext(seen.append(kind))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 4)))
    model.backbone(params, model.embed(params, toks))
    assert seen == [k for k, _ in stages_meta(cfg)]
    cache = model.init_cache(1, 8, device="cpu")
    for i, (kind, _) in enumerate(stages_meta(cfg)):
        assert has_attention(kind) == ("stk_wq" in params["stages"][f"s{i}"]) \
            == ("k" in cache[f"s{i}"])


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
    # + the final norm; layernorm's biases (command-r) are not in the count
    n_layers = len(cfg.layer_pattern())
    biases = (2 * n_layers + 1) * cfg.d_model if cfg.norm == "layernorm" else 0
    assert n == cfg.param_count() + cfg.d_model + biases
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

def _backbone_matches(arch, **changes):
    cfg, jcfg, tp, jp = _both(arch, **changes)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 11))
    model, jmodel = Model(cfg), JModel(jcfg)
    h, _, aux = model.backbone(tp, model.embed(tp, torch.from_numpy(toks)))
    jh, _, jaux = jmodel.backbone(jp, jmodel.embed(jp, jnp.asarray(toks)))
    _close(h, jh, 1e-4)
    # the MoE layers' summed load-balance loss (None for a dense model,
    # whose loss the reference counts as 0)
    assert (aux is None) == (not cfg.n_experts)
    assert abs((0.0 if aux is None else float(aux)) - float(jaux)) <= 1e-5
    assert aux is None or float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_matches_reference(arch):
    """Full-sequence forward without a cache (flash_chunked on both sides)."""
    _backbone_matches(arch)


@pytest.mark.parametrize("arch,h,kv", GROUPED)
def test_backbone_matches_reference_at_the_config_group_size(arch, h, kv):
    _backbone_matches(arch, n_heads=h, n_kv_heads=kv)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    _prefill_and_decode_match(arch)


@pytest.mark.parametrize("arch,h,kv", GROUPED)
def test_prefill_and_decode_match_reference_at_the_config_group_size(arch, h, kv):
    _prefill_and_decode_match(arch, n_heads=h, n_kv_heads=kv)


def _prefill_and_decode_match(arch, **changes):
    cfg, jcfg, tp, jp = _both(arch, **changes)
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
    """The invariant of tests/test_decode_consistency.py, inside the port;
    an MoE at a capacity that drops nothing (prefill and decode drop other
    tokens at their own capacities, as the reference test says)."""
    cfg = reduced_config(get_config(arch))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
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
