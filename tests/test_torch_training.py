"""The port's training path (``Model.loss``, AdamW, the train step,
``TrainingRunner``, checkpoints, ``TokenPipeline``) against the JAX package,
on the CPU, for the reduced gemma-2b and gemma3-4b configs in float32.

Inputs and weights are made with numpy / ``jax.random`` from a seed and
carried over with ``params_from_numpy`` (weights) and
``opt_state_from_numpy`` (AdamW's ``mu``, ``nu``, ``step``), so both
packages run on the same numbers.  Tolerances, each with its reason:

* the loss within 1e-5 relative and every gradient leaf within 1e-4
  absolute: float32 sums taken in another order through a few layers;
* the schedule within 1e-7: the same float32 operations;
* train steps: losses within 1e-4 relative.  Parameters within
  ``2 * sum(lr)`` absolute, and all but 1% of the elements within 1e-5:
  AdamW turns a gradient within rounding of 0 into ``+-lr`` (its update is
  ``g / (|g| + eps)`` on the first step), whose sign differs between two
  orders of summation;
* the runner's losses within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.configs.reduced import reduced_config as j_reduced
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import Model as JModel
from repro.models import init_params as j_init_params
from repro.models import transformer as j_transformer
from repro.training import RunnerConfig as JRunnerConfig
from repro.training import TrainingRunner as JTrainingRunner
from repro.training import adamw_init as j_adamw_init
from repro.training import adamw_update as j_adamw_update
from repro.training import clip_by_global_norm as j_clip
from repro.training import lr_schedule as j_lr_schedule
from repro.training import make_train_step as j_make_train_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.data import TokenPipeline
from repro_torch.models import Model, opt_state_from_numpy, params_from_numpy
from repro_torch.models import transformer as t_transformer
from repro_torch.training import (RunnerConfig, TrainingRunner, adamw_init,
                                  adamw_update, clip_by_global_norm_,
                                  global_norm, latest_step, lr_schedule,
                                  make_eval_step, make_train_step,
                                  restore_checkpoint, save_checkpoint)
from repro_torch.training.optimizer import tree_map
from repro_torch.training.train_step import value_and_grad

ARCHS = ["gemma-2b", "gemma3-4b"]


def _both(arch, seed=1):
    """(port cfg, JAX cfg, port params, JAX params) on the same weights."""
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu"), jp


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _flat_np(tree):
    """{path: numpy} of a port tree (sorted keys) or a reference pytree."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        else:
            out["/".join(prefix)] = (node.detach().numpy()
                                     if isinstance(node, torch.Tensor)
                                     else np.asarray(node))
    walk(tree, ())
    return out


def _assert_trees_close(got, want, atol, rtol=0.0):
    g, w = _flat_np(got), _flat_np(want)
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


def _tcfg(cls, **kw):
    base = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5,
                remat="none", microbatches=1)
    base.update(kw)
    return cls(**base)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [512, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch, chunk, monkeypatch):
    """Model.loss within 1e-5 relative and every gradient leaf within 1e-4
    absolute of jax.grad; with a 16-row loss chunk the 40 positions run as
    three chunks, the last padded, in both packages."""
    monkeypatch.setattr(j_transformer, "LOSS_CHUNK", chunk)
    monkeypatch.setattr(t_transformer, "LOSS_CHUNK", chunk)
    cfg, jcfg, params, jp = _both(arch)
    if arch == "gemma3-4b":
        assert cfg.window == 8 and "local" in cfg.layer_pattern()
    toks = _tokens(cfg.vocab_size, 2, 40)
    want_loss, want_g = jax.value_and_grad(JModel(jcfg).loss)(
        jp, {"tokens": jnp.asarray(toks)})
    loss, grads = value_and_grad(Model(cfg).loss, params,
                                 {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _assert_trees_close(grads, want_g, atol=1e-4)


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b"])
def test_moe_loss_and_gradients_match_the_reference(arch):
    """The MoE decoders: the loss with the reference's ``0.01 * aux``
    within 1e-5 relative and every gradient leaf (router and experts
    included) within 1e-4 of jax.grad; grok's attention soft-cap runs on
    both sides, and its 2 of 4 experts drop tokens at capacity."""
    cfg, jcfg, params, jp = _both(arch)
    toks = _tokens(cfg.vocab_size, 2, 40, seed=2)
    want_loss, want_g = jax.value_and_grad(JModel(jcfg).loss)(
        jp, {"tokens": jnp.asarray(toks)})
    model = Model(cfg)
    loss, grads = value_and_grad(model.loss, params,
                                 {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _assert_trees_close(grads, want_g, atol=1e-4)
    # the aux term is in the loss: without it the two differ
    with torch.no_grad():
        x = model.embed(params, torch.from_numpy(toks))
        _, _, aux = model.backbone(params, x)
    assert float(aux) > 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_equal_gradients(arch):
    """none, dots and full recompute the same float32 operations: the loss
    and every gradient leaf agree to 1e-6."""
    cfg, _, params, _ = _both(arch)
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, 2, 24, seed=3))}
    model = Model(cfg)
    out = {r: value_and_grad(lambda p, b: model.loss(p, b, remat=r), params, batch)
           for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert abs(float(out[r][0]) - float(out["none"][0])) <= 1e-6
        _assert_trees_close(out[r][1], out["none"][1], atol=1e-6)


def test_remat_rejects_an_unknown_mode():
    cfg, _, params, _ = _both("gemma-2b")
    with pytest.raises(ValueError, match="remat"):
        Model(cfg).loss(params, {"tokens": torch.zeros((1, 8), dtype=torch.int64)},
                        remat="everything")


def test_loss_refuses_the_unported_branches():
    """Both branches are ported: the encoder's (whisper's training, held to
    the reference in ``tests/test_torch_encdec.py``) and the vision prefix
    (``tests/test_torch_vision.py``).  A text-only config ignores
    ``enc_embeds`` and ``img_embeds``, as the reference's loss does."""
    cfg, jcfg, params, jp = _both("gemma-2b")
    toks = _tokens(cfg.vocab_size, 1, 8)
    frames = np.ones((1, 4, cfg.d_model), np.float32)
    got = Model(cfg).loss(params, {"tokens": torch.from_numpy(toks),
                                   "enc_embeds": torch.from_numpy(frames)})
    want = JModel(jcfg).loss(jp, {"tokens": jnp.asarray(toks),
                                  "enc_embeds": jnp.asarray(frames)})
    assert float(got) == float(Model(cfg).loss(params, {"tokens": torch.from_numpy(toks)}))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    img = np.ones((1, 2, cfg.d_model), np.float32)
    got = Model(cfg).loss(params, {"tokens": torch.from_numpy(toks),
                                   "img_embeds": torch.from_numpy(img)})
    want = JModel(jcfg).loss(jp, {"tokens": jnp.asarray(toks),
                                  "img_embeds": jnp.asarray(img)})
    assert float(got) == float(Model(cfg).loss(params, {"tokens": torch.from_numpy(toks)}))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_eval_step_is_the_loss_without_a_graph():
    cfg, _, params, _ = _both("gemma-2b")
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, 2, 16))}
    got = make_eval_step(Model(cfg))(params, batch)
    assert not got.requires_grad
    assert float(got) == float(Model(cfg).loss(params, batch))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 5), (100, 1000)])
def test_lr_schedule_matches_the_reference(warmup, total):
    for step in [0, 1, 2, 3, 4, 5, 7, 9, 10, 11, 500, 2000]:
        got = float(lr_schedule(torch.tensor(step, dtype=torch.int32), 3e-4,
                                warmup, total))
        want = float(j_lr_schedule(jnp.asarray(step, jnp.int32), 3e-4, warmup,
                                   total))
        assert abs(got - want) <= 1e-7, (step, got, want)


def _grad_tree(seed, scale):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 7)).astype(np.float32) * scale,
            "b": {"c": rng.normal(size=(11,)).astype(np.float32) * scale,
                  "d": rng.normal(size=(2, 3, 4)).astype(np.float32) * scale}}


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_the_in_place_clip_equals_the_copying_clip_bit_for_bit(scale, chunk,
                                                                monkeypatch):
    """``clip_by_global_norm_`` scales the gradients in place, a slice at a
    time, with the per-element arithmetic of the copying clip it replaced
    (written out here: ``(g.float() * scale).to(g.dtype)`` into a new
    tree), on float32 and bf16 leaves; with the default ``CHUNK`` every
    leaf is one slice and the norm is the copying clip's whole-leaf sum bit
    for bit.  ``chunk`` 5 cuts the leaves into flat slices of 5 elements
    (the norm then adds the slices' sums in order)."""
    from repro_torch.training import optimizer as opt_mod
    if chunk:
        monkeypatch.setattr(opt_mod, "CHUNK", chunk)
    tree = tree_map(torch.from_numpy, _grad_tree(1, scale))
    tree["b"]["d"] = tree["b"]["d"].to(torch.bfloat16)
    before = tree_map(torch.clone, tree)
    got, norm = clip_by_global_norm_(tree, 1.0)
    assert got is tree
    if chunk is None:
        old = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                             for x in opt_mod.tree_leaves(before)))
        assert torch.equal(norm, old)
    factor = torch.clamp(1.0 / torch.clamp(norm, min=1e-9), max=1.0)
    copied = tree_map(lambda x: (x.float() * factor).to(x.dtype), before)
    for g, x in zip(opt_mod.tree_leaves(got), opt_mod.tree_leaves(copied)):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.parametrize("scale", [0.01, 1.0, 10.0])
def test_clip_by_global_norm_matches_the_reference(scale):
    tree = _grad_tree(0, scale)
    got, norm = clip_by_global_norm_(tree_map(lambda a: torch.from_numpy(a.copy()), tree),
                                     1.0)
    want, wnorm = j_clip(jax.tree.map(jnp.asarray, tree), 1.0)
    assert abs(float(norm) - float(wnorm)) <= 1e-6 * float(wnorm)
    _assert_trees_close(got, want, atol=1e-7, rtol=1e-6)
    assert float(global_norm(got)) <= max(1.0, float(norm)) * (1 + 1e-6)
    if float(norm) > 1.0:
        assert abs(float(global_norm(got)) - 1.0) <= 1e-5


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_the_reference(master, weight_decay, monkeypatch):
    """Three updates from the reference's state; a 20-element chunk makes
    the (5, 7) leaf update in slices, which changes nothing."""
    from repro_torch.training import optimizer
    monkeypatch.setattr(optimizer, "CHUNK", 20)
    params = _grad_tree(1, 1.0)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)   # updated in place
    jpar = jax.tree.map(jnp.asarray, params)
    state = adamw_init(tp, master=master)
    jstate = j_adamw_init(jpar, master=master)
    for i in range(3):
        g = _grad_tree(10 + i, 0.5)
        lr = 1e-2 * (i + 1)
        tp, state = adamw_update(tp, tree_map(torch.from_numpy, g), state,
                                 lr=torch.tensor(lr), weight_decay=weight_decay)
        jpar, jstate = j_adamw_update(jpar, jax.tree.map(jnp.asarray, g), jstate,
                                      lr=jnp.float32(lr),
                                      weight_decay=weight_decay)
        _assert_trees_close(tp, jpar, atol=1e-6)
        _assert_trees_close(state["mu"], jstate["mu"], atol=1e-7)
        _assert_trees_close(state["nu"], jstate["nu"], atol=1e-7)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        if master:
            _assert_trees_close(state["master"], jstate["master"], atol=1e-6)


@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_writes_its_result_in_place_slice_by_slice(master,
                                                                monkeypatch):
    """``adamw_update`` writes the new values into the given parameter (and
    master) tensors, as the train step's donation needs; leaves cut into
    flat slices (``CHUNK`` 5) give the values of one whole-leaf update bit
    for bit."""
    from repro_torch.training import optimizer as opt_mod
    rng = np.random.default_rng(2)
    params = {"a": torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32))
              .to(torch.bfloat16)}
    grads = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
             .to(v.dtype) for k, v in params.items()}
    copies = tree_map(torch.clone, params)
    kw = dict(lr=torch.tensor(1e-2), weight_decay=0.1)
    want, want_state = adamw_update(copies, grads, adamw_init(copies, master=master), **kw)
    monkeypatch.setattr(opt_mod, "CHUNK", 5)
    state = adamw_init(params, master=master)
    got, got_state = adamw_update(params, grads, state, **kw)
    for k in params:
        assert got[k] is params[k] and torch.equal(got[k], want[k])
        assert torch.equal(got_state["mu"][k], want_state["mu"][k])
        if master:
            assert got_state["master"][k] is state["master"][k]
            assert torch.equal(got_state["master"][k], want_state["master"][k])


def test_adamw_keeps_bf16_params_without_a_master_copy():
    """The reference's default on bf16: float32 moments, the update in
    float32 cast back to bf16, so an update below half a bf16 unit is
    lost (no master copy is added)."""
    p = {"w": torch.full((4,), 1.0, dtype=torch.bfloat16)}
    state = adamw_init(p)
    assert state["mu"]["w"].dtype == torch.float32 and "master" not in state
    new, state = adamw_update(p, {"w": torch.ones(4, dtype=torch.bfloat16)},
                              state, lr=torch.tensor(1e-4))
    assert new["w"].dtype == torch.bfloat16
    # 1 - 1e-4 rounds back to 1
    assert torch.equal(new["w"], torch.full((4,), 1.0, dtype=torch.bfloat16))
    new, _ = adamw_update(p, {"w": torch.ones(4, dtype=torch.bfloat16)},
                          adamw_init(p), lr=torch.tensor(1e-2))
    assert float(new["w"][0]) < 1.0


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _run_steps(arch, n, microbatches=1, remat="none"):
    cfg, jcfg, params, jp = _both(arch)
    tcfg = _tcfg(TrainConfig, microbatches=microbatches, remat=remat)
    jtcfg = _tcfg(JTrainConfig, microbatches=microbatches, remat=remat)
    step = make_train_step(Model(cfg), tcfg)
    jstep = jax.jit(j_make_train_step(JModel(jcfg), jtcfg))
    state = adamw_init(params)
    jstate = j_adamw_init(jp)
    pipe = TokenPipeline(cfg.vocab_size, batch=4, seq_len=24, seed=0)
    out = []
    for i in range(n):
        toks = pipe.batch_at(i)["tokens"]
        params, state, m = step(params, state, {"tokens": torch.from_numpy(toks)})
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(toks)})
        out.append((m, jm))
    return out, params, jp, state, jstate


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_the_reference(arch):
    out, params, jp, state, jstate = _run_steps(arch, 5)
    lrs = 0.0
    for m, jm in out:
        assert sorted(m) == sorted(jm) == ["grad_norm", "loss", "lr", "step"]
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"])
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-9
        assert int(m["step"]) == int(jm["step"])
        lrs += float(jm["lr"])
    g, w = _flat_np(params), _flat_np(jp)
    for k in g:
        diff = np.abs(g[k] - w[k])
        assert diff.max() <= 2 * lrs, (k, diff.max())
        assert (diff > 1e-5).mean() <= 0.01, (k, (diff > 1e-5).mean())
    assert int(state["step"]) == int(jstate["step"]) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_two_against_one(arch):
    """Two microbatches of 2 rows against one batch of 4: every row keeps
    S - 1 positions, so the mean of the two halves' losses is the whole
    batch's loss; and the port's two-microbatch step against the
    reference's."""
    two, params2, jp2, _, _ = _run_steps(arch, 2, microbatches=2)
    one, _, _, _, _ = _run_steps(arch, 1, microbatches=1)
    m2, jm2 = two[0]
    m1, _ = one[0]
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5 * float(m1["loss"])
    assert abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) <= 1e-4 * float(m1["grad_norm"])
    for m, jm in two:
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * float(jm["loss"])
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_train_step_matches_no_remat(remat):
    base, params0, _, _, _ = _run_steps("gemma3-4b", 2)
    got, params1, jp, _, _ = _run_steps("gemma3-4b", 2, remat=remat)
    for (m, jm), (b, _) in zip(got, base):
        assert abs(float(m["loss"]) - float(b["loss"])) <= 1e-6 * float(b["loss"])
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * float(jm["loss"])
    _assert_trees_close(params1, params0, atol=1e-6)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_recurrent_train_steps_match_the_reference_with_and_without_remat(arch):
    """The reduced xlstm (mLSTM and sLSTM) and hymba (attention beside the
    SSM): 2 steps under ``remat="none"`` and under ``"full"`` (each layer
    recomputed in the backward pass, as the card trains them) against the
    reference's steps under the same mode, with the tolerances of the
    dense steps above; the two modes within 1e-6 of each other."""
    runs = {remat: _run_steps(arch, 2, remat=remat) for remat in ("none", "full")}
    for remat, (out, params, jp, _, _) in runs.items():
        lrs = 0.0
        for m, jm in out:
            assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
            assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
                1e-4 * float(jm["grad_norm"])
            lrs += float(jm["lr"])
        g, w = _flat_np(params), _flat_np(jp)
        assert sorted(g) == sorted(w)
        for k in g:
            diff = np.abs(g[k] - w[k])
            assert diff.max() <= 2 * lrs, (remat, k, diff.max())
            assert (diff > 1e-5).mean() <= 0.01, (remat, k, (diff > 1e-5).mean())
    for (m, _), (b, _) in zip(runs["full"][0], runs["none"][0]):
        assert abs(float(m["loss"]) - float(b["loss"])) <= 1e-6 * float(b["loss"])
    _assert_trees_close(runs["full"][1], runs["none"][1], atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_continue_from_the_references_optimizer_state(arch):
    """Two reference steps, then its params and AdamW state carried over
    (params_from_numpy, opt_state_from_numpy) and one more step in each
    package: the same loss and parameters within the stated tolerance."""
    cfg, jcfg, _, jp = _both(arch)
    jstep = jax.jit(j_make_train_step(JModel(jcfg), _tcfg(JTrainConfig)))
    jstate = j_adamw_init(jp)
    pipe = TokenPipeline(cfg.vocab_size, batch=4, seq_len=24, seed=0)
    for i in range(2):
        jp, jstate, _ = jstep(jp, jstate, {"tokens": jnp.asarray(pipe.batch_at(i)["tokens"])})
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    assert int(state["step"]) == 2 and state["step"].dtype == torch.int32
    _assert_trees_close(state["mu"], jstate["mu"], atol=0)
    toks = pipe.batch_at(2)["tokens"]
    params, state, m = make_train_step(Model(cfg), _tcfg(TrainConfig))(
        params, state, {"tokens": torch.from_numpy(toks)})
    jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(toks)})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * float(jm["loss"])
    g, w = _flat_np(params), _flat_np(jp)
    for k in g:
        assert np.abs(g[k] - w[k]).max() <= 2 * float(jm["lr"]), k
    with pytest.raises(ValueError, match="step"):
        opt_state_from_numpy({**jax.tree.map(np.asarray, jstate),
                              "step": np.int64(3)}, cfg, "cpu")


# ---------------------------------------------------------------------------
# runner, checkpoints, data
# ---------------------------------------------------------------------------

def _runners(tmp_path, arch="gemma-2b", n=6, every=2, fail=(2, 5)):
    cfg, jcfg, params, jp = _both(arch)
    tcfg = _tcfg(TrainConfig, total_steps=n)
    jtcfg = _tcfg(JTrainConfig, total_steps=n)
    pipe = TokenPipeline(cfg.vocab_size, batch=4, seq_len=16, seed=0)
    jpipe = JTokenPipeline(jcfg.vocab_size, batch=4, seq_len=16, seed=0)
    injected, jinjected = [], []

    def fail_at(log):
        def inject(step):
            hit = step in fail
            if hit:
                log.append(step)
            return hit
        return inject

    runner = TrainingRunner(
        RunnerConfig(str(tmp_path / "torch"), checkpoint_every=every,
                     fail_injector=fail_at(injected)),
        make_train_step(Model(cfg), tcfg), params, adamw_init(params),
        pipe.batch_at)
    jrunner = JTrainingRunner(
        JRunnerConfig(str(tmp_path / "jax"), checkpoint_every=every,
                      fail_injector=fail_at(jinjected)),
        jax.jit(j_make_train_step(JModel(jcfg), jtcfg)), jp, j_adamw_init(jp),
        lambda i: {k: jnp.asarray(v) for k, v in jpipe.batch_at(i).items()})
    assert runner.run(n) == jrunner.run(n) == n
    assert injected == jinjected and sorted(set(injected)) == list(fail)
    return runner, jrunner


def test_runner_with_injected_failures_matches_the_reference(tmp_path):
    runner, jrunner = _runners(tmp_path)
    assert len(runner.metrics_log) == len(jrunner.metrics_log) == 6
    for m, jm in zip(runner.metrics_log, jrunner.metrics_log):
        assert sorted(m) == sorted(jm)
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        assert m["step"] == jm["step"]
    assert runner.heartbeat.last_step == 6
    assert latest_step(str(tmp_path / "torch")) == latest_step(str(tmp_path / "jax")) == 6


def test_runner_checkpoints_cross_between_the_packages(tmp_path):
    """Each package's runner restores the other's newest checkpoint (params
    and AdamW state, the reference's on-disk form) and carries on with the
    same losses."""
    runner, jrunner = _runners(tmp_path, n=4, every=2, fail=())
    cfg, jcfg, params, jp = _both("gemma-2b", seed=7)   # other weights
    tcfg = _tcfg(TrainConfig, total_steps=6)
    jtcfg = _tcfg(JTrainConfig, total_steps=6)
    pipe = TokenPipeline(cfg.vocab_size, batch=4, seq_len=16, seed=0)
    # the port restores the reference's directory
    port = TrainingRunner(RunnerConfig(str(tmp_path / "jax"), checkpoint_every=100),
                          make_train_step(Model(cfg), tcfg), params,
                          adamw_init(params), pipe.batch_at)
    assert port.maybe_restore() == 4
    _assert_trees_close(port.params, jrunner.params, atol=0)
    _assert_trees_close(port.opt_state["mu"], jrunner.opt_state["mu"], atol=0)
    assert int(port.opt_state["step"]) == 4
    # the reference restores the port's directory
    ref = JTrainingRunner(
        JRunnerConfig(str(tmp_path / "torch"), checkpoint_every=100),
        jax.jit(j_make_train_step(JModel(jcfg), jtcfg)), jp, j_adamw_init(jp),
        lambda i: {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
    assert ref.maybe_restore() == 4
    _assert_trees_close(ref.params, runner.params, atol=0)
    _assert_trees_close(ref.opt_state["nu"], runner.opt_state["nu"], atol=0)
    assert int(ref.opt_state["step"]) == 4
    # both carry on from step 4 with the same losses
    assert port.run(2) == ref.run(2) == 6
    for m, jm in zip(port.metrics_log, ref.metrics_log):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)


def test_runner_restarts_from_the_latest_checkpoint_when_retries_run_out(tmp_path):
    """A step that keeps failing past max_retries_per_step sends the runner
    back to the newest checkpoint, from where it replays the same batches
    (the reference's semantics)."""
    cfg, _, params, _ = _both("gemma-2b")
    step = make_train_step(Model(cfg), _tcfg(TrainConfig))
    calls = {"n": 0}

    def flaky(p, s, b):
        calls["n"] += 1
        if int(s["step"]) == 3 and calls["n"] <= 7:
            raise RuntimeError("lost the step")
        return step(p, s, b)

    pipe = TokenPipeline(cfg.vocab_size, batch=2, seq_len=8, seed=0)
    runner = TrainingRunner(RunnerConfig(str(tmp_path), checkpoint_every=2,
                                         max_retries_per_step=2),
                            flaky, params, adamw_init(params), pipe.batch_at)
    assert runner.run(5) == 5
    # step 4 failed three times: back to the step-2 checkpoint, step 3
    # replayed (logged again, the same loss), then steps 4 and 5
    log = runner.metrics_log
    assert [int(m["step"]) for m in log] == [1, 2, 3, 3, 4, 5]
    assert log[2]["loss"] == log[3]["loss"]


def test_a_step_failing_inside_its_update_restores_the_checkpoint(tmp_path,
                                                                   monkeypatch):
    """A step whose AdamW update fails part-way has overwritten some of the
    donated parameters: the runner does not retry it on them but restores
    the newest checkpoint at once and replays from there, ending on the
    uninterrupted run's parameters bit for bit."""
    from repro_torch.training import train_step as ts
    from repro_torch.training.optimizer import tree_leaves
    cfg, _, params, _ = _both("gemma-2b")
    pipe = TokenPipeline(cfg.vocab_size, batch=2, seq_len=8, seed=0)
    clean = TrainingRunner(RunnerConfig(str(tmp_path / "clean"), checkpoint_every=2),
                           make_train_step(Model(cfg), _tcfg(TrainConfig)),
                           tree_map(torch.clone, params),
                           adamw_init(params), pipe.batch_at)
    assert clean.run(4) == 4
    real, calls = ts.adamw_update, {"n": 0}

    def update(p, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:       # step 3: one leaf overwritten, then a fault
            tree_leaves(p)[0].fill_(float("nan"))
            raise RuntimeError("out of memory part-way")
        return real(p, *args, **kwargs)
    monkeypatch.setattr(ts, "adamw_update", update)
    runner = TrainingRunner(RunnerConfig(str(tmp_path / "faulty"), checkpoint_every=2,
                                         max_retries_per_step=2),
                            make_train_step(Model(cfg), _tcfg(TrainConfig)),
                            tree_map(torch.clone, params), adamw_init(params),
                            pipe.batch_at)
    assert runner.run(4) == 4
    assert calls["n"] == 5     # steps 1-2, the failed 3, then 3-4 again
    assert [int(m["step"]) for m in runner.metrics_log] == [1, 2, 3, 4]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runner.params),
                                                 tree_leaves(clean.params)))
    # with no checkpoint to go back to, the error goes up
    calls["n"] = 2
    fresh = TrainingRunner(RunnerConfig(str(tmp_path / "none"), checkpoint_every=5),
                           make_train_step(Model(cfg), _tcfg(TrainConfig)),
                           tree_map(torch.clone, params), adamw_init(params),
                           pipe.batch_at)
    with pytest.raises(ts.DonatedStateError):
        fresh.run(2)


def test_a_run_ending_on_a_checkpoint_writes_it_once(tmp_path, monkeypatch):
    """The last step of a run that was just checkpointed is not saved
    again (the reference saves it twice, the same content)."""
    cfg, _, params, _ = _both("gemma-2b")
    runner = TrainingRunner(RunnerConfig(str(tmp_path), checkpoint_every=2),
                            make_train_step(Model(cfg), _tcfg(TrainConfig)),
                            params, adamw_init(params),
                            TokenPipeline(cfg.vocab_size, batch=2, seq_len=8).batch_at)
    saves = []
    real = runner.ckpt.save
    monkeypatch.setattr(runner.ckpt, "save",
                        lambda step, tree: (saves.append(step), real(step, tree)))
    assert runner.run(4) == 4
    assert saves == [2, 4]
    assert runner.run(1) == 5 and saves == [2, 4, 5]


def test_runner_moves_numpy_batches_to_the_parameters_device(tmp_path):
    cfg, _, params, _ = _both("gemma-2b")
    seen = []

    def step(p, s, b):
        seen.append((type(b["tokens"]), b["tokens"].device.type))
        return p, s, {"loss": torch.tensor(0.0)}

    runner = TrainingRunner(RunnerConfig(str(tmp_path), checkpoint_every=10),
                            step, params, adamw_init(params),
                            lambda i: {"tokens": np.zeros((1, 4), np.int32)})
    runner.run(1)
    assert seen == [(torch.Tensor, "cpu")]


def test_bf16_leaves_round_trip_and_read_the_references_form(tmp_path):
    """A bf16 tensor checkpoints as the reference writes an ml_dtypes
    bfloat16 array (2-byte records, "bfloat16" in the manifest) and comes
    back bit for bit; a leaf the reference wrote loads as the same bits."""
    import json
    import ml_dtypes
    from repro.training import save_checkpoint as j_save
    x = torch.randn(5, 3).to(torch.bfloat16)
    save_checkpoint(str(tmp_path / "t"), 1, {"w": x})
    got, _ = restore_checkpoint(str(tmp_path / "t"), 1, {"w": torch.zeros_like(x)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], x)
    man = json.load(open(tmp_path / "t" / "step_00000001" / "manifest.json"))
    assert man["leaves"][0]["dtype"] == "bfloat16"
    arr = x.float().numpy().astype(ml_dtypes.bfloat16)
    j_save(str(tmp_path / "j"), 1, {"w": jnp.asarray(arr)})
    got, _ = restore_checkpoint(str(tmp_path / "j"), 1, {"w": torch.zeros_like(x)})
    assert torch.equal(got["w"], x)
    jman = json.load(open(tmp_path / "j" / "step_00000001" / "manifest.json"))
    assert jman["leaves"][0]["dtype"] == "bfloat16"


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_token_pipeline_matches_the_reference(shards):
    for index in range(shards):
        kw = dict(batch=8, seq_len=33, seed=5, shard_index=index, shard_count=shards)
        got, want = TokenPipeline(1000, **kw), JTokenPipeline(1000, **kw)
        for step in (0, 1, 17):
            a, b = got.batch_at(step)["tokens"], want.batch_at(step)["tokens"]
            assert a.dtype == b.dtype and np.array_equal(a, b)
        it, jit_ = got.iterate(3), want.iterate(3)
        for _ in range(2):
            assert np.array_equal(next(it)["tokens"], next(jit_)["tokens"])
        it.close()
        jit_.close()


def test_launch_train_prints_the_references_line_and_resumes(tmp_path, capsys):
    """``launch.train`` on the CPU: the reference driver's ``[train]`` line
    (times and losses left out: the weights are random in each package),
    resuming from its checkpoint on a second run; ``--mesh tiny`` trains on
    4 gloo ranks and prints the same line, for a mixture of experts too
    (``tests/test_torch_mesh_training.py`` and ``test_torch_moe_mesh.py``
    hold the mesh against the reference's)."""
    import re
    import subprocess
    import sys
    from repro_torch.launch import train
    flags = ["--arch", "gemma-2b", "--reduced", "--steps", "3", "--batch", "2",
             "--seq", "16", "--ckpt-every", "2"]
    train.main(flags + ["--ckpt-dir", str(tmp_path / "t"), "--device", "cpu"])
    got = capsys.readouterr().out
    ref = subprocess.run([sys.executable, "-m", "repro.launch.train", *flags,
                          "--ckpt-dir", str(tmp_path / "j")],
                         capture_output=True, text=True, timeout=600,
                         env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert ref.returncode == 0, ref.stderr[-2000:]

    def masked(text):
        text = re.sub(r"in \d+\.\ds", "in Ts", text)
        return re.sub(r"loss \d+\.\d+ -> \d+\.\d+", "loss A -> B", text).splitlines()
    assert masked(got) == masked(ref.stdout) == [
        "[train] gemma-2b steps 0->3 in Ts; loss A -> B"]
    train.main(flags[:3] + ["--steps", "2", "--batch", "2", "--seq", "16",
                            "--ckpt-dir", str(tmp_path / "t"), "--device", "cpu"])
    assert "steps 3->5" in capsys.readouterr().out
    train.main(flags + ["--mesh", "tiny", "--device", "cpu", "--dist-backend",
                        "gloo", "--ckpt-dir", str(tmp_path / "mesh")])
    assert masked(capsys.readouterr().out) == [
        "[train] gemma-2b steps 0->3 in Ts; loss A -> B"]
    train.main(["--arch", "grok-1-314b", *flags[2:], "--mesh", "tiny", "--device",
                "cpu", "--dist-backend", "gloo", "--ckpt-dir", str(tmp_path / "moe")])
    assert masked(capsys.readouterr().out) == [
        "[train] grok-1-314b steps 0->3 in Ts; loss A -> B"]
