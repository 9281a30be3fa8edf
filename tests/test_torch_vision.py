"""phi-3-vision-4.2b in the port against the JAX package, on the CPU, at the
reduced config (4 heads of 16, a 4-position image prefix) in float32.

The reference's loss prefixes the text with the batch's precomputed image
patch embeddings (``img_embeds``, the stubbed CLIP front end's output) and
masks the image positions; its prefill and decode take no image.  Inputs
are made with numpy from a seed and the reference's weights carried over
with ``params_from_numpy``.  Tolerances, as ``tests/test_torch_training.py``
holds the text-only decoders: the loss within 1e-5 relative and every
gradient leaf within 1e-4 absolute (float32 sums in another order through
a few layers); logits within 1e-4; decode-matches-prefill inside the port
within the reference test's 2e-3.
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
from repro.models import transformer as j_transformer
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import Model, init_params, params_from_numpy
from repro_torch.models import transformer as t_transformer
from repro_torch.training.train_step import value_and_grad

ARCH = "phi-3-vision-4.2b"


def _both(seed=1):
    jcfg = j_reduced(j_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu"), jp


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    img = rng.normal(size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return toks, img


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), (tree.detach().numpy() if isinstance(tree, torch.Tensor)
                                 else np.asarray(tree))


def test_config_and_tree_equal_the_reference():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(j_get_config(ARCH))
    cfg, jcfg, _, jp = _both()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.head_dim == 16 and get_config(ARCH).head_dim == 96
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)


@pytest.mark.parametrize("chunk", [512, 16])
@pytest.mark.parametrize("s", [24, 40])
def test_loss_and_gradients_with_the_image_prefix_match_the_reference(
        s, chunk, monkeypatch):
    """The loss with ``img_embeds`` prefixing the text within 1e-5
    relative and every gradient leaf within 1e-4 of ``jax.grad``; with a
    16-row loss chunk the positions run as several chunks, the last padded
    at S = 40, in both packages."""
    monkeypatch.setattr(j_transformer, "LOSS_CHUNK", chunk)
    monkeypatch.setattr(t_transformer, "LOSS_CHUNK", chunk)
    cfg, jcfg, params, jp = _both()
    toks, img = _batch(cfg, 2, s, seed=s)
    want_loss, want_g = jax.value_and_grad(JModel(jcfg).loss)(
        jp, {"tokens": jnp.asarray(toks), "img_embeds": jnp.asarray(img)})
    loss, grads = value_and_grad(Model(cfg).loss, params, {
        "tokens": torch.from_numpy(toks), "img_embeds": torch.from_numpy(img)})
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got, want = dict(_flat(grads)), dict(_flat(want_g))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)


def test_the_image_prefix_changes_the_loss_and_masks_its_positions():
    """The prefix is read (another image, another loss) and only the last
    image position is scored: its target is the first text token, so the
    loss moves when that token does and not when a token the prefix
    displaces (the last F of ``tokens``) does."""
    cfg, _, params, _ = _both()
    toks, img = _batch(cfg, 2, 24, seed=3)
    model = Model(cfg)

    def loss(t, i):
        return float(model.loss(params, {"tokens": torch.from_numpy(t),
                                         "img_embeds": torch.from_numpy(i)}))
    base = loss(toks, img)
    assert loss(toks, img * 2.0) != base
    first = toks.copy()
    first[:, 0] = (first[:, 0] + 1) % cfg.vocab_size
    assert loss(first, img) != base
    dropped = toks.copy()
    dropped[:, -cfg.frontend_len:] = (dropped[:, -cfg.frontend_len:] + 1) % cfg.vocab_size
    assert loss(dropped, img) == base


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_with_the_image_prefix_gives_equal_gradients(remat):
    cfg, _, params, _ = _both()
    toks, img = _batch(cfg, 2, 24, seed=5)
    batch = {"tokens": torch.from_numpy(toks), "img_embeds": torch.from_numpy(img)}
    model = Model(cfg)
    base = value_and_grad(model.loss, params, batch)
    got = value_and_grad(lambda p, b: model.loss(p, b, remat=remat), params, batch)
    assert abs(float(got[0]) - float(base[0])) <= 1e-6
    for (k, g), (_, w) in zip(_flat(got[1]), _flat(base[1])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)


def test_prefill_and_decode_take_no_image_and_match_the_reference():
    """Serving is tokens only, as the reference's: prefill logits within
    1e-4 of the reference's; prefill of one token then 11 decode steps
    within 2e-3 of the whole prefill (and within 1e-4 of the reference's
    decode)."""
    cfg, jcfg, params, jp = _both()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jm, m = JModel(jcfg), Model(cfg)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    with torch.inference_mode():
        full, _ = m.prefill(params, {"tokens": torch.from_numpy(toks)}, 16)
        np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=0, atol=1e-4)
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(toks[:, :1])}, 16)
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :1])}, 16)
        for t in range(1, 12):
            logits, cache = m.decode_step(params, torch.from_numpy(toks[:, t:t + 1]),
                                          cache, torch.full((2,), t, dtype=torch.int32))
            jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                    jnp.full((2,), t, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert float((logits - full).abs().max()) < 2e-3


def test_the_image_prefix_on_a_mesh_raises():
    """The vision prefix trains on the tiny mesh
    (``tests/test_torch_mesh_training.py`` holds it against the reference's
    mesh): each data rank's block of the batch holds its rows' images
    beside its rows' tokens (``batch_block``, a stand-in mesh of
    coordinates), and a batch the data axis does not divide is held whole,
    images too, marked ``whole_batch``."""
    from repro_torch.training.fault_tolerance import batch_block
    cfg, _, _, _ = _both()
    assert Model(cfg).cfg.frontend == "vision"

    class Stub:
        mesh_dim_names = ("data", "model")

        def __init__(self, d):
            self.d = d

        def size(self, i):
            return 2

        def get_local_rank(self, axis):
            return self.d if axis == "data" else 0

    for rows in (4, 3):
        toks, img = _batch(cfg, rows, 24, seed=1)
        for d in range(2):
            got = batch_block({"tokens": toks, "img_embeds": img}, "cpu", Stub(d))
            lo, hi = (2 * d, 2 * d + 2) if rows == 4 else (0, rows)
            assert np.array_equal(got["tokens"].numpy(), toks[lo:hi])
            assert np.array_equal(got["img_embeds"].numpy(), img[lo:hi])
            assert got.get("whole_batch", False) == (rows == 3)
