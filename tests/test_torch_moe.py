"""The port's mixture-of-experts layer (``models/moe.py``) against the JAX
package, on the CPU, for the reduced grok-1 (top-2 of 4 experts, GeGLU)
and llama4-maverick (top-1 of 4, SwiGLU, greedy placement) in float32.

Both packages get the same weights (the reference's layer-0 MoE leaves,
carried over with ``params_from_numpy``) and the same numpy activations.
Routing is compared exactly: the (token, choice) entries sorted by slot,
their buffer rows, tokens and keep mask, the capacity buffers and the
expert load.  The gates, the dropped share and the aux loss agree to 1e-6
(the same float32 operations, summed in another order); the layer's
output to 1e-5 (float32 products and sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduced import reduced_config as j_reduced
from repro.models import init_params as j_init_params
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import moe as tmoe
from repro_torch.models import params_from_numpy
from repro_torch.models.transformer import stages_meta

MOE_ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]
# (name, config changes): the config's capacity, a capacity that drops
# tokens, the reference's flat dispatch, and expert fission
CASES = [("capacity", {}), ("drops", dict(capacity_factor=0.5)),
         ("global", dict(moe_dispatch="global")),
         ("split", dict(expert_split=2))]


def _layer(arch, seed=0, **changes):
    """(port cfg, JAX cfg, port layer params, JAX layer params): the first
    MoE layer of the reduced config, on the same weights."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    i = next(i for i, (kind, _) in enumerate(stages_meta(cfg)) if kind.endswith("+moe"))
    s = f"s{i}"
    return (cfg, jcfg, {k[4:]: v[0] for k, v in tp["stages"][s].items()},
            {k[4:]: v[0] for k, v in jp["stages"][s].items()})


def _x(cfg, b=2, s=11, seed=3):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _placements(cfg, which):
    """The same placement for both packages: none, or a fixed permutation
    of the experts."""
    if which == "none":
        return None, None
    perm = np.random.default_rng(7).permutation(cfg.n_experts).astype(np.int32)
    return torch.from_numpy(perm).long(), jnp.asarray(perm)


@pytest.mark.parametrize("placement", ["none", "permuted"])
@pytest.mark.parametrize("case,changes", CASES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_the_reference(arch, case, changes, placement):
    cfg, jcfg, tp, jp = _layer(arch, **changes)
    x = _x(cfg)
    tplace, jplace = _placements(cfg, placement)
    out, aux = tmoe.moe(tp, torch.from_numpy(x), cfg, placement=tplace)
    jout, jaux = jmoe.moe(jp, jnp.asarray(x), jcfg, placement=jplace)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(aux["expert_load"].numpy(), np.asarray(jaux["expert_load"]))
    # 1 - mean(keep) in float32: the two means may round apart by an ulp
    assert abs(float(aux["dropped_frac"]) - float(jaux["dropped_frac"])) <= 1e-6
    assert abs(float(aux["aux_loss"]) - float(jaux["aux_loss"])) <= 1e-6
    if case == "drops":
        assert float(aux["dropped_frac"]) > 0
    if case == "capacity" and arch == "grok-1-314b":
        assert cfg.top_k == 2 and cfg.mlp_act == "geglu"


@pytest.mark.parametrize("placement", ["none", "permuted"])
@pytest.mark.parametrize("case,changes", CASES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_is_identical(arch, case, changes, placement):
    """The dispatch on the same probabilities: the capacity buffers and the
    combine's metadata (buffer row of each sorted entry, hence its expert
    slot; its token; its gate; the keep mask), and the combine of the same
    expert outputs."""
    cfg, jcfg, _, _ = _layer(arch, **changes)
    rng = np.random.default_rng(5)
    t = 22
    xf = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((t, cfg.n_experts)).astype(np.float32)), axis=-1))
    split = 1 if case == "global" else cfg.expert_split
    cap = int(np.ceil(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    tplace, jplace = _placements(cfg, placement)
    buf, meta = tmoe._dispatch_one_group(torch.from_numpy(xf), torch.from_numpy(probs),
                                         cfg.top_k, cfg.n_experts, cap, tplace, split)
    jbuf, jmeta = jmoe._dispatch_one_group(jnp.asarray(xf), jnp.asarray(probs),
                                           cfg.top_k, cfg.n_experts, cap, jplace, split)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    for name, got, want in zip(("dest", "st"), meta[:2], jmeta[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    np.testing.assert_allclose(meta[2].numpy(), np.asarray(jmeta[2]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(meta[3].numpy(), np.asarray(jmeta[3]))
    assert meta[0].shape == (t * cfg.top_k * split,)
    if case == "drops":
        assert not bool(meta[3].all())
    out_buf = rng.standard_normal(buf.shape).astype(np.float32)
    got = tmoe._combine_one_group(torch.from_numpy(out_buf), meta, t, cfg.d_model)
    want = jmoe._combine_one_group(jnp.asarray(out_buf), jmeta, t, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_has_the_reference_leaves(arch):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), expert_split=2)
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), expert_split=2)
    got = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, stacked=3)
    want = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32, stacked=3)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    # the reference's scales: router and up/gate d**-0.5, down d_ff**-0.5
    assert abs(float(got["stk_router"].std()) - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5
    assert abs(float(got["stk_experts_down"].std()) - cfg.d_ff ** -0.5) < 0.2 * cfg.d_ff ** -0.5


def test_init_moe_keeps_the_router_in_float32():
    cfg = dataclasses.replace(reduced_config(get_config("grok-1-314b")), dtype="bfloat16")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["experts_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch,load", [
    ("llama4-maverick-400b-a17b", None), ("llama4-maverick-400b-a17b", "random"),
    ("grok-1-314b", None), ("gemma-2b", None)])
def test_expert_placement_equals_the_reference(arch, load):
    """The full-size configs: llama4's greedy placement of 128 experts over
    16 shards (uniform and measured loads), grok's and a dense config's
    default (the identity, and empty)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    est = (np.random.default_rng(1).random(cfg.n_experts) if load else None)
    got = tmoe.expert_placement(cfg, est)
    want = jmoe.expert_placement(jcfg, est)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert sorted(got.tolist()) == list(range(cfg.n_experts))
    if load:
        assert not np.array_equal(got, np.arange(cfg.n_experts))


def test_global_dispatch_refuses_expert_fission():
    cfg, _, tp, _ = _layer("grok-1-314b", expert_split=2)
    cfg = dataclasses.replace(cfg, moe_dispatch="global")
    with pytest.raises(ValueError, match="expert_split"):
        tmoe.moe(tp, torch.from_numpy(_x(cfg)), cfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_match_the_reference(arch):
    """The layer's output and aux loss are differentiable as the
    reference's: gradients of sum(out^2) + aux with respect to the input
    and every weight within 1e-4 (drops included)."""
    cfg, jcfg, tp, jp = _layer(arch, capacity_factor=0.75)
    x = _x(cfg, seed=9)

    def jloss(p, xx):
        out, aux = jmoe.moe(p, xx, jcfg)
        return jnp.sum(out ** 2) + aux["aux_loss"]

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()
              if k == "router" or k.startswith("experts_")}
    assert len(leaves) == 4
    out, aux = tmoe.moe(leaves, tx, cfg)
    (out.square().sum() + aux["aux_loss"]).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), rtol=0, atol=1e-4)
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[0][k]), rtol=0,
                                   atol=1e-4, err_msg=k)
