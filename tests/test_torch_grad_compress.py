"""The port's gradient compression (``training/grad_compress.py``) against
the JAX package, on the CPU.

The round trips run the same float32 operations and are held equal bit for
bit; error feedback is held to converge as the reference's own test holds
it; ``compressed_psum`` on 4 gloo ranks (``launch.mesh.run_ranks`` with the
``compressed_psum`` job of ``launch.mesh_runs``) against the reference's
``shard_map`` over the conftest's 4 host devices, equal bit for bit (one
max, an integer sum, one multiply and one divide, in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.dist.compat import make_mesh, shard_map
from repro.training import compressed_psum as j_compressed_psum
from repro.training import int8_roundtrip as j_int8_roundtrip
from repro.training import make_compressor as j_make_compressor
from repro.training import topk_mask as j_topk_mask
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.mesh_runs import run_jobs
from repro_torch.training import int8_roundtrip, make_compressor, topk_mask


def _grad(seed, shape=(33, 17), scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 1e3)])
def test_int8_roundtrip_equals_the_reference(seed, scale):
    g = _grad(seed, scale=scale)
    deq, err = int8_roundtrip(torch.from_numpy(g))
    jdeq, jerr = j_int8_roundtrip(jnp.asarray(g))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))


def test_int8_roundtrip_of_zeros_and_bf16():
    z = torch.zeros(8)
    deq, err = int8_roundtrip(z)
    assert torch.equal(deq, z) and torch.equal(err, z)
    g = torch.from_numpy(_grad(3)).to(torch.bfloat16)
    deq, _ = int8_roundtrip(g)
    jdeq, _ = j_int8_roundtrip(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))
    assert deq.dtype == torch.float32
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.5, 1.0])
def test_topk_mask_equals_the_reference(frac):
    g = _grad(4)
    kept, err = topk_mask(torch.from_numpy(g), frac)
    jkept, jerr = j_topk_mask(jnp.asarray(g), frac)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    assert int((kept != 0).sum()) == max(1, int(g.size * frac))


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compressor_with_error_feedback_equals_the_reference(method):
    tree = {"a": _grad(5), "b": {"c": _grad(6, (40,))}}
    init, apply = make_compressor(method, topk_frac=0.1)
    jinit, japply = j_make_compressor(method, topk_frac=0.1)
    err = init({k: (torch.from_numpy(v) if k == "a" else
                    {"c": torch.from_numpy(v["c"])}) for k, v in tree.items()})
    jerr = jinit(jax.tree.map(jnp.asarray, tree))
    for step in range(3):
        g = {"a": _grad(10 + step), "b": {"c": _grad(20 + step, (40,))}}
        out, err = apply({"a": torch.from_numpy(g["a"]),
                          "b": {"c": torch.from_numpy(g["b"]["c"])}}, err)
        jout, jerr = japply(jax.tree.map(jnp.asarray, g), jerr)
        for got, want in ((out["a"], jout["a"]), (out["b"]["c"], jout["b"]["c"]),
                          (err["a"], jerr["a"]), (err["b"]["c"], jerr["b"]["c"])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_none_compressor_passes_gradients_through():
    init, apply = make_compressor("none")
    g = {"a": torch.ones(3)}
    assert init(g) is None
    assert apply(g, None) == (g, None)


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_error_feedback_converges(method):
    """Compressed gradient descent on a quadratic with error feedback
    reaches the optimum (the reference test's own bound, 1e-2)."""
    target = torch.from_numpy(_grad(7, (64,)))
    w = torch.zeros(64)
    init, apply = make_compressor(method, topk_frac=0.1)
    err = init({"w": w})
    for _ in range(400):
        g = {"w": w - target}
        cg, err = apply(g, err)
        w = w - 0.1 * cg["w"]
    assert float((w - target).abs().max()) < 1e-2


_X = (np.arange(4 * 4 * 6, dtype=np.float32).reshape(4, 4, 6) / 7.3
      - np.random.default_rng(8).normal(size=(4, 4, 6)).astype(np.float32))


@pytest.fixture(scope="module")
def psum_ranks():
    jobs = [{"kind": "compressed_psum", "x": list(_X), "method": m}
            for m in ("int8", "none")]
    return run_ranks(run_jobs, 4, backend="gloo", device="cpu", args=(jobs,))


@pytest.mark.parametrize("i,method", [(0, "int8"), (1, "none")])
def test_compressed_psum_on_4_gloo_ranks_equals_the_reference_shard_map(
        psum_ranks, host_devices, i, method):
    mesh = make_mesh((4,), ("data",))
    f = jax.jit(shard_map(lambda v: j_compressed_psum(v[0], "data", method)[None],
                          mesh=mesh, in_specs=P("data"), out_specs=P("data")))
    want = np.asarray(f(jnp.asarray(_X)))
    for r, per_rank in enumerate(psum_ranks):
        got = per_rank[i]["out"]
        assert got.dtype == np.float32
        if method == "int8":
            np.testing.assert_array_equal(got, want[r])
        else:   # a float sum over 4 ranks, in the backends' own orders
            np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6)
    counts = psum_ranks[0][0]["collectives"]["data"]
    assert counts == {"all_reduce": {"calls": 1, "bytes": 4 * 4 * 6},
                      "all_reduce_max": {"calls": 1, "bytes": 4}}
    expect = _X.mean(0)
    assert np.abs(psum_ranks[0][0]["out"] - expect).max() < np.abs(expect).max() / 64
