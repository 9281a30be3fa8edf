"""The port's level-expansion engine against the reference engine: every
LevelResult (mask, supports, the padded survivor block) and the pair-padding
ledger equal to JAX ``JnpEngine.expand`` across modes and shapes."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import engine as jeng
from repro.core.bitmap import popcount_np

from repro_torch.core import engine as teng
from repro_torch.device import words_from_numpy, words_to_numpy

MODES = [teng.MODE_TIDSET, teng.MODE_TID_TO_DIFF, teng.MODE_DIFFSET]
# the reference engine suite's shapes: empty, singleton, W not a multiple
# of the word tile, more pairs than rows
SHAPES = [(1, 1, 0), (1, 1, 1), (5, 3, 13), (64, 4, 37), (130, 9, 21), (40, 130, 200)]


def _case(p, w, q, seed):
    rng = np.random.default_rng(seed)
    bitmaps = rng.integers(0, 2**32, (p, w), dtype=np.uint32)
    left = rng.integers(0, p, q).astype(np.int32)
    right = rng.integers(0, p, q).astype(np.int32)
    sup_left = (popcount_np(bitmaps[left]).sum(-1).astype(np.int32)
                if q else np.zeros(0, np.int32))
    return bitmaps, left, right, sup_left


def _min_sup(bitmaps, left, right, survivors):
    if survivors == "none":
        return 10**6
    if survivors == "all":
        return 1
    if left.size == 0:
        return 1
    return int(np.median(popcount_np(bitmaps[left] & bitmaps[right]).sum(-1)))


def _assert_level_equal(got, want):
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.supports, want.supports)
    assert got.supports.dtype == want.supports.dtype
    np.testing.assert_array_equal(words_to_numpy(got.bitmaps),
                                  np.asarray(want.bitmaps))


@pytest.mark.parametrize("backend", ["fused", "ref"])
@pytest.mark.parametrize("bucket_min", [8, 32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q", SHAPES)
@pytest.mark.parametrize("survivors", ["median", "none", "all"])
def test_level_result_matches_jnp_engine(backend, bucket_min, mode, p, w, q,
                                         survivors):
    bitmaps, left, right, sup_left = _case(p, w, q, seed=p * 31 + w + q + mode)
    ms = _min_sup(bitmaps, left, right, survivors)
    t_eng = teng.make_engine(backend, bucket_min=bucket_min)
    j_eng = jeng.make_engine("jnp", bucket_min=bucket_min)
    got = t_eng.expand(words_from_numpy(bitmaps, "cpu"), left, right, sup_left,
                       mode=mode, min_sup=ms)
    want = j_eng.expand(jnp.asarray(bitmaps), left, right, sup_left,
                        mode=mode, min_sup=ms)
    _assert_level_equal(got, want)
    assert t_eng.stats().get("pair_padding") == j_eng.stats().get("pair_padding")
    assert t_eng.stats()["n_padded"] == j_eng.stats()["n_padded"]


@pytest.mark.parametrize("backend", ["fused", "ref"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q", SHAPES)
@pytest.mark.parametrize("survivors", ["median", "none"])
def test_no_compaction_gives_the_compacting_result_bit_for_bit(backend, mode, p, w,
                                                               q, survivors):
    """``compact=False`` (K1's whole block, the host mask, a row gather):
    the mask, the supports and every row of the survivor block, the rung
    padding included, equal the compacting engine's and the reference's
    ``compact=False`` ``JnpEngine``; the ledger too."""
    bitmaps, left, right, sup_left = _case(p, w, q, seed=p * 7 + w + q + mode)
    ms = _min_sup(bitmaps, left, right, survivors)
    runs = []
    for compact in (False, True):
        e = teng.make_engine(backend, bucket_min=8, compact=compact)
        assert e.compact == compact and e.snapshot_state().compact == compact
        runs.append((e, e.expand(words_from_numpy(bitmaps, "cpu"), left, right,
                                 sup_left, mode=mode, min_sup=ms)))
    j_eng = jeng.make_engine("jnp", bucket_min=8, compact=False)
    want = j_eng.expand(jnp.asarray(bitmaps), left, right, sup_left, mode=mode,
                        min_sup=ms)
    for e, got in runs:
        _assert_level_equal(got, want)
        assert e.stats().get("pair_padding") == j_eng.stats().get("pair_padding")


def test_pair_padding_ledger_over_many_levels():
    """A sequence of expansions on one engine: the per-level ledger, its
    efficiency and the counters stay equal to the reference's."""
    t_eng = teng.make_engine("fused", bucket_min=8)
    j_eng = jeng.make_engine("jnp", bucket_min=8)
    for i, (p, w, q) in enumerate([(64, 4, 37), (5, 3, 13), (130, 9, 121),
                                   (1, 1, 0), (40, 3, 9)]):
        bitmaps, left, right, sup_left = _case(p, w, q, seed=i)
        ms = _min_sup(bitmaps, left, right, "median")
        _assert_level_equal(
            t_eng.expand(words_from_numpy(bitmaps, "cpu"), left, right,
                         sup_left, mode=0, min_sup=ms),
            j_eng.expand(jnp.asarray(bitmaps), left, right, sup_left,
                         mode=0, min_sup=ms))
    t_stats, j_stats = t_eng.stats(), j_eng.stats()
    for key in ("n_intersections", "n_padded", "pair_padding"):
        assert t_stats[key] == j_stats[key]


@pytest.mark.parametrize("floor", [1, 8, 100, 128])
def test_bucket_ladder_matches_reference(floor):
    for n in range(0, 2000, 7):
        assert teng.bucket_size(n, floor) == jeng.bucket_size(n, floor)


def test_pair_buffers_reuse_rungs():
    bufs = teng.PairBuffers(8)
    qb, block = bufs.fill(np.arange(5), np.arange(5) + 1, np.full(5, 9))
    assert qb == 8 and block.shape == (3, 8)
    np.testing.assert_array_equal(block[:, 5:], 0)
    qb2, block2 = bufs.fill(np.arange(7), np.arange(7), np.arange(7))
    assert qb2 == 8 and block2 is block


def test_out_of_range_pairs_are_refused_on_the_host():
    bitmaps, left, right, sup_left = _case(5, 3, 13, seed=0)
    right[3] = 5
    eng = teng.make_engine("fused")
    with pytest.raises(ValueError, match="outside the 5-row frontier"):
        eng.expand(words_from_numpy(bitmaps, "cpu"), left, right, sup_left,
                   mode=0, min_sup=1)
    assert eng.n_intersections == 0


@pytest.mark.parametrize("name", ["auto", "batched", "sharded", "tidsharded", "grid"])
def test_unported_backends_raise_not_implemented(name, tmp_path):
    if name in ("sharded", "tidsharded", "grid"):
        # ported: a mesh backend needs a mesh, as in the reference
        with pytest.raises(ValueError, match="requires a mesh"):
            teng.make_engine(name)
        return
    # ported with measured dispatch: as in the reference, "auto" and
    # "batched" are names of resolve_engine, not backends; with no table
    # both resolve to the default (fused here, pallas there)
    with pytest.raises(ValueError, match="unknown engine backend"):
        teng.make_engine(name)
    with pytest.raises(ValueError, match="unknown engine backend"):
        jeng.make_engine(name)
    nope = str(tmp_path / "nope.json")
    got = teng.resolve_engine(name, policy_path=nope, hints=(100, 16))
    want = jeng.resolve_engine(name, policy_path=nope, hints=(100, 16))
    assert (got.name, want.name) == ("fused", "pallas")
    assert got.dispatch == want.dispatch == {
        "requested": name, "auto": name == "auto", "policy": None}


def test_unknown_backend_is_a_value_error():
    with pytest.raises(ValueError, match="available"):
        teng.make_engine("pallas")
    assert teng.available_backends() == ["fused", "grid", "ref", "sharded",
                                         "tidsharded"]


def test_empty_expansion_keeps_device_and_width():
    bitmaps = torch.zeros((4, 6), dtype=torch.int32)
    res = teng.make_engine("fused").expand(
        bitmaps, np.zeros(0, np.int32), np.zeros(0, np.int32),
        np.zeros(0, np.int32), mode=0, min_sup=1)
    assert res.mask.shape == (0,) and res.supports.shape == (0,)
    assert res.bitmaps.shape == (0, 6) and res.bitmaps.device == bitmaps.device
