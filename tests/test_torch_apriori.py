"""The port's Spark-Apriori baseline against the reference package's, on the
CPU: the same inputs through ``repro.core.apriori_mine`` and
``repro_torch.core.apriori_mine(device="cpu")`` give equal support maps and
level counts, and the port's Apriori equals the port's Eclat and the
brute-force oracle.  Mining is integer arithmetic: every comparison is
exact.  ``tests/test_apriori.py`` (the reference's own tests) is the
checklist.
"""
import numpy as np
import pytest
import torch

from repro.core import apriori_mine as j_apriori
from repro.core import bruteforce_fim as j_bruteforce
from repro.data import generate as j_generate

from repro_torch.core import (EclatConfig, apriori_mine, bruteforce_fim, mine,
                              support_checksum)
from repro_torch.core.apriori import _containment_counts


def make_db(seed=7, n_items=10, n_txn=150, base=(0, 1, 2, 3)):
    rng = np.random.default_rng(seed)
    txns = []
    for _ in range(n_txn):
        t = set(rng.choice(n_items, size=rng.integers(3, 7), replace=False).tolist())
        if rng.random() < 0.5:
            t |= set(base)
        txns.append(sorted(t))
    return txns


DB = make_db()
ORACLE20 = j_bruteforce(DB, min_sup=20)


def _both(txns, n_items, min_sup, **kw):
    got = apriori_mine(txns, n_items, min_sup, device="cpu", **kw)
    want = j_apriori(txns, n_items, min_sup, **kw)
    assert got.support_map == want.support_map
    assert got.counts == want.counts
    return got, want


@pytest.mark.parametrize("max_k", [1, 2, 3, None])
def test_max_k_boundaries_match_reference(max_k):
    got, _ = _both(DB, 10, 20, max_k=max_k)
    expect = {k: v for k, v in ORACLE20.items()
              if max_k is None or len(k) <= max_k}
    assert got.support_map == expect
    if max_k is not None:
        assert len(got.counts) <= max_k


@pytest.mark.parametrize("max_k", [1, 2, 3, None])
def test_max_k_matches_the_ports_eclat(max_k):
    ap = apriori_mine(DB, 10, 20, max_k=max_k, device="cpu")
    ec = mine(DB, 10, EclatConfig(min_sup=20, variant="v4", p=3, max_k=max_k),
              device="cpu")
    assert ap.support_map == ec.support_map()
    assert ap.counts == ec.counts and ap.total == ec.total


@pytest.mark.parametrize("kw,match", [
    (dict(max_k=0), "max_k"), (dict(max_k=-1), "max_k"),
    (dict(cand_chunk=0), "cand_chunk"), (dict(cand_chunk=-3), "cand_chunk")])
def test_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match) as got:
        apriori_mine(DB, 10, 20, device="cpu", **kw)
    with pytest.raises(ValueError, match=match) as want:
        j_apriori(DB, 10, 20, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cand_chunk", [1, 7, 8192])
def test_chunked_counting_does_not_change_the_answer(cand_chunk):
    got, _ = _both(DB, 10, 20, cand_chunk=cand_chunk)
    assert got.support_map == ORACLE20


@pytest.mark.parametrize("txns,n_items", [
    ([], 8),                                  # empty database
    ([[], [], []], 8),                        # all-empty transactions
    ([[0], [0], []], 1),                      # singleton item universe
    ([[0]], 1),                               # one txn, one item
    ([[1, 3], [1, 3], [1, 3]], 5),            # every itemset ties at n_txn
])
def test_degenerate_databases(txns, n_items):
    got, _ = _both(txns, n_items, 1)
    ec = mine(txns, n_items, EclatConfig(min_sup=1, variant="v4", p=3),
              device="cpu")
    assert got.support_map == ec.support_map() and got.total == ec.total


@pytest.mark.parametrize("min_sup", [1.0, 0.5, 2, 20, 0.13])
def test_fraction_and_count_thresholds(min_sup):
    got, want = _both(DB, 10, min_sup)
    assert got.stats["abs_min_sup"] == want.stats["abs_min_sup"]
    ec = mine(DB, 10, EclatConfig(min_sup=min_sup, variant="v4", p=3), device="cpu")
    assert got.stats["abs_min_sup"] == ec.stats["abs_min_sup"]


@pytest.mark.parametrize("bad", [0, -1, 1.5, True])
def test_bad_min_sup_is_refused_like_the_reference(bad):
    with pytest.raises((ValueError, TypeError)) as got:
        apriori_mine(DB, 10, bad, device="cpu")
    with pytest.raises((ValueError, TypeError)) as want:
        j_apriori(DB, 10, bad)
    assert type(got.value) is type(want.value)


@pytest.mark.parametrize("name,scale,min_sup", [
    ("chess", 0.03, 0.9), ("mushroom", 0.05, 0.5), ("T10I4D100K", 0.005, 0.02),
    ("BMS_WebView_1", 0.02, 0.01)])
def test_apriori_equals_eclat_on_synthetic_sets(name, scale, min_sup):
    """The paper's comparison: both algorithms find the same itemsets, and
    both packages' Apriori agree."""
    txns, spec = j_generate(name, scale=scale, seed=2)
    got, _ = _both(txns, spec.n_items, min_sup)
    ec = mine(txns, spec.n_items, EclatConfig(min_sup=min_sup, variant="v4"),
              device="cpu")
    assert got.support_map == ec.support_map()
    assert support_checksum(got.support_map) == support_checksum(ec.support_map())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bruteforce_on_a_tiny_database(seed):
    rng = np.random.default_rng(seed)
    txns = [sorted(set(rng.integers(0, 8, rng.integers(1, 6)).tolist()))
            for _ in range(40)]
    got = apriori_mine(txns, 8, 4, device="cpu")
    assert got.support_map == bruteforce_fim(txns, 4) == j_bruteforce(txns, min_sup=4)


def test_stats_keys_are_the_references_and_the_device():
    got, want = _both(DB, 10, 20)
    assert set(got.stats) == set(want.stats) | {"device"}
    assert got.stats["device"] == "cpu"
    assert len(got.stats["level_s"]) == len(want.stats["level_s"])
    assert got.stats["n_freq_items"] == want.stats["n_freq_items"]


def test_containment_counts_are_exact_in_float32():
    """The (n_txn x n1) @ (n1 x Q) product counts containment exactly: each
    candidate's count equals a direct count over the transactions, at a
    width where a float16 sum would round (n1 = 3,000 items in one
    transaction set)."""
    rng = np.random.default_rng(3)
    n_txn, n1 = 64, 3000
    dense = (rng.random((n_txn, n1)) < 0.97).astype(np.float32)
    txn = torch.from_numpy(dense)
    chunk = np.stack([rng.choice(n1, 2500, replace=False) for _ in range(5)])
    got = _containment_counts(txn, chunk.astype(np.int64), 2500)
    want = [int(dense[:, c].all(axis=1).sum()) for c in chunk]
    assert got.tolist() == want


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apriori_mine(DB, 10, 20)
