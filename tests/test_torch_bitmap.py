"""The port's host data layer against the reference package: packing, the
word convention, popcount, the vertical DB under every variant, and the
dataset generators — bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import bitmap as jbm
from repro.core import eclat as jeclat
from repro.core.accumulator import build_vertical_accumulated as j_build_acc
from repro.core.vertical import build_vertical as j_build
from repro.core.vertical import filter_transactions as j_filter
from repro.data import synthetic as jsyn

from repro_torch import device as tdev
from repro_torch.core import bitmap as tbm
from repro_torch.core import eclat as teclat
from repro_torch.core.accumulator import build_vertical_accumulated as t_build_acc
from repro_torch.core.vertical import build_vertical as t_build
from repro_torch.core.vertical import filter_transactions as t_filter
from repro_torch.data import synthetic as tsyn

from test_eclat_correctness import make_db

DB = make_db()


def _rand_words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)


@pytest.mark.parametrize("n_txn", [0, 1, 31, 32, 33, 150, 1000])
def test_pack_transactions_bit_exact(n_txn):
    rng = np.random.default_rng(n_txn)
    txns = [sorted(set(rng.integers(0, 12, rng.integers(0, 6)).tolist()))
            for _ in range(n_txn)]
    np.testing.assert_array_equal(tbm.pack_transactions(txns, 12),
                                  jbm.pack_transactions(txns, 12))


def test_pack_transactions_rejects_out_of_range_item():
    with pytest.raises(ValueError, match="txn 1 has item"):
        tbm.pack_transactions([[0, 1], [2, 9]], 5)


@pytest.mark.parametrize("n_items,n_txn", [(3, 1), (7, 64), (5, 70), (0, 10)])
def test_pack_bool_matrix_and_unpack(n_items, n_txn):
    dense = np.random.default_rng(n_txn).random((n_items, n_txn)) < 0.4
    packed = tbm.pack_bool_matrix(dense)
    np.testing.assert_array_equal(packed, jbm.pack_bool_matrix(dense))
    np.testing.assert_array_equal(tbm.unpack_bitmap(packed, n_txn),
                                  jbm.unpack_bitmap(packed, n_txn))


def test_column_compact_matches_reference():
    words = _rand_words((6, 5), 3)
    keep = np.random.default_rng(4).random(150) < 0.6
    got, k = tbm.column_compact(words, 150, keep)
    want, kw = jbm.column_compact(words, 150, keep)
    assert k == kw
    np.testing.assert_array_equal(got, want)


def test_word_convention_round_trip():
    words = _rand_words((7, 9), 5)
    t = tdev.words_from_numpy(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(tdev.words_to_numpy(t), words)
    words[0, 0] ^= 1        # the tensor is a copy
    assert tdev.words_to_numpy(t)[0, 0] != words[0, 0]


def test_popcount_words_all_bit_patterns():
    """SWAR on int32 with its arithmetic shifts: sign bit set, all ones,
    powers of two and random words all count like numpy's uint32."""
    special = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA,
                        0x55555555, 0xF0F0F0F0] + [1 << i for i in range(32)],
                       np.uint32)
    words = np.concatenate([special, _rand_words(4096, 6)])
    got = tdev.popcount_words(tdev.words_from_numpy(words, "cpu"))
    np.testing.assert_array_equal(got.numpy(), jbm.popcount_np(words))


def test_row_support_matches_support_np():
    words = _rand_words((13, 40), 7)
    got = tbm.support(tdev.words_from_numpy(words, "cpu"))
    np.testing.assert_array_equal(got.numpy(), jbm.support_np(words))


def _db_equal(a, b):
    np.testing.assert_array_equal(a.bitmaps, b.bitmaps)
    np.testing.assert_array_equal(a.items, b.items)
    np.testing.assert_array_equal(a.supports, b.supports)
    assert (a.n_txn, a.order) == (b.n_txn, b.order)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4", "v5", "v6"])
@pytest.mark.parametrize("min_sup", [20, 35, 60])
def test_vertical_db_bit_exact_under_variant_flags(variant, min_sup):
    """The same VerticalDB (words, items, supports) under each variant's
    spec flags on the correctness-suite database — and through the int32
    word view the port carries on the device."""
    spec_t, spec_j = teclat.VARIANTS[variant], jeclat.VARIANTS[variant]
    assert spec_t == spec_j
    got, info_t = teclat._build_db(DB, 10, min_sup, spec_t)
    want, info_j = jeclat._build_db(DB, 10, min_sup, spec_j, None)
    _db_equal(got, want)
    assert info_t == info_j
    t = tdev.words_from_numpy(got.bitmaps, "cpu")
    np.testing.assert_array_equal(t.numpy(), want.bitmaps.view(np.int32))


@pytest.mark.parametrize("order", ["support_asc", "lex"])
def test_build_paths_bit_exact(order):
    for build_t, build_j in ((t_build, j_build), (t_build_acc, j_build_acc)):
        got = build_t(DB, 10, 30, order=order)
        want = build_j(DB, 10, 30, order=order)
        _db_equal(got, want)
        _db_equal(t_filter(got), j_filter(want))
    got.validate()


def test_accumulator_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        t_build_acc(DB, 10, 30, mesh=object())


@pytest.mark.parametrize("name", sorted(jsyn.PAPER_DATASETS))
def test_generators_draw_identical_transactions(name):
    got, spec_t = tsyn.generate(name, scale=0.005, seed=3)
    want, spec_j = jsyn.generate(name, scale=0.005, seed=3)
    assert got == want
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)


def test_accumulator_rejects_out_of_range_items():
    """The v3 accumulator shares the validated scatter of pack_transactions
    (the reference's per-transaction loop wrapped negative ids)."""
    for bad in ([[0, 1], [2, 10]], [[0, -1]]):
        with pytest.raises(ValueError, match="has item outside"):
            t_build_acc(bad, 10, 1)
