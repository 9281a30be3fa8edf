"""Property tests of the port's serializable state (DESIGN.md §10), the
reference's ``tests/test_state_property.py`` through
``tests/_hypothesis_compat.py``, on the CPU: snapshot -> tree -> state ->
miner -> snapshot is a fixed point, the disk encoding through
``training.checkpoint`` loses nothing, a snapshot cut at any point of a
random stream restores under the other single-device backend bit-exactly,
and a state crosses between the packages (through the on-disk names) to
equal trees and equal next windows.  Exact comparisons throughout.
"""
import tempfile

import numpy as np
from _hypothesis_compat import given, settings, st

from repro.streaming import MinerState as JMinerState
from repro.streaming import StreamConfig as JStreamConfig
from repro.streaming import StreamingMiner as JMiner

from repro_torch.streaming import (MinerState, RingState, StreamConfig,
                                   StreamingMiner, WindowRing)
from repro_torch.streaming.persist import FROM_REFERENCE, TO_REFERENCE, _renamed
from repro_torch.training import load_checkpoint, save_checkpoint

N_ITEMS = 10

batches_strategy = st.lists(
    st.lists(st.lists(st.integers(0, N_ITEMS - 1), min_size=0, max_size=5),
             min_size=1, max_size=20),
    min_size=1, max_size=4,
)


def _cfg(backend, min_sup):
    return StreamConfig(min_sup=min_sup, n_blocks=2, block_txns=32,
                        backend=backend, bucket_min=16)


def _clean(batches):
    return [[sorted(set(t)) for t in b] for b in batches]


def _miner_with(batches, cfg, keep_transactions=False):
    miner = StreamingMiner(N_ITEMS, cfg, keep_transactions=keep_transactions,
                           device="cpu")
    for b in batches:
        miner.advance(b)
    return miner


def _assert_trees_equal(a, b):
    (ta, ea), (tb, eb) = a, b
    assert set(ta) == set(tb), (sorted(ta), sorted(tb))
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
        assert np.asarray(ta[k]).dtype == np.asarray(tb[k]).dtype, k
    assert ea == eb


@settings(max_examples=8, deadline=None)
@given(batches_strategy, st.integers(1, 8), st.booleans())
def test_property_snapshot_roundtrip_is_identity(batches, min_sup, keep):
    batches = _clean(batches)
    miner = _miner_with(batches, _cfg("ref", min_sup), keep_transactions=keep)
    state = miner.snapshot_state()
    rebuilt = MinerState.from_tree(*state.to_tree())
    _assert_trees_equal(state.to_tree(), rebuilt.to_tree())
    again = StreamingMiner.from_state(rebuilt, device="cpu").snapshot_state()
    _assert_trees_equal(state.to_tree(), again.to_tree())


@settings(max_examples=8, deadline=None)
@given(batches_strategy, st.integers(1, 8))
def test_property_ring_state_roundtrip(batches, min_sup):
    batches = _clean(batches)
    miner = _miner_with(batches, _cfg("ref", min_sup), keep_transactions=True)
    state = miner.ring.snapshot_state()
    rebuilt = RingState.from_tree(*state.to_tree())
    _assert_trees_equal(state.to_tree(), rebuilt.to_tree())
    assert rebuilt.txns == state.txns
    ring = WindowRing.from_state(rebuilt, device="cpu")
    ring.validate()
    assert ring.window_transactions() == miner.window_transactions()


@settings(max_examples=6, deadline=None)
@given(batches_strategy, st.integers(1, 8))
def test_property_disk_roundtrip_lossless(batches, min_sup):
    batches = _clean(batches)
    miner = _miner_with(batches, _cfg("fused", min_sup))
    state = miner.snapshot_state()
    tree, extra = state.to_tree()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree, extra=extra)
        flat, manifest = load_checkpoint(d, 1)
    rebuilt = MinerState.from_tree(flat, manifest["extra"])
    _assert_trees_equal((tree, extra), rebuilt.to_tree())
    restored = StreamingMiner.from_state(rebuilt, device="cpu")
    assert (restored.mine_window().support_map()
            == miner.mine_window().support_map())


@settings(max_examples=6, deadline=None)
@given(batches_strategy, st.integers(1, 8), st.sampled_from(("ref", "fused")),
       st.sampled_from(("ref", "fused")), st.integers(0, 3))
def test_property_cross_backend_restore_bit_exact(batches, min_sup, src, dst,
                                                  cut_frac):
    batches = _clean(batches)
    cut = min(cut_frac, len(batches) - 1)
    head, tail = batches[:cut + 1], batches[cut + 1:]
    state = _miner_with(head, _cfg(src, min_sup)).snapshot_state()
    restored = StreamingMiner.from_state(state, backend=dst, device="cpu")
    ref = _miner_with(head + tail, _cfg("ref", min_sup))
    res = None
    for b in tail:
        res = restored.advance(b)
    if res is None:
        res = restored.mine_window()
    assert res.support_map() == ref.mine_window().support_map(), (src, dst)


@settings(max_examples=6, deadline=None)
@given(batches_strategy, st.integers(1, 8), st.booleans(),
       st.sampled_from(("ref", "fused")))
def test_property_state_crosses_between_the_packages(batches, min_sup, keep,
                                                     backend):
    """The reference's state, with the on-disk backend names mapped, is the
    port's state, leaf for leaf, and the other way round; each package's
    miner rebuilt from the other's state mines the same next window."""
    batches = _clean(batches)
    j_backend = TO_REFERENCE[backend]
    j_miner = JMiner(N_ITEMS, JStreamConfig(min_sup=min_sup, n_blocks=2,
                                            block_txns=32, backend=j_backend,
                                            bucket_min=16),
                     keep_transactions=keep)
    for b in batches:
        j_miner.advance(b)
    miner = _miner_with(batches, _cfg(backend, min_sup), keep_transactions=keep)
    j_tree, j_extra = j_miner.snapshot_state().to_tree()
    tree, extra = miner.snapshot_state().to_tree()
    _assert_trees_equal((tree, _renamed(extra, TO_REFERENCE)), (j_tree, j_extra))
    into_port = MinerState.from_tree(j_tree, _renamed(j_extra, FROM_REFERENCE))
    into_ref = JMinerState.from_tree(tree, _renamed(extra, TO_REFERENCE))
    got = StreamingMiner.from_state(into_port, device="cpu").mine_window()
    want = JMiner.from_state(into_ref).mine_window()
    assert got.support_map() == want.support_map()
    assert got.version == want.version == len(batches)
