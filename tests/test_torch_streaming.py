"""The port's sliding-window miner against the reference package's, on the
CPU: the same seeded micro-batches go through the reference's ``jnp`` and
``pallas`` (interpret) miners and the port's ``ref`` and ``fused`` miners on
``device="cpu"``, slide for slide.

Every comparison is exact (support maps, co-occurrence counts, ring words,
class churn, engine accounting, answers): mining is integer arithmetic, so
the tolerance is zero.  ``tests/test_streaming.py`` (the reference's own
tests) is the checklist; the mesh streams are in ``test_torch_mesh.py`` and
the card's in ``test_torch_cuda.py``.
"""
import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.triangular import cooccurrence_counts as j_cooc
from repro.data import transaction_stream as j_transaction_stream
from repro.dist.compat import make_mesh
from repro.faults import clear_kill_hook as j_clear_hook
from repro.faults import set_kill_hook as j_set_hook
from repro.launch import stream as j_stream_cli
from repro.serving import ItemsetQuery as JQuery
from repro.serving import StreamQueryService as JService
from repro.serving import pack_queries as j_pack_queries
from repro.streaming import StreamConfig as JStreamConfig
from repro.streaming import StreamingMiner as JMiner
from repro.streaming import WindowRing as JRing

from repro_torch.core import EclatConfig, mine, support_checksum
from repro_torch.core.bitmap import support_np
from repro_torch.core.triangular import cooccurrence_counts
from repro_torch.data import stream_spec, transaction_stream
from repro_torch.device import words_from_numpy, words_to_numpy
from repro_torch.faults import InjectedFault, clear_kill_hook, set_kill_hook
from repro_torch.launch import stream as stream_cli
from repro_torch.launch.stream_profile import STREAMS
from repro_torch.serving import ItemsetQuery, StreamQueryService, pack_queries
from repro_torch.streaming import StreamConfig, StreamingMiner, WindowRing

from test_streaming import N_ITEMS, _batches

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BACKENDS = ["ref", "fused"]
# the reference's name for each of the port's single-device backends
J_BACKEND = {"ref": "jnp", "fused": "pallas"}


def _pair(n_items, backend="ref", mesh=None, **cfg):
    """The port's miner on the host and the reference's, on one config."""
    got = StreamingMiner(n_items, StreamConfig(backend=backend, **cfg),
                         device="cpu")
    want = JMiner(n_items, JStreamConfig(backend=J_BACKEND[backend], **cfg),
                  mesh=mesh)
    return got, want


SLIDE_STATS = ("abs_min_sup", "classes", "window", "window_version",
               "n_intersections", "n_padded", "pair_padding",
               "device_balance")


def _assert_same_slide(got, want, what=""):
    assert got.support_map() == want.support_map(), what
    assert got.counts == want.counts, what
    assert (got.n_txn, got.version) == (want.n_txn, want.version), what
    for key in SLIDE_STATS:
        assert got.stats.get(key) == want.stats.get(key), (what, key)


# ---------------------------------------------------------------------------
# WindowRing mechanics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [WindowRing, JRing], ids=["port", "reference"])
def test_ring_geometry_validation(make):
    kw = {"device": "cpu"} if make is WindowRing else {}
    with pytest.raises(ValueError, match="multiple of 32"):
        make(N_ITEMS, n_blocks=2, block_txns=33, **kw)
    with pytest.raises(ValueError, match="multiple of 32"):
        make(N_ITEMS, n_blocks=2, block_txns=0, **kw)
    with pytest.raises(ValueError, match="at least one block"):
        make(N_ITEMS, n_blocks=0, block_txns=32, **kw)
    ring = make(N_ITEMS, n_blocks=2, block_txns=32, **kw)
    with pytest.raises(ValueError, match="exceeds block capacity"):
        ring.push([[0]] * 33)


@pytest.mark.parametrize("n_blocks,block_txns,batch_txns",
                         [(3, 32, 20), (2, 64, 64), (4, 96, 50)])
def test_ring_fill_evict_and_order_match_reference(n_blocks, block_txns, batch_txns):
    got = WindowRing(N_ITEMS, n_blocks, block_txns, device="cpu")
    want = JRing(N_ITEMS, n_blocks, block_txns)
    batches = _batches(n_blocks + 3, batch_txns, seed=1)
    for i, b in enumerate(batches):
        g_new, g_old, g_ev = got.push(b)
        w_new, w_old, w_ev = want.push(b)
        got.validate()
        assert np.array_equal(g_new, w_new) and g_new.dtype == np.uint32
        assert np.array_equal(g_old, w_old) and g_ev == w_ev
        if i < n_blocks:
            assert g_ev == 0 and not g_old.any()
        else:
            assert g_ev == batch_txns and g_old.any()
        assert np.array_equal(got.words, want.words)
        assert np.array_equal(words_to_numpy(got.device), np.asarray(want.device))
        assert got.device.dtype == torch.int32
        assert (got.n_txn, got.full, got.head, got.filled) == \
            (want.n_txn, want.full, want.head, want.filled)
        assert got.n_txn == min(i + 1, n_blocks) * batch_txns
    # live window = the newest n_blocks batches, oldest first
    expect = [list(t) for b in batches[-n_blocks:] for t in b]
    assert got.window_transactions() == expect == want.window_transactions()


def test_ring_partial_batches_pad_with_zero_columns():
    got = WindowRing(N_ITEMS, n_blocks=2, block_txns=64, device="cpu")
    want = JRing(N_ITEMS, n_blocks=2, block_txns=64)
    b = _batches(1, 10, seed=2)[0]
    got.push(b)
    want.push(b)
    assert got.n_txn == 10
    # zero pad columns contribute no support
    assert support_np(got.words).sum() == sum(len(set(t)) for t in b)
    assert np.array_equal(got.words, want.words)
    assert np.array_equal(words_to_numpy(got.device), np.asarray(want.device))


def test_ring_without_transactions_refuses_window_transactions():
    ring = WindowRing(N_ITEMS, 2, 32, keep_transactions=False, device="cpu")
    ring.push(_batches(1, 5, seed=3)[0])
    with pytest.raises(RuntimeError, match="keep_transactions=False"):
        ring.window_transactions()


def test_ring_push_writes_in_place():
    """The device ring is one tensor for the life of the ring: a push
    writes the block's span, it never re-uploads the ring."""
    ring = WindowRing(N_ITEMS, 3, 32, device="cpu")
    before = ring.device
    ptr = ring.device.data_ptr()
    for b in _batches(5, 20, seed=4):
        ring.push(b)
    assert ring.device is before and ring.device.data_ptr() == ptr


class _FakeMesh:
    """A one-axis mesh as ``dist.sharding`` reads it, seen from ``rank`` of
    ``n`` ranks on ``data``: the word-sharded ring without a process group."""
    mesh_dim_names = ("data",)

    def __init__(self, n, rank):
        self.n, self.rank = n, rank

    def size(self, dim=None):
        return self.n

    def get_local_rank(self, axis=None):
        return self.rank


@pytest.mark.parametrize("n_ranks", [2, 3, 4])
@pytest.mark.parametrize("n_blocks,block_txns", [(3, 32), (5, 64), (2, 96)])
def test_word_sharded_ring_slices_match_reference(n_ranks, n_blocks, block_txns):
    """Each rank's ring is the slice ``shard_words`` cuts of the reference's
    word-sharded ring, push for push, with spans that straddle two ranks
    and zero pad words on the last rank (n_blocks * wpb is no multiple of
    the rank count in most cases); every rank validates."""
    if n_ranks == 3:
        mesh = None         # the reference's ring on 4 devices is another cut
        want = JRing(N_ITEMS, n_blocks, block_txns)
    else:
        mesh = make_mesh((n_ranks,), ("data",), devices=jax.devices()[:n_ranks])
        want = JRing(N_ITEMS, n_blocks, block_txns, mesh=mesh)
    rings = [WindowRing(N_ITEMS, n_blocks, block_txns, device="cpu",
                        mesh=_FakeMesh(n_ranks, r)) for r in range(n_ranks)]
    wpb = block_txns // 32
    n_words = n_blocks * wpb
    ws = -(-n_words // n_ranks)
    for b in _batches(n_blocks + 2, block_txns - 3, seed=n_ranks + n_blocks):
        for ring in rings:
            ring.push(b)
            ring.validate()
        want.push(b)
        padded = np.zeros((N_ITEMS, ws * n_ranks), np.uint32)
        padded[:, :n_words] = want.words
        for r, ring in enumerate(rings):
            assert ring.device.shape == (N_ITEMS, ws)
            assert (ring.word_lo, ring.local_words, ring.n_words_dev) == \
                (r * ws, ws, ws * n_ranks)
            assert np.array_equal(ring.words, want.words)
            assert np.array_equal(words_to_numpy(ring.device),
                                  padded[:, r * ws:(r + 1) * ws])
        if mesh is not None:
            assert np.array_equal(
                np.concatenate([words_to_numpy(x.device) for x in rings], axis=1),
                np.asarray(want.device))


def test_ring_validate_raises_on_divergence():
    ring = WindowRing(N_ITEMS, n_blocks=2, block_txns=32, device="cpu")
    ring.push(_batches(1, 20, seed=13)[0])
    ring.validate()
    ring.words[0, 0] ^= np.uint32(1)            # corrupt the host mirror
    with pytest.raises(RuntimeError, match="diverged"):
        ring.validate()
    ring.words[0, 0] ^= np.uint32(1)
    ring.device[3, 1] ^= 4                      # corrupt the device ring
    with pytest.raises(RuntimeError, match="diverged"):
        ring.validate()
    ring.device[3, 1] ^= 4
    ring.validate()
    ring.block_counts[0] = -1                   # corrupt the occupancy
    with pytest.raises(RuntimeError, match="block_counts"):
        ring.validate()
    ring.block_counts[0] = 0                    # support > live txns in slot
    with pytest.raises(RuntimeError, match="live transactions"):
        ring.validate()


def test_sharded_ring_validate_catches_set_pad_words():
    """n_words = 3 over 2 ranks: the last rank's second word is padding."""
    ring = WindowRing(N_ITEMS, 3, 32, device="cpu", mesh=_FakeMesh(2, 1))
    ring.push(_batches(1, 20, seed=14)[0])
    ring.validate()
    ring.device[0, 1] = 1
    with pytest.raises(RuntimeError, match="shard-padding words"):
        ring.validate()


# ---------------------------------------------------------------------------
# incremental state: supports + co-occurrence counts stay exact across slides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_incremental_state_matches_reference_and_recompute(backend):
    got, want = _pair(N_ITEMS, backend, min_sup=2, n_blocks=3, block_txns=32)
    for b in _batches(6, 24, seed=3):
        g, w = got.push(b), want.push(b)
        assert (g["n_admitted"], g["n_evicted"]) == (w["n_admitted"], w["n_evicted"])
        assert got.cooc.dtype == np.int64
        assert np.array_equal(got.cooc, want.cooc)
        np.testing.assert_array_equal(got.supports, support_np(got.ring.words))
        full = cooccurrence_counts(words_from_numpy(got.ring.words, "cpu"))
        np.testing.assert_array_equal(got.cooc, full.astype(np.int64))
        np.testing.assert_array_equal(
            got.cooc, j_cooc(jnp.asarray(want.ring.words)).astype(np.int64))
        assert got.window_version == want.window_version


# ---------------------------------------------------------------------------
# parity: windowed == the reference's miner == batch mine() over the window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_windowed_matches_reference_and_batch_mine(backend):
    got, want = _pair(N_ITEMS, backend, min_sup=5, n_blocks=3, block_txns=32,
                      bucket_min=16)
    for i, batch in enumerate(_batches(6, 28, seed=4)):
        g, w = got.advance(batch), want.advance(batch)
        _assert_same_slide(g, w, f"slide {i}")
        window = got.window_transactions()
        assert window == want.window_transactions()
        batch_res = mine(window, N_ITEMS,
                         EclatConfig(min_sup=5, variant="v4", p=4,
                                     backend=backend, bucket_min=16),
                         device="cpu")
        assert g.n_txn == len(window)
        assert g.support_map() == batch_res.support_map(), f"slide {i}"
        assert g.stats["phase_s"].keys() == {"level2", "bottom_up"}
        assert {"push_s", "slide_s", "n_admitted", "n_evicted"} <= g.stats.keys()
    assert got.engine.name == backend


@pytest.mark.parametrize("min_sup", [0.2, 0.5, 3])
def test_windowed_matches_reference_fractional_min_sup(min_sup):
    """Fractional min_sup resolves against the live window txn count."""
    got, want = _pair(N_ITEMS, "fused", min_sup=min_sup, n_blocks=2,
                      block_txns=32)
    for batch in _batches(4, 20, seed=5):
        g, w = got.advance(batch), want.advance(batch)
        _assert_same_slide(g, w)
        batch_res = mine(got.window_transactions(), N_ITEMS,
                         EclatConfig(min_sup=min_sup), device="cpu")
        assert g.stats["abs_min_sup"] == batch_res.stats["abs_min_sup"]
        assert g.support_map() == batch_res.support_map()


def test_windowed_parity_on_paper_stream():
    """A real T10-shaped stream (sparse, wide universe) stays bit-exact."""
    spec = stream_spec("T10I4D100K")
    cfg = dict(min_sup=0.02, n_blocks=2, block_txns=128)
    got = StreamingMiner(spec.n_items, StreamConfig(**cfg), device="cpu")
    want = JMiner(spec.n_items, JStreamConfig(backend="jnp", **cfg))
    for batch in transaction_stream("T10I4D100K", 128, 4, seed=6):
        g, w = got.advance(batch), want.advance(batch)
        _assert_same_slide(g, w)
        batch_res = mine(got.window_transactions(), spec.n_items,
                         EclatConfig(min_sup=0.02), device="cpu")
        assert g.support_map() == batch_res.support_map()
        assert np.array_equal(got.cooc, want.cooc)


def _drift_batches():
    rng = np.random.default_rng(7)
    out = []
    for i in range(6):
        # regime flips halfway: items 10..19 replace items 0..9
        lo = 0 if i < 3 else 10
        out.append([sorted(set(rng.choice(range(lo, lo + 10), size=4).tolist()))
                    for _ in range(40)])
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_class_churn_under_drift_matches_reference(backend):
    got, want = _pair(20, backend, min_sup=6, n_blocks=2, block_txns=64)
    entered = exited = 0
    for batch in _drift_batches():
        g, w = got.advance(batch), want.advance(batch)
        assert g.stats["classes"] == w.stats["classes"]
        _assert_same_slide(g, w)
        entered += g.stats["classes"]["n_entered"]
        exited += g.stats["classes"]["n_exited"]
    assert entered > 0 and exited > 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("max_k", [1, 2, 3, None])
def test_streaming_max_k_matches_reference_and_batch(backend, max_k):
    got, want = _pair(N_ITEMS, backend, min_sup=5, n_blocks=2, block_txns=32,
                      max_k=max_k, bucket_min=16)
    for batch in _batches(3, 28, seed=4):
        g, w = got.advance(batch), want.advance(batch)
        _assert_same_slide(g, w)
        batch_res = mine(got.window_transactions(), N_ITEMS,
                         EclatConfig(min_sup=5, backend="ref", max_k=max_k,
                                     bucket_min=16), device="cpu")
        assert g.support_map() == batch_res.support_map()
        if max_k is not None:
            assert len(g.counts) <= max_k


def test_streaming_max_k_validation():
    for make in (lambda c: StreamingMiner(N_ITEMS, StreamConfig(**c), device="cpu"),
                 lambda c: JMiner(N_ITEMS, JStreamConfig(**c))):
        miner = make(dict(min_sup=5, n_blocks=2, block_txns=32, max_k=0))
        miner.push(_batches(1, 20, seed=3)[0])
        with pytest.raises(ValueError, match="max_k must be >= 1"):
            miner.mine_window()


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_slide_engine_stats_are_deltas(backend):
    """stats['n_intersections'] is this slide's work, not the lifetime total
    of the miner's persistent engine — slide for slide the reference's."""
    got, want = _pair(N_ITEMS, backend, min_sup=5, n_blocks=2, block_txns=32)
    per_slide = []
    for b in _batches(4, 28, seed=11):
        g, w = got.advance(b), want.advance(b)
        for key in ("n_intersections", "n_padded", "pair_padding"):
            assert g.stats[key] == w.stats[key], key
        per_slide.append(g.stats["n_intersections"])
    assert sum(per_slide) == got.engine.n_intersections
    assert all(c > 0 for c in per_slide)
    # the lifetime view without ``since`` is the sum of the slides
    assert got.engine.stats()["n_intersections"] == sum(per_slide)
    snap = got.engine.snapshot()
    assert got.engine.stats(since=snap)["n_intersections"] == 0
    assert "pair_padding" not in got.engine.stats(since=snap)


def test_push_mine_separately():
    """Mining on a cadence: push() N times, mine_window() once."""
    got, want = _pair(N_ITEMS, "fused", min_sup=4, n_blocks=4, block_txns=32)
    for batch in _batches(3, 20, seed=8):
        got.push(batch)
        want.push(batch)
    g, w = got.mine_window(), want.mine_window()
    _assert_same_slide(g, w)
    batch_res = mine(got.window_transactions(), N_ITEMS,
                     EclatConfig(min_sup=4), device="cpu")
    assert g.support_map() == batch_res.support_map()
    # mining again without a push: same version, same answer
    again = got.mine_window()
    assert again.version == g.version and again.support_map() == g.support_map()


def test_empty_window_and_empty_batches():
    got, want = _pair(N_ITEMS, "fused", min_sup=2, n_blocks=2, block_txns=32)
    g, w = got.mine_window(), want.mine_window()
    assert g.total == 0 and g.support_map() == {} == w.support_map()
    assert g.version == w.version == 0
    g, w = got.advance([]), want.advance([])
    assert g.total == 0 == w.total
    assert (g.version, g.n_txn) == (w.version, w.n_txn) == (1, 0)
    assert g.stats["classes"] == w.stats["classes"]


# ---------------------------------------------------------------------------
# invariant checks are real exceptions (they must survive `python -O`)
# ---------------------------------------------------------------------------

def _corrupt_and_mine(miner):
    """Items 0/1/2 are all frequent but 1 and 2 never co-occur; inflating
    the cached count makes the prefilter pass a pair the engine refutes."""
    miner.push([[0, 1]] * 8 + [[0, 2]] * 8)
    miner.cooc[1, 2] = miner.cooc[2, 1] = 50
    return miner.mine_window()


@pytest.mark.parametrize("backend", BACKENDS)
def test_cached_count_disagreement_raises_as_in_the_reference(backend):
    got, want = _pair(N_ITEMS, backend, min_sup=5, n_blocks=2, block_txns=32)
    with pytest.raises(RuntimeError, match="co-occurrence counts disagree") as g:
        _corrupt_and_mine(got)
    with pytest.raises(RuntimeError) as w:
        _corrupt_and_mine(want)
    assert str(g.value) == str(w.value)


def test_invariants_fire_under_python_O():
    """The corruption scenario in a ``python -O`` subprocess (asserts
    stripped) must still raise."""
    snippet = (
        "from repro_torch.streaming import StreamConfig, StreamingMiner\n"
        "assert False, 'proof this build strips asserts'  # -O removes this\n"
        "miner = StreamingMiner(12, StreamConfig(min_sup=5, n_blocks=2, "
        "block_txns=32), device='cpu')\n"
        "miner.push([[0, 1]] * 8 + [[0, 2]] * 8)\n"
        "miner.cooc[1, 2] = miner.cooc[2, 1] = 50\n"
        "try:\n"
        "    miner.mine_window()\n"
        "except RuntimeError as e:\n"
        "    print('RAISED:', type(e).__name__)\n"
        "else:\n"
        "    raise SystemExit('invariant did NOT fire under -O')\n"
        "miner.ring.words[0, 0] ^= 1\n"
        "try:\n"
        "    miner.ring.validate()\n"
        "except RuntimeError as e:\n"
        "    print('RAISED:', type(e).__name__)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-O", "-c", snippet],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("RAISED: RuntimeError") == 2


# ---------------------------------------------------------------------------
# kill points: the same names, in the same order, at the same state
# ---------------------------------------------------------------------------

def _kill_sequence(miner, set_hook, clear_hook, batches):
    seen = []
    set_hook(seen.append)
    try:
        miner.mine_window()                 # empty window: no deep expand
        for b in batches:
            miner.push(b)
            miner.mine_window()
        miner.advance(batches[0])
    finally:
        clear_hook()
    return seen


def test_kill_point_sequence_matches_reference():
    got, want = _pair(N_ITEMS, "fused", min_sup=5, n_blocks=2, block_txns=32)
    batches = _batches(3, 28, seed=12)
    g = _kill_sequence(got, set_kill_hook, clear_kill_hook, batches)
    w = _kill_sequence(want, j_set_hook, j_clear_hook, batches)
    assert g == w
    assert g[:3] == ["miner:mid_append", "miner:mid_evict", "miner:pre_deep_expand"]


@pytest.mark.parametrize("point", ["miner:mid_append", "miner:mid_evict",
                                   "miner:pre_deep_expand"])
def test_injected_fault_leaves_the_reference_state(point):
    """A crash at a kill point leaves the ring, the counts and the version
    exactly where the reference leaves them: the version is bumped only once
    the ring and the counts agree."""
    got, want = _pair(N_ITEMS, "fused", min_sup=5, n_blocks=2, block_txns=32)
    batches = _batches(3, 28, seed=15)

    def die(name):
        if name == point:
            raise InjectedFault(name)
    for miner, set_hook, clear_hook in ((got, set_kill_hook, clear_kill_hook),
                                        (want, j_set_hook, j_clear_hook)):
        for b in batches[:2]:
            miner.advance(b)
        set_hook(die)
        try:
            with pytest.raises(RuntimeError, match=point):
                miner.advance(batches[2])
        finally:
            clear_hook()
    assert np.array_equal(got.cooc, want.cooc)
    assert np.array_equal(got.ring.words, want.ring.words)
    assert got.window_version == want.window_version
    assert got.window_version == (2 if point != "miner:pre_deep_expand" else 3)


# ---------------------------------------------------------------------------
# the streams, the config and the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,batch_txns,n_batches,seed,drift", [
    ("T10I4D100K", 64, 5, 0, None), ("T10I4D100K", 50, 7, 3, 3),
    ("chess", 32, 6, 1, 2), ("chess", 100, 3, 0, None),
    ("mushroom", 40, 4, 2, 2), ("BMS_WebView_1", 64, 4, 5, 3)])
def test_transaction_stream_matches_reference(name, batch_txns, n_batches, seed, drift):
    got = list(transaction_stream(name, batch_txns, n_batches, seed=seed,
                                  drift_every=drift))
    want = list(j_transaction_stream(name, batch_txns, n_batches, seed=seed,
                                     drift_every=drift))
    assert got == want
    assert len(got) == n_batches and all(len(b) == batch_txns for b in got)


@pytest.fixture
def tune_caches(tmp_path, monkeypatch):
    """Both packages' autotune caches in a temporary directory, their
    in-process tables dropped around the test."""
    from repro.kernels import autotune as j_autotune
    from repro_torch.kernels import autotune
    monkeypatch.setenv(j_autotune.CACHE_ENV, str(tmp_path / "reference.json"))
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "port.json"))
    j_autotune.reset()
    autotune.reset()
    yield tmp_path
    j_autotune.reset()
    autotune.reset()


@pytest.mark.parametrize("field,value", [("block_w", 256), ("autotune", True),
                                         ("compact", False)])
def test_unported_config_raises(field, value, tune_caches):
    if field == "compact":
        # ported: the non-compacting engine (K1, the host mask, a row
        # gather) slides as the reference's miner with the same knob does,
        # on both backends
        for backend in ("ref", "fused"):
            got, want = _pair(N_ITEMS, backend, min_sup=0.05, n_blocks=2,
                              block_txns=64, **{field: value})
            assert got.engine.compact is want.engine.compact is False
            for i, batch in enumerate(_batches(4, 64, seed=13)):
                _assert_same_slide(got.advance(batch), want.advance(batch),
                                   f"{backend} slide {i}")
        return
    # ported with tile selection: the same slides as the reference's miner
    # with the same knob (256 words is one of K2's tiles at every width)
    got, want = _pair(N_ITEMS, "fused", min_sup=0.05, n_blocks=2,
                      block_txns=64, **{field: value})
    assert getattr(got.engine, field) == value
    for i, batch in enumerate(_batches(4, 64, seed=11)):
        _assert_same_slide(got.advance(batch), want.advance(batch), f"slide {i}")
    assert os.path.exists(tune_caches / "port.json") == (field == "autotune")


@pytest.mark.parametrize("backend", ["pallas", "jnp", "auto"])
def test_reference_backend_names_are_refused(backend, tune_caches):
    if backend == "auto":
        # ported: measured dispatch from each package's crossover table, the
        # same slides
        got = StreamingMiner(N_ITEMS, StreamConfig(min_sup=0.05, n_blocks=2,
                                                   block_txns=64,
                                                   backend="auto"),
                             device="cpu")
        want = JMiner(N_ITEMS, JStreamConfig(min_sup=0.05, n_blocks=2,
                                             block_txns=64, backend="auto"))
        assert got.engine.name in ("fused", "ref")
        assert got.engine.dispatch["requested"] == "auto"
        for i, batch in enumerate(_batches(3, 64, seed=12)):
            _assert_same_slide(got.advance(batch), want.advance(batch),
                               f"slide {i}")
        return
    with pytest.raises((ValueError, NotImplementedError)):
        StreamingMiner(N_ITEMS, StreamConfig(min_sup=2, backend=backend),
                       device="cpu")


def test_mesh_backend_without_a_mesh_is_single_device():
    got = StreamingMiner(N_ITEMS, StreamConfig(min_sup=5, n_blocks=2,
                                               block_txns=32, backend="tidsharded"),
                         device="cpu")
    want = JMiner(N_ITEMS, JStreamConfig(min_sup=5, n_blocks=2, block_txns=32,
                                         backend="tidsharded"))
    assert (got.engine.name, want.engine.name) == ("fused", "pallas")
    for b in _batches(3, 28, seed=16):
        assert got.advance(b).support_map() == want.advance(b).support_map()


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingMiner(N_ITEMS, StreamConfig(min_sup=2))


_SMOKE_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
CHIP_SMOKE = importlib.util.module_from_spec(_SMOKE_SPEC)
_SMOKE_SPEC.loader.exec_module(CHIP_SMOKE)
_HEADLINE_SPEC = importlib.util.spec_from_file_location(
    "headline_bench", os.path.join(ROOT, "benchmarks", "headline_bench.py"))
_HEADLINE = importlib.util.module_from_spec(_HEADLINE_SPEC)
_HEADLINE_SPEC.loader.exec_module(_HEADLINE)


@pytest.mark.parametrize("name,n_slides", [("chess", None), ("T10I4D100K", 2)])
def test_pinned_stream_checksums(name, n_slides):
    """The per-slide checksums chip_smoke.py holds the card's streams to
    are the reference's StreamingMiner's, and the port's on the host: the
    whole chess stream, the first slides of T10I4D100K's (its full window
    of 131,072 transactions is the card's to mine)."""
    _, n_blocks, block_txns, min_sup, n_batches, drift = next(
        st for st in STREAMS if st[0] == name)
    pinned = CHIP_SMOKE.STREAM_CHECKSUMS[name]
    assert len(pinned) == n_batches
    n = n_batches if n_slides is None else n_slides
    n_items = stream_spec(name).n_items
    got = StreamingMiner(n_items, StreamConfig(min_sup=min_sup, n_blocks=n_blocks,
                                               block_txns=block_txns), device="cpu")
    want = JMiner(n_items, JStreamConfig(min_sup=min_sup, n_blocks=n_blocks,
                                         block_txns=block_txns, backend="jnp"))
    stream = transaction_stream(name, block_txns, n_batches, seed=0, drift_every=drift)
    for i, batch in zip(range(n), stream):
        g = got.advance(batch)
        assert support_checksum(g.support_map()) == pinned[i], f"slide {i}"
        assert _HEADLINE.support_checksum(want.advance(batch).support_map()) == pinned[i]


# ---------------------------------------------------------------------------
# the query surface
# ---------------------------------------------------------------------------

def _services(seed=9):
    got = StreamQueryService(StreamingMiner(
        N_ITEMS, StreamConfig(min_sup=5, n_blocks=2, block_txns=32), device="cpu"))
    want = JService(JMiner(N_ITEMS, JStreamConfig(min_sup=5, n_blocks=2,
                                                  block_txns=32)))
    for batch in _batches(3, 30, seed=seed):
        got.ingest(batch)
        want.ingest(batch)
    return got, want


def test_topk_and_support_match_reference():
    got, want = _services()
    assert got.window_version == want.window_version == 3
    for k, min_len in ((5, 2), (3, 1), (100, 3), (1, 4)):
        g = got.top_k_itemsets(k=k, min_len=min_len)
        assert g == want.top_k_itemsets(k=k, min_len=min_len)
    top = got.top_k_itemsets(k=5, min_len=2)
    assert 0 < len(top) <= 5
    sups = [s for _, s in top]
    assert sups == sorted(sups, reverse=True)
    it, s = top[0]
    assert got.support(it) == s == want.support(it)
    assert got.support((11, 10, 9)) == want.support((11, 10, 9))


def test_rules_match_reference_and_cache():
    got, want = _services()
    for conf in (0.6, 0.9):
        assert got.rules(min_conf=conf) == want.rules(min_conf=conf)
        assert got.rules(min_conf=conf, k=3) == want.rules(min_conf=conf, k=3)
    rules = got.rules(min_conf=0.6)
    smap = got.result.support_map()
    for ante, cons, conf, sup in rules:
        assert conf >= 0.6
        assert sup == smap[tuple(sorted(ante + cons))]
    assert got.rules(min_conf=0.6) is rules          # cached per snapshot
    assert got.cache.stats()["hits"] >= 1
    batch = _batches(1, 30, seed=10)[0]
    got.ingest(batch)
    want.ingest(batch)
    assert got.rules(min_conf=0.6) is not rules      # invalidated by slide
    assert got.rules(min_conf=0.6) == want.rules(min_conf=0.6)
    assert got.cache.stats()["stale_evicted"] == want.cache.stats()["stale_evicted"]
    assert got.result.rules(0.9) == want.result.rules(0.9)


def test_answer_batch_matches_reference():
    got, want = _services()
    queries = [(i, "topk", 3, 1 + i % 2, 0.8) for i in range(5)]
    queries += [(99, "rules", 4, 1, 0.7), (7, "rules", None, 1, 0.9)]
    g_ans, g_stats = got.answer_batch(
        [ItemsetQuery(qid=q, kind=k, k=n, min_len=m, min_conf=c)
         for q, k, n, m, c in queries], n_batches=3)
    w_ans, w_stats = want.answer_batch(
        [JQuery(qid=q, kind=k, k=n, min_len=m, min_conf=c)
         for q, k, n, m, c in queries], n_batches=3)
    assert g_ans == w_ans and set(g_ans) == {0, 1, 2, 3, 4, 99, 7}
    assert g_stats.keys() == w_stats.keys()
    for key, value in g_stats.items():
        assert np.array_equal(value, w_stats[key]), key
    assert 0 < g_stats["padding_efficiency"] <= 1.0
    assert sum(g_stats["queries_per_slot"]) == len(queries)
    assigned, _ = pack_queries([ItemsetQuery(qid=q, kind=k) for q, k, *_ in queries],
                               3, len(got.snapshot.itemsets))
    want_assigned, _ = j_pack_queries([JQuery(qid=q, kind=k) for q, k, *_ in queries],
                                      3, len(got.snapshot.itemsets))
    assert np.array_equal(assigned, want_assigned)
    with pytest.raises(ValueError, match="unknown query kind"):
        got.answer_batch([ItemsetQuery(qid=1, kind="nope")], 1)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

STREAM_ARGS = ["--dataset", "T10I4D100K", "--min-sup", "0.02",
               "--block-txns", "64", "--n-blocks", "2", "--batches", "4",
               "--drift-every", "3", "--top-k", "3", "--min-conf", "0.3"]


def _slide_lines(text):
    """The command line's lines without the latencies (the header names the
    backend, which the packages name differently)."""
    lines = [ln for ln in text.splitlines() if ln.startswith("[stream]")]
    return [re.sub(r"latency=[0-9.]+ms", "latency=", ln) for ln in lines[1:]], lines[0]


def test_launch_stream_prints_the_reference_lines(capsys):
    stream_cli.main(STREAM_ARGS + ["--device", "cpu"])
    got, got_head = _slide_lines(capsys.readouterr().out)
    j_stream_cli.main(STREAM_ARGS)
    want, want_head = _slide_lines(capsys.readouterr().out)
    assert got == want
    assert sum("slide" in ln for ln in got) == 4
    assert any("rules at conf>=0.3" in ln for ln in got)
    assert got_head == want_head.replace("backend=pallas", "backend=fused")


@pytest.mark.parametrize("flags,item", [
    (["--serve"], 8), (["--serve-queries", "10"], 8), (["--queue-cap", "4"], 8),
    (["--serve-policy", "shed"], 8), (["--stall-timeout", "1"], 8),
    (["--serve-clients", "2"], 8),
    (["--checkpoint-dir", "ck"], 9), (["--restore"], 9), (["--remesh"], 9),
    (["--kill-after", "2"], 9), (["--checkpoint-every", "2"], 9),
    (["--keep", "2"], 9),
    (["--block-w", "128"], 6), (["--autotune"], 6)])
def test_launch_stream_refuses_unported_flags_by_name(flags, item, tmp_path,
                                                      monkeypatch, capsys,
                                                      tune_caches):
    """Items 6, 8 and 9 are ported: each of their flags, given alone, runs
    as the reference's command line does — the same slide lines and exit
    code (``--restore`` without a directory is a usage error in both;
    ``--serve`` verifies its storm; ``--autotune`` writes each package's
    own table)."""
    monkeypatch.chdir(tmp_path)

    def run(main, argv):
        try:
            main(argv)
            code = 0
        except SystemExit as e:
            code = e.code
        return code, capsys.readouterr().out

    code, out = run(stream_cli.main, STREAM_ARGS + ["--device", "cpu"] + flags)
    j_code, j_out = run(j_stream_cli.main, STREAM_ARGS + flags)
    assert code == j_code
    if flags[0] == "--serve":
        assert code == 0
        for text in (out, j_out):
            assert "verified 120 answers bit-identical" in text
        return
    if code == 0 or code == 3:
        assert _slide_lines(out)[0] == _slide_lines(j_out)[0]
    if flags[0] == "--checkpoint-dir":
        assert os.listdir("ck") and "checkpoints durable in ck" in out


def test_launch_stream_refuses_a_stray_grid(capsys):
    with pytest.raises(SystemExit):
        stream_cli.main(STREAM_ARGS + ["--device", "cpu", "--grid", "2x2"])
    assert "--grid needs a mesh" in capsys.readouterr().err
