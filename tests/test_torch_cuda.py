"""The port's CUDA kernels against their plain torch versions, and the
paths that run them (the miner, on one device and on gloo ranks sharing
the card; the sliding-window miner; LM serving; LM training, on one device
and on the tiny mesh of 4 gloo ranks sharing the card), on the card.

Every test here needs a CUDA device and skips on a host without one.  The
file imports neither jax nor the reference package, so it runs on a machine
with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import EclatConfig, mine, support_checksum
from repro_torch.core.bitmap import popcount_np
from repro_torch.device import words_from_numpy
from repro_torch.kernels.fused_intersect import (compact_survivors,
                                                 compact_survivors_ref,
                                                 fused_intersect,
                                                 fused_intersect_compact,
                                                 fused_intersect_compact_ref,
                                                 fused_intersect_partial,
                                                 fused_intersect_partial_ref,
                                                 fused_intersect_ref,
                                                 fused_support_pairs)
from repro_torch.kernels.popcount_support import (intersect_support,
                                                  popcount_support_ref)
from repro_torch.kernels.trimatrix import cooccurrence, trimatrix_ref
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  grouped_decode_attention)
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 attention_split_p_ref,
                                                 multi_head_attention)

pytestmark = pytest.mark.cuda

# the kernels the fused mine launches; K1 (fused_intersect) runs inside the
# compaction's own pass, so the mine launches it no time
MINING_KERNELS = ("fused_intersect_compact", "trimatrix")

MODES = [0, 1, 2]
# (P, W, Q, n_valid): singleton, W not a multiple of 4, a padded tail, and
# a scan over several 4,096-flag tiles with n_valid inside the last one
PAIR_SHAPES = [(1, 1, 1, 1), (9, 5, 7, 7), (20, 130, 13, 9), (33, 7, 40, 40),
               (300, 3125, 700, 650), (64, 33, 9000, 8500)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ only")
    return "cuda"


def _pair_args(p, w, q, seed, device):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (p, w), dtype=np.uint32)
    left = rng.integers(0, p, q).astype(np.int32)
    right = rng.integers(0, p, q).astype(np.int32)
    sup_left = popcount_np(words[left]).sum(-1).astype(np.int32)
    min_sup = int(np.median(popcount_np(words[left] & words[right]).sum(-1)))
    args = (words_from_numpy(words, device), torch.from_numpy(left).to(device),
            torch.from_numpy(right).to(device),
            torch.from_numpy(sup_left).to(device))
    return args, min_sup


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q,nv", PAIR_SHAPES)
def test_fused_intersect_matches_ref(cuda, p, w, q, nv, mode):
    args, ms = _pair_args(p, w, q, seed=p + q + mode, device=cuda)
    want = fused_intersect_ref(*args, ms, mode=mode)
    for g, e in zip(fused_intersect(*args, ms, mode=mode), want):
        assert torch.equal(g, e)
    for g, e in zip(fused_support_pairs(*args, ms, mode=mode), want[1:]):
        assert torch.equal(g, e)
    for g, e in zip(fused_intersect_compact(*args, ms, nv, mode=mode),
                    fused_intersect_compact_ref(*args, ms, nv, mode=mode)):
        assert torch.equal(g.reshape(-1), e.reshape(-1).to(g.dtype))


def test_compaction_does_not_synchronise(cuda):
    args, ms = _pair_args(64, 33, 9000, seed=1, device=cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused_intersect_compact(*args, ms, 8500, mode=0)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_compaction_state_survives_an_epoch_wrap(cuda):
    """The look-back state is zeroed and the epoch restarts at 1 once the
    epoch passes its largest value; the compaction stays exact across it,
    and across calls of other sizes on the same state."""
    import sys
    fi = sys.modules["repro_torch.kernels.fused_intersect.fused_intersect"]
    state = fi._STATE
    args, ms = _pair_args(40, 100, 1000, seed=5, device=cuda)
    want = fused_intersect_compact_ref(*args, ms, 900, mode=0)
    fused_intersect_compact(*args, ms, 900, mode=0)
    key = (args[0].device.index, torch.cuda.current_stream().cuda_stream)
    state[key][1] = fi._lib().compact_max_epoch() - 1
    for _ in range(3):
        got = fused_intersect_compact(*args, ms, 900, mode=0)
        for g, e in zip(got, want):
            assert torch.equal(g.reshape(-1), e.reshape(-1).to(g.dtype))
    assert state[key][1] == 2
    small, ms2 = _pair_args(9, 5, 7, seed=6, device=cuda)
    for g, e in zip(fused_intersect_compact(*small, ms2, 7, mode=1),
                    fused_intersect_compact_ref(*small, ms2, 7, mode=1)):
        assert torch.equal(g.reshape(-1), e.reshape(-1).to(g.dtype))


@pytest.mark.parametrize("n,w", [(1, 1), (33, 7), (187, 3125), (130, 64),
                                 (1000, 100)])
def test_trimatrix_matches_ref(cuda, n, w):
    words = np.random.default_rng(n).integers(0, 2**32, (n, w), dtype=np.uint32)
    t = words_from_numpy(words, cuda)
    assert torch.equal(cooccurrence(t), trimatrix_ref(t))


# K4 (wgmma, split-K) at the tile edges (N = 63, 64, 65, 129: ragged and
# whole 128-row tiles, one or several), the word edges (W = 1 and 7: one
# short stage; 100: a short last stage; 3125) and both branches of the
# split plan (one range: a store; several: atomic adds into zeros)
TRI_EDGE = [(n, w) for n in (1, 37, 63, 64, 65, 129, 187, 1000)
            for w in (1, 7, 100, 3125)] + [(4096, 1), (4096, 7), (4096, 100)]


@pytest.mark.parametrize("n,w", TRI_EDGE)
def test_trimatrix_wgmma_exact_at_edges(cuda, n, w):
    from repro_torch.kernels.trimatrix import split_plan
    words = np.random.default_rng(n * 31 + w).integers(0, 2**32, (n, w), dtype=np.uint32)
    t = words_from_numpy(words, cuda)
    kernels.reset_launch_counts()
    got = cooccurrence(t)
    again = cooccurrence(t)
    assert kernels.launch_counts()["trimatrix"] == 2
    assert torch.equal(got, again)
    assert torch.equal(got, trimatrix_ref(t)), f"split plan {split_plan(n, w)}"


# K2's one pass at the look-back's tile edges: Q = 1; one past a tile of 8
# pairs (W = 3125, a warp per pair, rows recomputed) and of 128 pairs
# (W = 100, 8 lanes per pair, rows staged in shared memory); Q over several
# tiles; n_valid = 0; W = 25 (scalar loads, 8 lanes per pair)
COMPACT_EDGE = [(4, 3, 1, 1), (10, 3125, 9, 9), (10, 3125, 17, 12),
                (30, 100, 129, 129), (30, 100, 129, 120), (40, 25, 389, 389),
                (40, 100, 1000, 900), (12, 33, 300, 0), (852, 3125, 4096, 3176),
                (600, 100, 20000, 19000)]


@pytest.mark.parametrize("survivors", ["median", "none", "all"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q,nv", COMPACT_EDGE)
def test_compaction_pass_exact_at_tile_edges(cuda, p, w, q, nv, mode, survivors):
    """Both front ends of the one-pass compaction equal their plain
    versions bit for bit (rows, pad rows, supports, mask, S) with S = 0,
    S = n_valid and in between; two calls give the same bits; each call is
    one counted launch."""
    args, ms = _pair_args(p, w, q, seed=3 * p + w + q + mode, device=cuda)
    ms = {"median": ms, "none": 10**6, "all": -10**6}[survivors]
    kernels.reset_launch_counts()
    got = fused_intersect_compact(*args, ms, nv, mode=mode)
    again = fused_intersect_compact(*args, ms, nv, mode=mode)
    want = fused_intersect_compact_ref(*args, ms, nv, mode=mode)
    for g, a, e in zip(got, again, want):
        assert torch.equal(g, a)
        assert torch.equal(g.reshape(-1), e.reshape(-1).to(g.dtype))
    if survivors != "median":
        assert int(got[3]) == (0 if survivors == "none" else min(nv, q))
    flags = fused_intersect_ref(*args, ms, mode=mode)[2]
    given = compact_survivors(*args[:3], flags.clone(), nv, mode=mode)
    want = compact_survivors_ref(*args[:3], flags.clone(), nv, mode=mode)
    for g, e in zip(given, want):
        assert torch.equal(g.reshape(-1), e.reshape(-1).to(g.dtype))
    assert kernels.launch_counts()["fused_intersect_compact"] == 3
    assert kernels.launch_counts()["fused_intersect"] == 0


def test_mine_on_the_card_launches_every_kernel(cuda):
    rng = np.random.default_rng(7)
    txns = [sorted(set(rng.integers(0, 12, rng.integers(2, 8)).tolist()))
            for _ in range(400)]
    sums = {}
    for backend in ("fused", "ref"):
        kernels.reset_launch_counts()
        res = mine(txns, 12, EclatConfig(min_sup=20, variant="v6", p=3,
                                         use_diffsets=True, backend=backend))
        sums[backend] = support_checksum(res.support_map())
        counts = kernels.launch_counts()
        mining = {k: counts[k] for k in MINING_KERNELS}
        if backend == "fused":
            assert all(v > 0 for v in mining.values()), counts
        else:
            assert not any(mining.values()), counts
        assert counts["fused_intersect"] == 0, counts
        assert counts["flash_attention"] == counts["decode_attention"] == 0
    cpu = mine(txns, 12, EclatConfig(min_sup=20, variant="v6", p=3,
                                     use_diffsets=True), device="cpu")
    assert sums["fused"] == sums["ref"] == support_checksum(cpu.support_map())


@pytest.mark.parametrize("mode", MODES)
def test_fused_engine_without_compaction_launches_k1(cuda, mode):
    """``FusedEngine(compact=False)``: one expansion launches K1 and not
    K2, and its level result (mask, supports, every row of the survivor
    block) equals the compacting engine's bit for bit; a mine with
    ``compact=False`` launches K1 once an expansion and K2 never."""
    from repro_torch.core import engine as eng
    rng = np.random.default_rng(mode)
    words = rng.integers(0, 2**32, (300, 100), dtype=np.uint32)
    left = rng.integers(0, 300, 5000).astype(np.int32)
    right = rng.integers(0, 300, 5000).astype(np.int32)
    sup_left = popcount_np(words[left]).sum(-1).astype(np.int32)
    ms = int(np.median(popcount_np(words[left] & words[right]).sum(-1)))
    frontier = words_from_numpy(words, cuda)
    res = {}
    for compact in (False, True):
        e = eng.make_engine("fused", compact=compact)
        kernels.reset_launch_counts()
        res[compact] = e.expand(frontier, left, right, sup_left, mode=mode, min_sup=ms)
        counts = kernels.launch_counts()
        assert (counts["fused_intersect"], counts["fused_intersect_compact"]) == \
            ((0, 1) if compact else (1, 0))
    assert np.array_equal(res[False].mask, res[True].mask)
    assert np.array_equal(res[False].supports, res[True].supports)
    assert torch.equal(res[False].bitmaps, res[True].bitmaps)
    txns = [sorted(set(rng.integers(0, 12, rng.integers(2, 8)).tolist()))
            for _ in range(400)]
    cfg = dict(min_sup=20, variant="v6", p=3, use_diffsets=True)
    kernels.reset_launch_counts()
    got = mine(txns, 12, EclatConfig(compact=False, **cfg))
    counts = kernels.launch_counts()
    n_expands = len(got.stats["pair_padding"]["per_level"])
    assert counts["fused_intersect"] == n_expands > 0
    assert counts["fused_intersect_compact"] == 0
    assert got.support_map() == mine(txns, 12, EclatConfig(**cfg)).support_map()


# (P, Ws, Q): a slice of one word, Ws = 25 (chess at 4 word shards), Q = 0
# and 1, several tiles
PARTIAL_SHAPES = [(9, 1, 7), (40, 25, 300), (5, 13, 0), (5, 13, 1),
                  (300, 782, 700)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,ws,q", PARTIAL_SHAPES)
def test_fused_intersect_partial_matches_ref(cuda, p, ws, q, mode):
    rng = np.random.default_rng(p + ws + q)
    bm = words_from_numpy(rng.integers(0, 2**32, (p, ws), dtype=np.uint32), cuda)
    left, right = (torch.from_numpy(rng.integers(0, p, q).astype(np.int32)).to(cuda)
                   for _ in range(2))
    want = fused_intersect_partial_ref(bm, left, right, mode=mode)
    got = fused_intersect_partial(bm, left, right, mode=mode)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    none, pop = fused_intersect_partial(bm, left, right, mode=mode, store=False)
    assert none is None and torch.equal(pop, want[1])
    mask = (want[1] % 2).to(torch.int32)
    for g, e in zip(compact_survivors(bm, left, right, mask.clone(), q - q // 3,
                                      mode=mode),
                    compact_survivors_ref(bm, left, right, mask.clone(),
                                          q - q // 3, mode=mode)):
        assert torch.equal(g.reshape(-1), e.reshape(-1).to(g.dtype))


@pytest.mark.parametrize("m,w", [(1, 1), (0, 4), (9, 5), (300, 3125), (5000, 25)])
def test_popcount_support_matches_ref(cuda, m, w):
    rng = np.random.default_rng(m + w)
    a, b = (words_from_numpy(rng.integers(0, 2**32, (m, w), dtype=np.uint32), cuda)
            for _ in range(2))
    got, want = intersect_support(a, b), popcount_support_ref(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tidsharded_mine_on_two_gloo_ranks_sharing_the_card(cuda):
    """chess on 2 gloo ranks sharing the card, word-sharded through K3,
    equal to the single-device fused mine on every rank."""
    from repro_torch.data import generate
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.mesh_runs import run_jobs
    txns, spec = generate("chess", scale=1.0, seed=0)
    cfg = dict(min_sup=0.8, variant="v4", backend="fused", shard="words")
    want = mine(txns, spec.n_items, EclatConfig(min_sup=0.8, variant="v4"))
    per_rank = run_ranks(run_jobs, 2, backend="gloo", device="cuda",
                         args=([dict(kind="mine", txns=txns,
                                     n_items=spec.n_items, config=cfg)],),
                         timeout=300)
    for (res,) in per_rank:
        assert res["checksum"] == support_checksum(want.support_map())
        assert res["stats"]["backend"] == "tidsharded"
        assert res["launches"]["fused_intersect_partial"] == res["n_expands"] > 0
        assert res["stats"]["frontier_words"] == -(-want.stats["n_words"] // 2)


# ---------------------------------------------------------------------------
# the sliding-window miner on the card
# ---------------------------------------------------------------------------

def test_stream_fused_matches_ref_on_the_card(cuda):
    """A drifting chess stream on the fused and ref backends: equal support
    maps on every slide, K4 once per warming push and twice per evicting
    push, K2 once per expansion, K1 never alone, nothing launched by ref;
    the ring validates against its host mirror."""
    from repro_torch.data import stream_spec, transaction_stream
    from repro_torch.streaming import StreamConfig, StreamingMiner
    n_items = stream_spec("chess").n_items
    batches = list(transaction_stream("chess", 256, 7, seed=2, drift_every=5))
    maps = {}
    for backend in ("fused", "ref"):
        miner = StreamingMiner(n_items, StreamConfig(min_sup=0.75, n_blocks=4,
                                                     block_txns=256,
                                                     backend=backend))
        for i, batch in enumerate(batches):
            kernels.reset_launch_counts()
            miner.push(batch)
            push = kernels.launch_counts()
            kernels.reset_launch_counts()
            res = miner.mine_window()
            mined = kernels.launch_counts()
            maps.setdefault(backend, []).append(res.support_map())
            n_exp = len(res.stats["pair_padding"]["per_level"])
            if backend == "ref":
                assert not any(push.values()) and not any(mined.values())
                continue
            assert push["trimatrix"] == (1 if i < 4 else 2), push
            assert sum(push.values()) == push["trimatrix"]
            assert mined["fused_intersect_compact"] == n_exp > 0, mined
            assert mined["fused_intersect"] == mined["trimatrix"] == 0
        miner.ring.validate()
    assert maps["fused"] == maps["ref"]


def test_stream_restore_on_the_card_equals_the_uninterrupted_stream(cuda, tmp_path):
    """A chess stream on the card killed at miner:pre_deep_expand, restored
    from its last checkpoint (the ring re-uploaded from the host words) and
    replayed across a drift: every replayed slide equals the uninterrupted
    stream's, with K4 once per warming and twice per evicting push and K2
    once per expansion after the restore; the ring validates."""
    from repro_torch.data import stream_spec, transaction_stream
    from repro_torch.faults import InjectedFault, clear_kill_hook, set_kill_hook
    from repro_torch.streaming import (StreamCheckpointer, StreamConfig,
                                       StreamingMiner, restore_miner)
    n_items = stream_spec("chess").n_items
    batches = list(transaction_stream("chess", 256, 8, seed=2, drift_every=6))
    cfg = StreamConfig(min_sup=0.75, n_blocks=4, block_txns=256)
    want = [r.support_map() for r in map(StreamingMiner(n_items, cfg).advance, batches)]
    miner = StreamingMiner(n_items, cfg)
    ck = StreamCheckpointer(str(tmp_path), every=2)

    def die(name):
        if name == "miner:pre_deep_expand":
            raise InjectedFault(name)
    with pytest.raises(InjectedFault):
        try:
            for i, batch in enumerate(batches):
                if i == 5:
                    set_kill_hook(die)
                miner.advance(batch)
                if ck.maybe_save(miner, i + 1):
                    ck.wait()
        finally:
            clear_kill_hook()
    restored, start = restore_miner(str(tmp_path))
    assert start == 4 and restored.ring.device.is_cuda
    restored.ring.validate()
    for i in range(start, len(batches)):
        kernels.reset_launch_counts()
        restored.push(batches[i])
        push = kernels.launch_counts()
        kernels.reset_launch_counts()
        res = restored.mine_window()
        mined = kernels.launch_counts()
        assert res.support_map() == want[i], i
        assert push["trimatrix"] == (1 if i < 4 else 2), push
        assert mined["fused_intersect_compact"] == len(
            res.stats["pair_padding"]["per_level"]) > 0, mined
    restored.ring.validate()


def test_serving_frontend_storm_on_the_card(cuda):
    """ServingFrontend over a T10I4D100K window on the card: a writer thread
    slides (launching K4 and K2 from that thread) under a query storm from
    4 clients; verify_storm holds every answer at its version, and the
    snapshots hold no device tensor."""
    import threading
    from repro_torch.data import stream_spec, transaction_stream
    from repro_torch.serving import (AdmissionConfig, ServingFrontend,
                                     query_mix, run_storm, verify_storm)
    from repro_torch.streaming import StreamConfig, StreamingMiner
    n_items = stream_spec("T10I4D100K").n_items
    batches = list(transaction_stream("T10I4D100K", 1024, 6, seed=0))
    miner = StreamingMiner(n_items, StreamConfig(min_sup=0.01, n_blocks=4,
                                                 block_txns=1024),
                           keep_transactions=False)
    frontend = ServingFrontend(miner, AdmissionConfig(keep_versions=16))
    try:
        frontend.ingest(batches[0])
        kernels.reset_launch_counts()
        wt = threading.Thread(target=lambda: [frontend.ingest(b) for b in batches[1:]])
        queries = query_mix(80, seed=0)
        wt.start()
        outcome = run_storm(frontend, queries, n_clients=4, pace_s=0.001)
        wt.join(timeout=120)
        assert not wt.is_alive()
        launched = kernels.launch_counts()
        assert launched["trimatrix"] == sum(1 if i < 4 else 2
                                            for i in range(1, len(batches))), launched
        assert launched["fused_intersect_compact"] > 0
        assert outcome["errors"] == {} and not outcome["shed"]
        ver = verify_storm(frontend, queries, outcome)
        assert ver["verified"] == len(queries)
        assert frontend.window_version == len(batches)
        snap = frontend.snapshot
        assert not any(isinstance(v, torch.Tensor)
                       for v in (*vars(snap).values(), *snap.support_map.values()))
    finally:
        frontend.stop()


def test_ring_frontier_pairs_on_the_card(cuda):
    """K2, K1 and K3 on the level-2 pairs of a T10I4D100K ring (universe
    item ids in support order over every item row, infrequent rows
    included, with a (0, 0) pad tail), equal to their plain versions."""
    from repro_torch.core.engine import bucket_size
    from repro_torch.core.triangular import frequent_pairs
    from repro_torch.data import stream_spec, transaction_stream
    from repro_torch.launch.kernel_timing import rank0_slice
    from repro_torch.streaming import StreamConfig, StreamingMiner
    n_items = stream_spec("T10I4D100K").n_items
    miner = StreamingMiner(n_items, StreamConfig(min_sup=0.005, n_blocks=4,
                                                 block_txns=1024))
    for batch in transaction_stream("T10I4D100K", 1024, 5, seed=3):
        miner.push(batch)
    min_sup = miner.config.resolve_min_sup(miner.ring.n_txn)
    sup = miner.supports
    items = np.nonzero(sup >= min_sup)[0]
    items = items[np.lexsort((items, sup[items]))]
    iu, ju, _ = frequent_pairs(miner.cooc[np.ix_(items, items)], min_sup)
    q, nv = bucket_size(iu.size, 128), iu.size
    assert nv > 0
    lrs = np.zeros((3, q), np.int32)
    lrs[0, :nv], lrs[1, :nv], lrs[2, :nv] = items[iu], items[ju], sup[items[iu]]
    l, r, s = (torch.from_numpy(x).to(cuda) for x in lrs)
    bm = miner.ring.device
    part = rank0_slice(bm)
    for mode in MODES:
        for g, e in zip(fused_intersect_compact(bm, l, r, s, min_sup, nv, mode=mode),
                        fused_intersect_compact_ref(bm, l, r, s, min_sup, nv, mode=mode)):
            assert torch.equal(g.reshape(-1).long(), e.reshape(-1).long())
        for g, e in zip(fused_intersect(bm, l, r, s, min_sup, mode=mode),
                        fused_intersect_ref(bm, l, r, s, min_sup, mode=mode)):
            assert torch.equal(g.reshape(-1).long(), e.reshape(-1).long())
        got, want = (fused_intersect_partial(part, l, r, mode=mode),
                     fused_intersect_partial_ref(part, l, r, mode=mode))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,w", [(870, 256), (75, 16), (187, 3125)])
def test_trimatrix_every_forced_split_is_exact(cuda, n, w):
    """The split sweep's plans (1 to 8 word ranges) give the same counts."""
    from repro_torch.kernels.trimatrix import plan_for, trimatrix
    rng = np.random.default_rng(n + w)
    bm = words_from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32), cuda)
    want = trimatrix_ref(bm)
    for splits in range(1, 9):
        assert torch.equal(trimatrix(bm, plan_for(w, splits)), want), splits


# K1 and K3 stage a window of consecutive rows per tile of consecutive pairs
# and gather the rest: the widths the mines give them (chess 25 / 50 / 100
# words, T10I4D100K 782 / 1,563 / 3,125; whole rows up to 100, word chunks
# above) and narrow edges
WINDOW_WIDTHS = [1, 7, 25, 50, 100, 782, 1563, 3125]
WINDOW_FAMILIES = ["class", "class_pad", "random", "wide_class"]


def _window_inputs(family, w, seed, device):
    """``(bitmaps, left, right, sup_left, min_sup)`` of one input family:
    class-ordered pairs over 30 classes of 1-25 rows (every pair valid), the
    same padded with (0, 0) pairs to the PairBuffers rung, random pairs, and
    a class of 300 rows (wider than any window) among small ones."""
    from repro_torch.core.engine import bucket_size
    from repro_torch.core.equivalence import segment_pairs
    from repro_torch.launch.kernel_timing import class_pair_inputs, pair_inputs
    if family == "random":
        return pair_inputs(300, w, 1037, seed, device=device)
    rng = np.random.default_rng(seed)
    sizes = ([300, 3, 1, 7, 2] if family == "wide_class"
             else rng.integers(1, 26, 30).tolist())
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    n_pairs = segment_pairs(starts, np.asarray(sizes))[0].shape[0]
    q = bucket_size(n_pairs, 128) if family == "class_pad" else n_pairs
    return class_pair_inputs(sum(sizes), w, q, n_pairs, seed, sizes=sizes,
                             device=device)


def _check_window_kernels(bm, l, r, s, ms):
    """K3 and K1, with and without the store, in every mode, equal to their
    plain versions."""
    for mode in MODES:
        want = fused_intersect_partial_ref(bm, l, r, mode=mode)
        inter, pop = fused_intersect_partial(bm, l, r, mode=mode)
        none, pop2 = fused_intersect_partial(bm, l, r, mode=mode, store=False)
        assert none is None
        assert torch.equal(inter, want[0]) and torch.equal(pop, want[1])
        assert torch.equal(pop2, want[1])
        want = fused_intersect_ref(bm, l, r, s, ms, mode=mode)
        for g, e in zip(fused_intersect(bm, l, r, s, ms, mode=mode), want):
            assert torch.equal(g, e)
        for g, e in zip(fused_support_pairs(bm, l, r, s, ms, mode=mode), want[1:]):
            assert torch.equal(g, e)


@pytest.mark.parametrize("w", WINDOW_WIDTHS)
@pytest.mark.parametrize("family", WINDOW_FAMILIES)
def test_window_kernels_match_ref(cuda, family, w):
    _check_window_kernels(*_window_inputs(family, w, seed=w + len(family), device=cuda))


@pytest.mark.parametrize("w", [7, 25, 100, 3125])
@pytest.mark.parametrize("q", [1, 31, 33, 255, 257, 4097])
def test_window_kernels_at_tile_edges(cuda, q, w):
    """Q = 1 and Q one off a tile (32, 256) or a plan's tile size change,
    class-ordered with a pad tail."""
    from repro_torch.launch.kernel_timing import class_pair_inputs
    args = class_pair_inputs(300 + q // 2, w, q, max(q - q // 7, 1), seed=q + w,
                             device=cuda)
    _check_window_kernels(*args)


def test_window_plan_matches_cuda(cuda):
    from repro_torch.kernels.fused_intersect.fused_intersect import (cuda_window_plan,
                                                                     window_plan)
    for q in (1, 4096, 16_896, 33_792, 393_216):
        for w in list(range(0, 130)) + [782, 1563, 3125, 3126, 10_000]:
            assert cuda_window_plan(q, w) == window_plan(q, w), (q, w)


def test_window_plan_candidates_match_cuda(cuda):
    """Every K1/K3 plan candidate the tuner offers, and a given plan the
    check refuses, reported alike by the library and the mirror; K1 and K3
    under each candidate equal the plain versions."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.fused_intersect.fused_intersect import (cuda_window_plan,
                                                                     window_plan)
    kind = torch.cuda.get_device_name(0)
    for q, w in [(393_216, 100), (4096, 3125), (1024, 4096), (768, 128), (4096, 782),
                 (1001, 131), (300, 7)]:
        for plan in autotune.window_candidates(q, w, kind):
            assert cuda_window_plan(q, w, plan[:3]) == window_plan(q, w, plan[:3]) == plan
    for w, plan in [(100, (12, 24, 100)), (100, (256, 0, 100)), (3125, (16, 32, 100)),
                    (3125, (8, 256, 1020))]:
        with pytest.raises(ValueError) as lib:
            cuda_window_plan(50, w, plan)
        with pytest.raises(ValueError) as mirror:
            window_plan(50, w, plan)
        assert str(lib.value) == str(mirror.value)
    from repro_torch.launch.kernel_timing import class_pair_inputs
    bm, l, r, s, ms = class_pair_inputs(300, 131, 1001, 901, seed=4, device=cuda)
    for plan in autotune.window_candidates(1001, 131, kind):
        for mode in (0, 1, 2):
            want = fused_intersect_ref(bm, l, r, s, ms, mode=mode)
            for g, e in zip(fused_intersect(bm, l, r, s, ms, mode=mode, plan=plan[:3]), want):
                assert torch.equal(g, e), (plan, mode)
            got = fused_intersect_partial(bm, l, r, mode=mode, plan=plan[:3])
            for g, e in zip(got, fused_intersect_partial_ref(bm, l, r, mode=mode)):
                assert torch.equal(g, e), (plan, mode)


# attention kernels vs their plain versions run in float32 on the same
# inputs: float32 outputs agree to 1e-4 (sums in another order); bfloat16
# outputs are the float32 value rounded once to nearest, so within half a
# unit in the last place, 2**-8 |want|, plus 1e-5 for the float32 order
# difference near 0
ATTN_TOL_F32 = 1e-4


def _assert_attention_close(got, want):
    assert want.dtype == torch.float32 and got.shape == want.shape
    if got.dtype == torch.float32:
        limit = ATTN_TOL_F32
    else:
        limit = 2.0 ** -8 * want.abs() + 1e-5
    assert bool(((got.float() - want).abs() <= limit).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", [
    (2, 8, 4, 300, 256, True, 0), (1, 8, 4, 257, 256, True, 64),
    (1, 8, 1, 100, 256, True, 0), (2, 4, 4, 37, 64, False, 0),
    (1, 4, 2, 65, 16, False, 10)])
def test_flash_attention_matches_ref(cuda, b, h, hkv, s, d, causal, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    # (B, H, S, D) views of (B, S, H, D) tensors, as the model passes them
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=cuda).to(dtype)
               .transpose(1, 2) for n in (h, hkv, hkv))
    got = multi_head_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window or None)
    assert got.dtype == dtype
    _assert_attention_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("b,kv,g,d,lens", [
    (2, 4, 2, 256, [1, 300]), (4, 1, 8, 256, [1, 77, 299, 300]),
    (3, 2, 4, 16, [5, 64, 65])])
def test_decode_attention_matches_ref(cuda, b, kv, g, d, lens, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(b * 10 + g)
    q = torch.randn((b, kv, g, d), generator=gen, device=cuda).to(dtype)
    k, v = torch.randn((2, b, 300, kv, d), generator=gen, device=cuda).to(dtype)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = grouped_decode_attention(q, k, v, length, window=window)
    want = decode_attention_ref(q.float(), k.float(), v.float(), length,
                                window=window)
    assert got.dtype == dtype
    _assert_attention_close(got, want)


def _model_layout_qkv(b, h, hkv, s, d, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((b, s, n, d), generator=g, device=device).to(dtype)
                 .transpose(1, 2) for n in (h, hkv, hkv))


# soft-capped cases draw q this many times larger, so that the scaled
# scores (about N(0, 1) otherwise) reach the cap of 30 and tanh bends them
CAP_Q_SCALE = 16.0


@pytest.mark.parametrize("b,h,hkv,s,d,window,softcap", [
    (1, 8, 4, 37, 256, 8, 0.0),       # S < 64, a window inside one tile
    (1, 8, 8, 100, 256, 0, 0.0),      # G = 1, S not a multiple of 64
    (2, 8, 1, 200, 256, 30, 0.0),     # G = 8, S not a multiple of 128
    (1, 4, 2, 129, 128, 0, 0.0),      # one row past a 128-row q tile
    (2, 4, 4, 64, 64, 0, 0.0),        # exactly one tile
    (1, 8, 4, 191, 64, 63, 0.0),      # a window one row short of a tile
    (2, 4, 1, 50, 16, 8, 0.0),        # the reduced configs' D
    (1, 2, 2, 1, 16, 0, 0.0),         # one row
    (1, 8, 4, 700, 256, 1024, 0.0),   # a window wider than S
    (2, 12, 2, 300, 128, 0, 0.0),     # G = 6, D = 128 (internlm2, grok)
    (1, 10, 2, 257, 128, 0, 0.0),     # G = 5, D = 128 (llama4)
    (2, 12, 2, 300, 128, 0, 30.0),    # grok's soft-cap, G = 6, D = 128
    (1, 12, 2, 129, 128, 64, 30.0),   # a cap and a window
    (1, 8, 4, 77, 256, 0, 30.0),      # a cap at D = 256
    (2, 4, 1, 1024, 256, 0, 0.0),     # a rank of gemma-2b on the tiny mesh
    (1, 25, 5, 300, 64, 2048, 0.0),   # hymba: G = 5 over 25 heads, D = 64
    (1, 25, 5, 2100, 64, 2048, 0.0)])  # hymba's window of 2,048 biting
def test_flash_attention_wgmma_bf16(cuda, b, h, hkv, s, d, window, softcap):
    """The bf16 tensor-core kernel (and only it) runs bf16 inputs, with or
    without a logit soft-cap, within half a bf16 unit of the float32 plain
    output and of the float32 emulation of its split-P arithmetic, the same
    bits on a second call."""
    q, k, v = _model_layout_qkv(b, h, hkv, s, d, torch.bfloat16, s + d, cuda)
    if softcap:
        q = (q.float() * CAP_Q_SCALE).to(torch.bfloat16)
    kernels.reset_launch_counts()
    got = multi_head_attention(q, k, v, causal=True, window=window, softcap=softcap)
    again = multi_head_attention(q, k, v, causal=True, window=window, softcap=softcap)
    assert kernels.variant_counts() == {"flash_attention.wgmma_bf16": 2,
                                        "flash_attention.fma_f32": 0,
                                        **_NO_BWD}
    assert torch.equal(got, again)
    args = dict(causal=True, window=window or None, softcap=softcap)
    _assert_attention_close(got, attention_ref(q.float(), k.float(), v.float(), **args))
    _assert_attention_close(got, attention_split_p_ref(q.float(), k.float(),
                                                       v.float(), **args))
    if softcap:   # the cap changes the result
        assert not torch.equal(got, multi_head_attention(q, k, v, causal=True,
                                                         window=window))


@pytest.mark.parametrize("h,hkv,d,causal,window,softcap", [
    (8, 4, 256, True, 0, 0.0), (8, 4, 256, False, 0, 0.0),
    (8, 4, 256, False, 40, 0.0), (12, 2, 128, True, 0, 0.0),
    (12, 2, 128, True, 0, 30.0), (10, 2, 128, True, 40, 30.0)])
def test_flash_attention_f32_runs_the_fma_kernel(cuda, h, hkv, d, causal, window,
                                                 softcap):
    q, k, v = _model_layout_qkv(2, h, hkv, 150, d, torch.float32, 7, cuda)
    if softcap:
        q = q * CAP_Q_SCALE
    kernels.reset_launch_counts()
    got = multi_head_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    again = multi_head_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    assert kernels.variant_counts() == {"flash_attention.wgmma_bf16": 0,
                                        "flash_attention.fma_f32": 2,
                                        **_NO_BWD}
    assert torch.equal(got, again)
    _assert_attention_close(got, attention_ref(q, k, v, causal=causal,
                                               window=window or None,
                                               softcap=softcap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_soft_capped_gradient_runs_the_capped_backward(cuda, dtype):
    """Autograd through soft-capped attention on the card runs K6's forward
    and its capped backward once each, and the gradients are the plain
    backward's (float32 within 1e-4, bf16 within rel L2 1e-2)."""
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     attention_ref_bwd)
    q, k, v = _model_layout_qkv(1, 12, 2, 64, 128, dtype, 3, cuda)
    q = (q.float() * CAP_Q_SCALE).to(dtype)
    for t in (q, k, v):
        t.requires_grad_()
    kernels.reset_launch_counts()
    out = multi_head_attention(q, k, v, causal=True, window=0, softcap=30.0)
    dout = torch.randn_like(out.float()).to(dtype)
    out.backward(dout)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    args = dict(causal=True, softcap=30.0)
    lse = attention_lse_ref(q.detach().float(), k.detach().float(), **args)
    want = attention_ref_bwd(q.detach().float(), k.detach().float(),
                             v.detach().float(), out.detach().float(),
                             dout.float(), lse, **args)
    for t, w_ in zip((q, k, v), want):
        if dtype == torch.float32:
            torch.testing.assert_close(t.grad, w_, rtol=0, atol=BWD_TOL_F32)
        else:
            assert float((t.grad.float() - w_).norm() / w_.norm()) <= BWD_REL_BF16


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("kv,g", [(4, 1), (4, 2), (2, 3), (2, 4), (2, 5), (2, 6),
                                  (1, 7), (1, 8)])
def test_decode_attention_at_chunk_edges(cuda, kv, g, window, dtype, softcap):
    """Lengths at the kernel's 64-row chunk edges of a 300-row cache (5
    chunks, the last ragged), every group size from 1 to 8, with and
    without a logit soft-cap, and two calls bit-equal: the partials merge
    in a fixed order."""
    lens = [1, 63, 64, 65, 128, 129, 299, 300]
    gen = torch.Generator(device=cuda).manual_seed(kv * 10 + g)
    q = torch.randn((len(lens), kv, g, 128), generator=gen, device=cuda)
    q = (q * CAP_Q_SCALE if softcap else q).to(dtype)
    k, v = torch.randn((2, len(lens), 300, kv, 128), generator=gen,
                       device=cuda).to(dtype)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = grouped_decode_attention(q, k, v, length, window=window, softcap=softcap)
    again = grouped_decode_attention(q, k, v, length, window=window, softcap=softcap)
    assert torch.equal(got, again)
    _assert_attention_close(got, decode_attention_ref(
        q.float(), k.float(), v.float(), length, window=window, softcap=softcap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_hymbas_decode_shape(cuda, dtype):
    """K7 at hymba's decode steps (B = 2, KV = 5, G = 5, D = 64, a 2,080-row
    cache, window 2,048) at the lengths where the window starts to bite,
    the serving traffic's last steps (2,049 to 2,079 rows), and before it."""
    gen = torch.Generator(device=cuda).manual_seed(25)
    k, v = torch.randn((2, 2, 2080, 5, 64), generator=gen, device=cuda).to(dtype)
    for lens in ([1, 2048], [2049, 2050], [2064, 2079]):
        q = torch.randn((2, 5, 5, 64), generator=gen, device=cuda).to(dtype)
        length = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got = grouped_decode_attention(q, k, v, length, window=2048)
        _assert_attention_close(got, decode_attention_ref(
            q.float(), k.float(), v.float(), length, window=2048))
        if lens[0] > 2048:   # the window changes the result there
            unwindowed = grouped_decode_attention(q, k, v, length)
            assert not torch.equal(got, unwindowed)


def test_decode_attention_refuses_a_group_above_8(cuda):
    q = torch.zeros((1, 1, 9, 128), device=cuda)
    kv = torch.zeros((1, 64, 1, 128), device=cuda)
    with pytest.raises(ValueError, match="group size 9"):
        grouped_decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32,
                                                       device=cuda))


# serving and inference launch no backward
_NO_BWD = {"flash_attention_bwd.wgmma_bf16": 0, "flash_attention_bwd.fma_f32": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,sk,d", [
    (2, 8, 8, 1, 1500, 64), (2, 8, 8, 4, 1500, 64), (1, 8, 8, 37, 1500, 64),
    (1, 8, 8, 228, 1500, 64),      # whisper's cross-attention, G = 1
    (1, 8, 2, 130, 65, 64),        # G = 4, keys one row past a tile
    (2, 4, 4, 200, 77, 96)])       # phi3's head size, fewer keys than queries
def test_flash_attention_over_keys_that_are_not_the_queries(cuda, b, h, hkv, s,
                                                            sk, d, dtype):
    """K6 non-causal at Sk != S (whisper's cross-attention: S decoder rows
    over Sk encoder rows) against its plain version, in its dtype's variant
    only, the same bits on a second call; bf16 also against the split-P
    emulation."""
    g = torch.Generator(device=cuda).manual_seed(s + sk)
    q = torch.randn((b, s, h, d), generator=g, device=cuda).to(dtype).transpose(1, 2)
    k, v = (torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(dtype)
            .transpose(1, 2) for _ in range(2))
    kernels.reset_launch_counts()
    got = multi_head_attention(q, k, v, causal=False)
    again = multi_head_attention(q, k, v, causal=False)
    variant = "wgmma_bf16" if dtype == torch.bfloat16 else "fma_f32"
    assert kernels.variant_counts() == {
        **{f"flash_attention.{x}": 2 if x == variant else 0
           for x in ("wgmma_bf16", "fma_f32")}, **_NO_BWD}
    assert torch.equal(got, again) and got.shape == q.shape
    want = attention_ref(q.float(), k.float(), v.float(), causal=False)
    _assert_attention_close(got, want)
    if dtype == torch.bfloat16:
        _assert_attention_close(got, attention_split_p_ref(
            q.float(), k.float(), v.float(), causal=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_gradient_raises_on_the_card(cuda, dtype):
    """A gradient through attention over keys that are not the queries (no
    longer refused: K6's backward takes Sk != S) launches the forward with
    its lse and the backward once each, counted as ``cross``; the
    gradients reach q, k and v in their layouts and equal autograd of the
    plain version within the backward's tolerance.  A causal mask at
    Sk != S is still refused, before any launch."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn((2, 4, 8, 64), generator=g, device=cuda).to(dtype).transpose(1, 2)
    k, v = (torch.randn((2, 300, 8, 64), generator=g, device=cuda).to(dtype)
            .transpose(1, 2) for _ in range(2))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    kernels.reset_launch_counts()
    multi_head_attention(*leaves, causal=False).float().square().sum().backward()
    assert kernels.launch_counts()["flash_attention"] == 1
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    assert kernels.shape_counts()["flash_attention_bwd.cross"] == 1
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    attention_ref(*plain, causal=False).square().sum().backward()
    for t, w in zip(leaves, plain):
        assert t.grad.stride() == t.stride() and t.grad.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(t.grad, w.grad, rtol=0, atol=BWD_TOL_F32)
        else:
            assert float((t.grad.float() - w.grad).norm() / w.grad.norm()) <= BWD_REL_BF16
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="keys that are not the queries"):
        multi_head_attention(*leaves, causal=True)
    assert kernels.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_phi3s_layer(cuda, dtype):
    """K6 at phi-3-vision's head size D = 96 (G = 1, 32 heads), causal, the
    head dimension zero-padded to the kernels' 128 (bf16) and 256
    (float32) columns."""
    q, k, v = _model_layout_qkv(1, 32, 32, 300, 96, dtype, 96, cuda)
    got = multi_head_attention(q, k, v, causal=True)
    _assert_attention_close(got, attention_ref(q.float(), k.float(), v.float()))
    if dtype == torch.bfloat16:
        _assert_attention_close(got, attention_split_p_ref(
            q.float(), k.float(), v.float()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kv,d,s,lens", [
    (2, 32, 96, 2080, [1, 2079]),            # phi3's decode, G = 1, D = 96
    (8, 8, 64, 1500, [1500] * 8)])           # whisper's cross rows
def test_decode_attention_at_phi3_and_whisper_shapes(cuda, b, kv, d, s, lens, dtype):
    """K7 at G = 1: phi-3-vision's head size D = 96 (12 of a warp's lanes
    on a row), and whisper's decode step over all 1,500 encoder rows."""
    gen = torch.Generator(device=cuda).manual_seed(d + s)
    q = torch.randn((b, kv, 1, d), generator=gen, device=cuda).to(dtype)
    k, v = torch.randn((2, b, s, kv, d), generator=gen, device=cuda).to(dtype)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = grouped_decode_attention(q, k, v, length)
    _assert_attention_close(got, decode_attention_ref(q.float(), k.float(),
                                                      v.float(), length))

# K6's backward against its plain version: float32 within 1e-4 absolute
# (sums in another order); bf16 ||delta|| / ||ref|| within 1e-2 for each
# gradient (the gradients are rounded once to bf16, 2^-9 relative, and the
# plain version runs in float32 on the same bf16 inputs and output)
BWD_TOL_F32 = 1e-4
BWD_REL_BF16 = 1e-2
# the bf16 kernels against their emulation (attention_bwd_bf16_ref, the
# same roundings of P and dS): both round the same fp32 values, which differ
# by fp32 sums taken in another order and exp2 against exp, so an element
# of P or dS near a rounding boundary may round the other way; rel L2 1e-3,
# a tenth of the gate against the plain version
BWD_REL_EMU = 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,softcap", [
    (2, 8, 1, 200, 256, True, 0, 0.0),     # G = 8, ragged
    (1, 8, 4, 130, 256, True, 50, 0.0),    # a window inside a k tile
    (2, 4, 2, 64, 16, True, 8, 0.0),       # the reduced configs' D
    (1, 4, 4, 97, 64, False, 0, 0.0),      # non-causal, G = 1
    (2, 8, 2, 77, 96, True, 0, 0.0),       # G = 4, D padded to 128
    (1, 2, 1, 1, 128, True, 0, 0.0),       # one row
    (2, 4, 1, 1024, 256, True, 0, 0.0),    # a rank of gemma-2b on the tiny mesh
    (2, 4, 4, 64, 16, True, 0, 30.0),      # the reduced grok, G = 1
    (1, 12, 2, 130, 128, True, 50, 30.0),  # a cap and a window
    (1, 4, 4, 97, 64, False, 0, 30.0),     # a cap, non-causal, G = 1
    (1, 32, 32, 257, 96, True, 0, 0.0),    # phi3's layer: G = 1, D = 96
    (2, 25, 5, 300, 64, True, 2048, 0.0),  # hymba's heads: G = 5 split 5 ways
    (4, 25, 5, 1024, 64, True, 2048, 0.0),  # hymba's training layer, no split
    (1, 25, 5, 2100, 64, True, 2048, 0.0)])  # hymba's window bites
def test_flash_attention_bwd_matches_its_plain_version(cuda, b, h, hkv, s, d,
                                                       causal, window, softcap,
                                                       dtype):
    """The forward's lse against the plain scores' logsumexp, the backward
    kernels against ``attention_ref_bwd`` in float32 on the same inputs
    and, in bf16, against ``attention_bwd_bf16_ref``; two calls bit-equal
    (no atomics).  Soft-capped cases draw q ``CAP_Q_SCALE`` times larger."""
    _check_bwd(cuda, b, h, hkv, s, d, causal, window, softcap, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,sk,d", [
    (2, 8, 8, 448, 1500, 64),    # whisper's cross-attention in training, G = 1
    (1, 8, 8, 1500, 1500, 64),   # whisper's encoder (non-causal self)
    (1, 8, 2, 130, 65, 64),      # G = 4 split over blocks, a ragged k tile
    (2, 4, 4, 200, 77, 96),      # D = 96, fewer keys than queries
    (1, 4, 1, 1, 300, 64)])      # one query row, G = 4
def test_flash_attention_bwd_over_other_keys_matches_its_plain_version(
        cuda, b, h, hkv, s, sk, d, dtype):
    """K6's backward at Sk != S (non-causal, no window; 1,500 = 23 x 64 +
    28 keys leave a ragged last k tile): the kernels against
    ``attention_ref_bwd`` and, in bf16, ``attention_bwd_bf16_ref``; two
    calls bit-equal; dk and dv of Sk rows."""
    _check_bwd(cuda, b, h, hkv, s, d, False, 0, 0.0, dtype, sk=sk)


def test_capped_bwd_at_groks_training_layer(cuda):
    """The capped backward at grok's training layer (B=2 H=48 Hkv=8 S=1,024
    D=128, G = 6, bf16, the dtype grok trains in; its float32 kernel is
    held by the capped cases above)."""
    _check_bwd(cuda, 2, 48, 8, 1024, 128, True, 0, 30.0, torch.bfloat16)


def _check_bwd(cuda, b, h, hkv, s, d, causal, window, softcap, dtype, sk=None):
    from repro_torch.kernels.flash_attention import (attention_bwd_bf16_ref,
                                                     attention_lse_ref,
                                                     attention_ref_bwd,
                                                     flash_attention,
                                                     flash_attention_bwd)
    q, k, v = _model_layout_qkv(b, h, hkv, s, d, dtype, s + d + 1, cuda)
    if sk is not None:
        _, k, v = _model_layout_qkv(b, hkv, hkv, sk, d, dtype, sk + d, cuda)
    if softcap:
        q = (q.float() * CAP_Q_SCALE).to(dtype)
    gen = torch.Generator(device=cuda).manual_seed(s)
    dout = torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype)
    kernels.reset_launch_counts()
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window,
                              softcap=softcap)
    again = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window,
                                softcap=softcap)
    variant = "wgmma_bf16" if dtype == torch.bfloat16 else "fma_f32"
    assert kernels.variant_counts()[f"flash_attention_bwd.{variant}"] == 2
    args = dict(causal=causal, window=window or None, softcap=softcap)
    want_lse = attention_lse_ref(q.float(), k.float(), **args)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    want = attention_ref_bwd(q.float(), k.float(), v.float(), out.float(),
                             dout.float(), want_lse, **args)
    emu = attention_bwd_bf16_ref(q, k, v, out, dout, lse, **args)
    for name, g_, a_, w_, e_, t in zip("qkv", got, again, want, emu, (q, k, v)):
        assert g_.dtype == dtype and g_.shape == t.shape
        assert torch.equal(g_, a_)
        if dtype == torch.float32:
            torch.testing.assert_close(g_, w_, rtol=0, atol=BWD_TOL_F32)
        elif s == 1 and k.shape[2] == 1 and name in "qk":
            # one key per row: P = 1 and dS = dP - delta = 0 in exact
            # arithmetic, so dq and dk are fp32 rounding noise here and in
            # the plain version, and a relative error means nothing
            assert float(g_.float().abs().max()) <= 1e-5
        else:
            assert float((g_.float() - w_).norm() / w_.norm()) <= BWD_REL_BF16
            e_ = e_.to(dtype).float()
            assert float((g_.float() - e_).norm() / e_.norm()) <= BWD_REL_EMU


@pytest.mark.parametrize("b,h,hkv,s,d,window", [
    (4, 8, 1, 1024, 256, 0), (2, 8, 4, 2048, 256, 1024), (2, 8, 1, 200, 256, 0),
    (2, 4, 2, 64, 16, 8), (1, 2, 1, 1, 128, 0), (16, 8, 1, 4096, 256, 0),
    (2, 4, 1, 1024, 256, 0), (4, 25, 5, 1024, 64, 2048), (2, 25, 5, 1024, 64, 2048)])
def test_flash_attention_bwd_plan_matches_its_mirror(cuda, b, h, hkv, s, d, window):
    """The CUDA plan of the bf16 backward (flash_attention_bwd_plan) equals
    its Python mirror, which the CPU tests check for coverage and shared
    memory."""
    import ctypes
    from repro_torch.kernels.flash_attention import bwd_plan
    from repro_torch.kernels.flash_attention.flash_attention import _lib
    out = (ctypes.c_longlong * 8)()
    n = _lib().flash_attention_bwd_plan(1, b, h, hkv, s, s, d, 1, window, 0, out)
    want = bwd_plan(b, h, hkv, s, d, window)
    assert list(out) == list(want[:8]) and n == want.scratch_floats


@pytest.mark.parametrize("b,h,hkv,s,sk,d", [
    (16, 8, 8, 448, 1500, 64), (1, 8, 2, 130, 65, 64), (2, 8, 1, 40, 300, 16)])
def test_flash_attention_bwd_plan_at_other_keys_matches_its_mirror(cuda, b, h, hkv,
                                                                   s, sk, d):
    """The CUDA plan at Sk != S (k tiles and partials of Sk rows, dQ blocks
    of S rows) equals ``bwd_plan(..., sk=)``."""
    import ctypes
    from repro_torch.kernels.flash_attention import bwd_plan
    from repro_torch.kernels.flash_attention.flash_attention import _lib
    out = (ctypes.c_longlong * 8)()
    n = _lib().flash_attention_bwd_plan(1, b, h, hkv, s, sk, d, 0, 0, 0, out)
    want = bwd_plan(b, h, hkv, s, d, sk=sk)
    assert list(out) == list(want[:8]) and n == want.scratch_floats


# K6's float32 kernels at every instance (D = 16, 32, 64, 128, 256; 24 and
# 96 round up to 32 and 128), ragged S, G = 1, 2, 5, 8, windows, keys that
# are not the queries and the soft-cap: (B, H, Hkv, S, Sk, D, causal,
# window, softcap)
F32_CASES = [
    (2, 2, 2, 64, 64, 16, True, 0, 0.0),      # a reduced MoE job's mesh rank
    (2, 4, 2, 150, 150, 16, True, 8, 0.0),    # G = 2, ragged, a window
    (1, 5, 1, 150, 150, 24, True, 0, 0.0),    # G = 5, D = 24 in the 32 instance
    (1, 8, 1, 200, 200, 32, False, 0, 0.0),   # G = 8, non-causal
    (1, 4, 4, 130, 130, 64, True, 50, 30.0),  # G = 1, a window and the cap
    (2, 8, 8, 150, 448, 64, False, 0, 0.0),   # more keys than queries, ragged
    (1, 10, 2, 257, 257, 96, True, 0, 0.0),   # G = 5, D = 96 in the 128 instance
    (1, 12, 2, 300, 300, 128, True, 64, 30.0),  # G = 6, window and cap
    (1, 8, 1, 150, 77, 128, False, 0, 0.0),   # G = 8, fewer keys than queries
    (1, 8, 4, 300, 300, 256, True, 0, 0.0),   # G = 2 at D = 256
    (1, 8, 1, 150, 150, 256, False, 40, 30.0),  # G = 8, window without causal, cap
]


@pytest.mark.parametrize("b,h,hkv,s,sk,d,causal,window,softcap", F32_CASES)
def test_f32_kernels_at_every_instance(cuda, b, h, hkv, s, sk, d, causal, window,
                                       softcap):
    """K6's float32 forward, its lse and its backward against the plain
    versions within the unchanged 1e-4 (lse 1e-5), two calls of each
    bit-equal (no atomics), each call counted once as ``fma_f32``."""
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     attention_ref_bwd,
                                                     flash_attention,
                                                     flash_attention_bwd)
    q, k, v = _model_layout_qkv(b, h, hkv, s, d, torch.float32, s + d, cuda)
    if sk != s:
        _, k, v = _model_layout_qkv(b, hkv, hkv, sk, d, torch.float32, sk + d, cuda)
    if softcap:
        q = q * CAP_Q_SCALE
    dout = torch.randn((b, h, s, d), generator=torch.Generator(device=cuda).manual_seed(d),
                       device=cuda)
    args = dict(causal=causal, window=window, softcap=softcap)
    kernels.reset_launch_counts()
    out, lse = flash_attention(q, k, v, return_lse=True, **args)
    out2, lse2 = flash_attention(q, k, v, return_lse=True, **args)
    grads = flash_attention_bwd(q, k, v, out, dout, lse, **args)
    again = flash_attention_bwd(q, k, v, out, dout, lse, **args)
    assert kernels.variant_counts() == {"flash_attention.wgmma_bf16": 0,
                                        "flash_attention.fma_f32": 2,
                                        "flash_attention_bwd.wgmma_bf16": 0,
                                        "flash_attention_bwd.fma_f32": 2}
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref = dict(causal=causal, window=window or None, softcap=softcap)
    _assert_attention_close(out, attention_ref(q, k, v, **ref))
    want_lse = attention_lse_ref(q, k, **ref)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    want = attention_ref_bwd(q, k, v, out, dout, want_lse, **ref)
    for g_, a_, w_, t in zip(grads, again, want, (q, k, v)):
        assert g_.dtype == torch.float32 and g_.shape == t.shape
        assert torch.equal(g_, a_)
        torch.testing.assert_close(g_, w_, rtol=0, atol=BWD_TOL_F32)


def test_f32_launch_the_kernel_refuses_raises(cuda):
    """A float32 call the kernels refuse (B above the grid's 65,535) raises
    from the forward and from the backward, counts nothing and does not
    fall back to the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    q = torch.randn((65536, 1, 2, 8), device=cuda)
    lse = torch.zeros((65536, 1, 2), device=cuda)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="fma_f32"):
        flash_attention(q, q, q, causal=True)
    with pytest.raises(RuntimeError, match="fma_f32"):
        flash_attention_bwd(q, q, q, q, q, lse, causal=True)
    assert kernels.launch_counts()["flash_attention"] == 0
    assert kernels.launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("b,h,hkv,s,sk,d,causal,window", [
    (2, 8, 4, 2048, 2048, 256, True, 0), (2, 2, 2, 64, 64, 16, True, 0),
    (1, 5, 1, 300, 300, 96, True, 64), (1, 8, 8, 448, 1500, 64, False, 0),
    (2, 4, 2, 150, 150, 32, False, 40), (1, 2, 1, 1, 1, 128, True, 0)])
def test_f32_plan_matches_its_mirror(cuda, b, h, hkv, s, sk, d, causal, window):
    """The C side's float32 plan (flash_attention_f32_plan for the forward,
    flash_attention_bwd_plan with dtype 0 for the backward) equals
    ``f32_plan``, which the CPU tests hold to coverage, order and shared
    memory."""
    import ctypes
    from repro_torch.kernels.flash_attention import f32_plan
    from repro_torch.kernels.flash_attention.flash_attention import _lib
    want = f32_plan(b, h, hkv, s, d, window, sk=sk, causal=causal)
    fwd = (ctypes.c_longlong * 5)()
    assert _lib().flash_attention_f32_plan(d, fwd) == 0
    assert list(fwd) == [want.kd, want.fwd_threads, want.fwd_bk, want.fwd_slots,
                         want.fwd_smem]
    out = (ctypes.c_longlong * 8)()
    n = _lib().flash_attention_bwd_plan(0, b, h, hkv, s, sk, d, int(causal), window, 0, out)
    assert n == want.scratch_floats
    assert list(out) == [want.kd, -(-sk // 64), h // hkv, 1, want.dkdv_blocks,
                         want.dq_blocks, want.grad_smem, want.ds_smem]


def test_flash_attention_bwd_splits_give_one_result(cuda):
    """gemma-2b's layer (MQA) with the group split one head per block (the
    rule: partials summed by the reduction kernel) and kept whole in one
    block (no reduction): the same gradients within bf16 rounding, each
    bit-equal across calls."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import _bwd
    q, k, v = _model_layout_qkv(2, 8, 1, 256, 256, torch.bfloat16, 5, cuda)
    dout = torch.randn_like(q.float()).to(torch.bfloat16)
    out, lse = flash_attention(q, k, v, causal=True, window=0, return_lse=True)
    runs = {hpb: _bwd(q, k, v, out, dout, lse, True, 0, None, 0.0, hpb)
            for hpb in (1, 2, 8)}
    for hpb, grads in runs.items():
        again = _bwd(q, k, v, out, dout, lse, True, 0, None, 0.0, hpb)
        assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
        for g_, w_ in zip(grads, runs[1]):
            assert float((g_.float() - w_.float()).norm() / w_.float().norm()) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_the_kernels_launches_forward_and_backward(cuda, dtype):
    """multi_head_attention on inputs that need a gradient runs K6 with lse
    and its backward once each; the gradients land in the inputs' layout;
    under no_grad nothing is saved and no lse is written."""
    q, k, v = _model_layout_qkv(2, 8, 1, 150, 256, dtype, 11, cuda)
    for t in (q, k, v):
        t.requires_grad_()
    kernels.reset_launch_counts()
    out = multi_head_attention(q, k, v, causal=True, window=0)
    out.float().square().sum().backward()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    for t in (q, k, v):
        assert t.grad is not None and t.grad.stride() == t.stride()
        assert torch.isfinite(t.grad.float()).all()
    with torch.no_grad():
        kernels.reset_launch_counts()
        again = multi_head_attention(q, k, v, causal=True, window=0)
    assert torch.equal(again, out.detach()) and not again.requires_grad
    assert kernels.launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma-2b", "phi-3-vision-4.2b",
                                  "whisper-base"])
def test_reduced_training_on_the_card_matches_the_cpu(cuda, arch):
    """Three float32 train steps of the reduced config on the card and on
    the CPU from the same weights and batches: losses within 1e-4
    relative; K6's float32 forward and backward once per attention and
    step.  phi-3-vision's batches hold image embeddings that prefix the
    text; whisper's hold frame embeddings, and each decoder layer runs two
    attentions (self, then cross at Sk != S) besides the encoder's."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model, init_params, stages_meta
    from repro_torch.training import adamw_init, make_train_step
    cfg = reduced_config(get_config(arch))
    n_layers = sum(c for _, c in stages_meta(cfg))
    n_attn = n_layers * (2 if cfg.n_encoder_layers else 1) + cfg.n_encoder_layers
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                       remat="none")
    step = make_train_step(Model(cfg), tcfg)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = _to(host, cuda)
    hs, cs = adamw_init(host), adamw_init(card)
    pipe = TokenPipeline(cfg.vocab_size, batch=4, seq_len=32, seed=0)
    rng = np.random.default_rng(0)
    for i in range(3):
        batch = {"tokens": torch.from_numpy(pipe.batch_at(i)["tokens"])}
        if cfg.frontend == "vision":
            batch["img_embeds"] = torch.from_numpy(rng.normal(
                size=(4, cfg.frontend_len, cfg.d_model)).astype(np.float32))
        if cfg.n_encoder_layers:
            batch["enc_embeds"] = torch.from_numpy((rng.normal(
                size=(4, cfg.encoder_len, cfg.d_model)) * 0.05).astype(np.float32))
        kernels.reset_launch_counts()
        card, cs, cm = step(card, cs, _to(batch, cuda))
        counts = kernels.variant_counts()
        assert counts["flash_attention.fma_f32"] == n_attn
        assert counts["flash_attention_bwd.fma_f32"] == n_attn
        if cfg.n_encoder_layers:
            shapes = kernels.shape_counts()
            for kind, n in (("full", cfg.n_encoder_layers), ("causal", n_layers),
                            ("cross", n_layers)):
                assert shapes[f"flash_attention.{kind}"] == n
                assert shapes[f"flash_attention_bwd.{kind}"] == n
        host, hs, hm = step(host, hs, batch)
        assert abs(float(cm["loss"]) - float(hm["loss"])) <= 1e-4 * float(hm["loss"])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-4b", "grok-1-314b",
                                  "llama4-maverick-400b-a17b"])
def test_mesh_training_on_four_gloo_ranks_sharing_the_card(cuda, arch, tmp_path):
    """The reduced float32 config on the tiny mesh, (data, model) = (2, 2),
    4 gloo ranks sharing the card (the ``train`` job of launch.mesh_runs),
    against the same model in this process on the CPU from the same
    weights (a MoE at its own capacity factor: against the same job on 4
    gloo ranks of the host, which routes the same groups per data shard):
    losses within 1e-4 relative on every rank, a MoE's expert loads and
    dropped shares equal step by step; K6's float32 forward and backward
    once per layer and step on every rank; the lead rank's checkpoint
    restored on the mesh replays step 3 bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.mesh_runs import run_jobs
    from repro_torch.launch.train import train_run
    from repro_torch.models import init_params, stages_meta
    cfg = reduced_config(get_config(arch))
    n_layers = sum(c for _, c in stages_meta(cfg))
    rate = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    moe = bool(cfg.n_experts)
    job = dict(kind="train", mesh="tiny", arch=arch, reduced=True, steps=3,
               batch=4, seq=32, tcfg=rate, moe_stats=moe, params=_np_tree(
                   init_params(cfg, torch.Generator().manual_seed(0), "cpu")))
    ckpt = dict(job, steps=2, then=1, ckpt_dir=str(tmp_path), ckpt_every=2,
                gather=True)
    restored = dict(ckpt, steps=1, then=0, params=None, seed=1)
    per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cuda",
                         args=([job, ckpt, restored],), timeout=300)
    hosts = ([r[0] for r in run_ranks(run_jobs, 4, backend="gloo", device="cpu",
                                      args=([job],), timeout=300)]
             if moe else [train_run(job, torch.device("cpu"))] * 4)
    dropped = 0.0
    for (res, a, b), host in zip(per_rank, hosts):
        for got, want in zip(res["losses"], host["losses"]):
            assert abs(got - want) <= 1e-4 * abs(want)
        for rec, want in zip(res["records"], host["records"]):
            assert rec["launches"]["flash_attention.fma_f32"] == n_layers
            assert rec["launches"]["flash_attention_bwd.fma_f32"] == n_layers
            assert rec["launches"]["flash_attention.wgmma_bf16"] == 0
            assert len(rec.get("moe", [])) == len(want.get("moe", []))
            for (d, load), (wd, wload) in zip(rec.get("moe", []), want.get("moe", [])):
                assert np.array_equal(np.rint(np.asarray(load) * 128),
                                      np.rint(np.asarray(wload) * 128))
                assert abs(d - wd) <= 1e-6
                dropped = max(dropped, d)
        assert b["resumed"] == 2 and b["losses"] == a["losses"][2:]
        if a["lead"]:
            assert _trees_equal(a["params"], b["params"])
    assert (dropped > 0) == moe


@pytest.mark.parametrize("arch,changes", [
    ("gemma-2b", {"seq_parallel": True, "mlp_dp": True}),
    ("gemma-2b", {"seq_parallel": True, "d_ff": 129})])
def test_sequence_parallel_mesh_training_on_the_card(cuda, arch, changes):
    """The reduced float32 config with ``seq_parallel`` and a replicated FFN
    (``mlp_dp``, or a d_ff of 129 the model axis does not divide) on the
    tiny mesh, 4 gloo ranks sharing the card, against the same model in
    this process on the CPU from the same weights: losses and global grad
    norms within 1e-4 relative on every rank, K6's float32 forward and
    backward once per layer and step (attention runs on the sequence
    gathered whole), and no step on the card makes another collective than
    the same job's on 4 gloo ranks of the host."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.mesh_runs import run_jobs
    from repro_torch.launch.train import train_run
    from repro_torch.models import init_params, stages_meta
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    n_layers = sum(c for _, c in stages_meta(cfg))
    job = dict(kind="train", mesh="tiny", arch=arch, reduced=True, cfg=changes, steps=3,
               batch=4, seq=30, tcfg=dict(learning_rate=1e-3, warmup_steps=1,
                                          total_steps=3),
               params=_np_tree(init_params(cfg, torch.Generator().manual_seed(0), "cpu")))
    per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cuda", args=([job],),
                         timeout=300)
    on_host = run_ranks(run_jobs, 4, backend="gloo", device="cpu", args=([job],),
                        timeout=300)
    one = train_run(dict(job, mesh=None), torch.device("cpu"))
    for (res,), (host,) in zip(per_rank, on_host):
        for key in ("losses", "grad_norms"):
            for got, want in zip(res[key], one[key]):
                assert abs(got - want) <= 1e-4 * abs(want), key
        for rec, want in zip(res["records"], host["records"]):
            assert rec["launches"]["flash_attention.fma_f32"] == n_layers
            assert rec["launches"]["flash_attention_bwd.fma_f32"] == n_layers
            assert rec["collectives"] == want["collectives"]


def _trees_equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_trees_equal(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


@pytest.mark.parametrize("arch,heads", [
    ("gemma3-4b", None), ("gemma-2b", None), ("internlm2-20b", None),
    ("command-r-35b", None), ("grok-1-314b", None),
    ("llama4-maverick-400b-a17b", None),
    ("internlm2-20b", (12, 2)), ("grok-1-314b", (12, 2)),
    ("llama4-maverick-400b-a17b", (10, 2)),
    ("hymba-1.5b", None), ("hymba-1.5b", (10, 2)), ("xlstm-1.3b", None),
    ("phi-3-vision-4.2b", None)])
def test_reduced_serve_on_the_card_runs_the_attention_kernels(cuda, arch, heads):
    """The reduced config served on the card launches K6 once per attention
    layer and prefill sub-batch and K7 once per attention layer and decode
    step (none for xlstm, which has no attention layer), and matches the
    same weights served on the CPU token for token (float32; the random
    model's logits are far from ties).  ``heads`` (H, KV) restores the
    config's own group size (the reduced configs have G = 1): G = 6
    (internlm2, grok with its soft-cap) and 5 (llama4, hymba)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models import Model, init_params, stages_meta
    from repro_torch.models.transformer import has_attention
    from repro_torch.serving import Request, ServingEngine
    cfg = reduced_config(get_config(arch))
    if heads:
        cfg = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
    n_layers = sum(c for k, c in stages_meta(cfg) if has_attention(k))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
            for i, n in enumerate((12, 12, 5))]
    kernels.reset_launch_counts()
    got, stats = ServingEngine(Model(cfg), on_card, s_max=32).serve(reqs, 1)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == n_layers * stats["latency"]["n_batches"]
    assert counts["decode_attention"] == n_layers * stats["decode_steps"]
    # the reduced configs are float32: every prefill ran the FMA variant
    assert kernels.variant_counts() == {
        "flash_attention.wgmma_bf16": 0,
        "flash_attention.fma_f32": counts["flash_attention"], **_NO_BWD}
    want, _ = ServingEngine(Model(cfg), params, s_max=32).serve(reqs, 1)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid])


def test_reduced_whisper_on_the_card_matches_the_cpu(cuda):
    """The reduced whisper transcribes the same tokens on the card as on the
    CPU from the same weights (float32): K6 once per encoder layer, twice
    per decoder layer in the prefill (self, then cross at Sk != S), K7
    twice per decoder layer and decode step (``kernels.shape_counts``: the
    encoder's non-causal calls, the causal and cross calls, and the decode
    steps over the 12-row self cache and over the encoder's rows)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.launch.serve_profile import transcribe
    from repro_torch.models import Model, init_params
    cfg = reduced_config(get_config("whisper-base"))
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy((rng.normal(size=(3, cfg.encoder_len, cfg.d_model))
                               * 0.05).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 4)))
    kernels.reset_launch_counts()
    got, stats = transcribe(Model(cfg), _to(host, cuda), frames.to(cuda),
                            prompt.to(cuda), 8, 12)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == cfg.n_encoder_layers + 2 * cfg.n_layers
    assert counts["decode_attention"] == 2 * cfg.n_layers * stats["decode_steps"]
    steps = cfg.n_layers * stats["decode_steps"]
    assert kernels.shape_counts() == {
        "flash_attention.causal": cfg.n_layers, "flash_attention.full": cfg.n_encoder_layers,
        "flash_attention.cross": cfg.n_layers, "decode_attention.rows=12": steps,
        f"decode_attention.rows={cfg.encoder_len}": steps,
        **{f"flash_attention_bwd.{m}": 0 for m in ("causal", "full", "cross")}}
    want, _ = transcribe(Model(cfg), host, frames, prompt, 8, 12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b",
                                  "internlm2-20b", "gemma3-4b", "hymba-1.5b",
                                  "xlstm-1.3b", "phi-3-vision-4.2b",
                                  "whisper-base"])
def test_decode_step_reads_nothing_back_to_the_host(cuda, arch):
    """A decode step of the reduced config on the card makes no host sync:
    the MoE layers count their routing into tensors of a fixed length, the
    expert placement (llama4's greedy one) is on the card from the prefill
    on, a dense model makes no aux-loss tensor, and the rotary tables and
    gemma's embedding scale take host scalars.  Counted with torch's
    sync-debug mode, which warns once per synchronising call."""
    import warnings
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models import Model, init_params
    cfg = reduced_config(get_config(arch))
    params = _to(init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cuda)
    model = Model(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9))).to(cuda)
    enc = None
    if cfg.n_encoder_layers:   # whisper: the cross K/V, made before the step
        frames = torch.randn((2, cfg.encoder_len, cfg.d_model), device=cuda)
        enc = model.cross_kv(params, model.encode(params, frames))
    logits, cache = model.prefill(params, {"tokens": toks}, 16, enc_out=enc)
    token = logits.argmax(-1)
    pos = torch.full((2,), 9, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.decode_step(params, token, cache, pos, enc_out=enc)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in seen
             if "synchronizing CUDA operation" in str(w.message)]
    assert syncs == []


# ---------------------------------------------------------------------------
# tile selection (kernels.autotune): every K2 lanes candidate and every K4
# split candidate against the plain versions, the tuner, the auto mine
# ---------------------------------------------------------------------------

@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "autotune.json"))
    autotune.reset()
    yield tmp_path
    autotune.reset()


# (P, W, Q, n_valid): V = 4 and V = 1 rows (W % 4), pad tails, Q one past
# each tile (8, 64, 128 pairs) and many tiles
LANES_SHAPES = [(30, 100, 129, 120), (30, 100, 65, 61), (10, 3125, 9, 9),
                (40, 7, 300, 250), (40, 25, 389, 389), (600, 100, 20000, 19000),
                (852, 3125, 4096, 3176), (75, 128, 768, 666)]


@pytest.mark.parametrize("lanes", [8, 16, 32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q,nv", LANES_SHAPES)
def test_every_lanes_candidate_is_exact(cuda, p, w, q, nv, mode, lanes):
    from repro_torch.kernels.fused_intersect.fused_intersect import (
        compact_shape, compact_survivors_pairs, cuda_compact_shape,
        fused_intersect_compact_pairs)
    assert cuda_compact_shape(lanes, w)[:5] == compact_shape(lanes)
    args, ms = _pair_args(p, w, q, seed=p + w + q + mode + lanes, device=cuda)
    got = fused_intersect_compact_pairs(*args, ms, nv, mode=mode, lanes=lanes)
    want = fused_intersect_compact_ref(*args, ms, nv, mode=mode)
    for g, e in zip(got, want):
        assert torch.equal(g.reshape(-1), e.reshape(-1).to(g.dtype))
    flags = fused_intersect_ref(*args, ms, mode=mode)[2]
    flags[nv:] = 1
    given = compact_survivors_pairs(*args[:3], flags.clone(), nv, mode=mode,
                                    lanes=lanes)
    want = compact_survivors_ref(*args[:3], flags.clone(), nv, mode=mode)
    for g, e in zip(given, want):
        assert torch.equal(g.reshape(-1), e.reshape(-1).to(g.dtype))


@pytest.mark.parametrize("n,w", [(187, 3125), (870, 256), (75, 16), (37, 100)])
def test_every_split_candidate_is_exact(cuda, n, w):
    from repro_torch.kernels import autotune
    from repro_torch.kernels.trimatrix import plan_for, trimatrix
    rng = np.random.default_rng(n * w)
    bm = words_from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32), cuda)
    want = trimatrix_ref(bm)
    for split in autotune.split_candidates(n, w, autotune.device_kind(cuda)):
        assert torch.equal(trimatrix(bm, plan_for(w, split)), want), split


@pytest.mark.parametrize("kernel,q,w,rows", [("compact", 4096, 100, 2000),
                                             ("compact", 1024, 3125, 500),
                                             ("trimatrix", 75, 16, None)])
def test_tune_shape_writes_its_table(cuda, tune_cache, kernel, q, w, rows):
    import json
    from repro_torch.kernels import autotune
    kernels.reset_launch_counts()
    before = autotune.launches
    rec = autotune.tune_shape(kernel, q, w, 0, device=cuda, rows=rows, reps=5)
    assert autotune.launches > before
    assert not any(kernels.launch_counts().values())   # counted apart
    assert rec["kind"] == torch.cuda.get_device_name(0)
    assert rec["clock"] == "cuda_events" and rec["ms"] <= rec["default_ms"]
    assert str(rec["default"]) in rec["candidates"]
    data = json.loads((tune_cache / "autotune.json").read_text())
    assert data["shapes"][rec["key"]]["measured_ms"] == rec["ms"]
    cfg = autotune.table_config(kernel, q, w, 0, cuda)
    assert cfg == autotune.KernelConfig(**rec["config"])


def test_auto_never_picks_ref_on_the_card(cuda, tune_cache, monkeypatch):
    """A crossover table of this card whose cell is won by ``ref`` still
    mines through the kernels under backend="auto"."""
    import json
    from repro_torch.core import engine as eng
    from repro_torch.data import generate
    table = tune_cache / "BENCH_torch_kerneltune.json"
    table.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                 "crossover": [{"q": 666, "w": 100,
                                                "best_single": "ref",
                                                "best_mesh": None}]}))
    monkeypatch.setenv(eng.KERNELTUNE_ENV, str(table))
    txns, spec = generate("chess", scale=1.0, seed=0)
    kernels.reset_launch_counts()
    res = mine(txns, spec.n_items, EclatConfig(min_sup=0.7, backend="auto"))
    assert res.stats["backend"] == "fused"
    assert res.stats["dispatch"]["policy"] == str(table)
    assert support_checksum(res.support_map()) == "fc427bbc1d53e5f2"
    counts = kernels.launch_counts()
    assert counts["fused_intersect_compact"] == len(res.stats["pair_padding"]["per_level"])
    assert counts["trimatrix"] == 1


def test_auto_and_autotune_mines_on_the_card(cuda, tune_cache, monkeypatch):
    """chess 0.7 through backend="auto" (a crossover table of this card),
    autotune=True (tuning, then warm) and a block_w: the pinned checksum,
    K2 once per expansion, K4 once, the tuner's launches counted apart."""
    import json
    from repro_torch.core import engine as eng
    from repro_torch.data import generate
    from repro_torch.kernels import autotune
    table = tune_cache / "BENCH_torch_kerneltune.json"
    table.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                 "crossover": [{"q": 666, "w": 100,
                                                "best_single": "fused",
                                                "best_mesh": None}]}))
    monkeypatch.setenv(eng.KERNELTUNE_ENV, str(table))
    txns, spec = generate("chess", scale=1.0, seed=0)
    for kw in (dict(backend="auto"), dict(autotune=True), dict(autotune=True),
               dict(block_w=256)):
        kernels.reset_launch_counts()
        res = mine(txns, spec.n_items, EclatConfig(min_sup=0.7, **kw))
        assert support_checksum(res.support_map()) == "fc427bbc1d53e5f2", kw
        counts = kernels.launch_counts()
        n_exp = len(res.stats["pair_padding"]["per_level"])
        assert counts["fused_intersect_compact"] == n_exp, kw
        assert counts["trimatrix"] == 1 and counts["fused_intersect"] == 0, kw
        if "backend" in kw:
            assert res.stats["dispatch"]["policy"] == str(table)
    assert any(k.startswith("compact") for k in autotune.load_table().entries)


# ---------------------------------------------------------------------------
# the mining path's steady-state guard (repro_torch.staticcheck, Layer 3 and 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compact", [True, False])
def test_warm_mine_makes_exactly_its_declared_syncs(cuda, compact):
    """A warm mine() on the fused backend: every level's host syncs equal
    its SYNC_BUDGET entry, the rest of the run those of one co-occurrence
    count, no new allocator segment, every padding on the ladder."""
    from repro_torch.staticcheck.shapes import audit_mine
    findings, summary = audit_mine("fused", compact=compact)
    assert findings == [], [f.format() for f in findings]
    assert summary["levels"] >= 3 and summary["checks"] == ["SH001", "SH002", "SH003"]
    for lv in summary["syncs"]["per_level"]:
        assert lv["counted"] == lv["declared"]
    out = summary["syncs"]["outside_levels"]
    assert out["counted"] == out["declared"] == {"device.words_upload": 1,
                                                 "triangular.counts_readback": 1}
    assert summary["allocator"] == {"segments_added": 0, "alloc_retries": 0}


@pytest.mark.parametrize("compact", [True, False])
def test_warm_stream_slides_make_exactly_their_declared_syncs(cuda, compact):
    """Five audited slides of the fused stream: each level's and each
    slide's syncs equal their SYNC_BUDGET entries."""
    from repro_torch.staticcheck.shapes import audit_streaming
    findings, summary = audit_streaming("fused", compact=compact)
    assert findings == [], [f.format() for f in findings]
    assert summary["audited_slides"] == 5
    for slide in summary["syncs"]:
        assert slide["counted"]["outside_levels"] == slide["declared"]["outside_levels"]
        assert slide["levels"] >= 3
        for got in slide["counted"]["per_level"]:
            assert got == slide["declared"]["per_level"]


def test_shape_fixture_trips_every_rule_on_the_card(cuda):
    from repro_torch.staticcheck.shapes import check_shape_fixture
    assert {f.rule for f in check_shape_fixture("cuda")} == {"SH001", "SH002", "SH003"}


def test_card_sync_fixture_fails_only_through_the_profiler(cuda):
    """The fixture's cudaEventSynchronize inside a level: the warn mode
    counts nothing, the profiler one sync over the level's budget of 0."""
    from repro_torch.staticcheck.shapes import check_card_sync_fixture
    findings, seen = check_card_sync_fixture("cuda")
    assert seen["warn_mode"] == {}
    assert seen["card"] == {"syncs": 1, "d2h": 0, "total": 1}
    assert [f.rule for f in findings] == ["SH002"] and "profiler" in findings[0].message


@pytest.mark.parametrize("compact", [True, False])
def test_the_card_synchronises_within_the_budget(cuda, compact):
    """A warm mine's levels and the rest of its run: the profiler's count
    of what the card synchronised on equals each unit's budget total."""
    from repro_torch.staticcheck.shapes import audit_mine, budget_total
    findings, summary = audit_mine("fused", compact=compact)
    assert findings == [], [f.format() for f in findings]
    per_level = budget_total({"level": 1, "level without compaction": int(not compact)})
    for lv in summary["syncs"]["per_level"]:
        assert lv["card"]["total"] == per_level
    assert summary["syncs"]["outside_levels"]["card"]["total"] == budget_total(
        {"co-occurrence count": 1})


def test_collective_contracts_on_ranks_sharing_the_card(cuda):
    """Layer 2 on 4 gloo ranks sharing the card: every backend and the ring
    write within their budgets, each contract fixture rejected."""
    from repro_torch.staticcheck import contracts
    findings, summary = contracts.check_all_contracts(
        "cuda", tuple(contracts.CONTRACT_FIXTURES))
    assert findings == [], [f.format() for f in findings]
    assert all(summary["fixtures"].values()), summary["fixtures"]
