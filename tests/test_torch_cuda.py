"""The port's CUDA kernels against their plain torch versions, and the
paths that run them (the miner, on one device and on gloo ranks sharing
the card; the sliding-window miner; LM serving), on the card.

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


@pytest.mark.parametrize("b,h,hkv,s,d,window", [
    (1, 8, 4, 37, 256, 8),       # S < 64, a window inside one tile
    (1, 8, 8, 100, 256, 0),      # G = 1, S not a multiple of 64
    (2, 8, 1, 200, 256, 30),     # G = 8, S not a multiple of 128
    (1, 4, 2, 129, 128, 0),      # one row past a 128-row q tile
    (2, 4, 4, 64, 64, 0),        # exactly one tile
    (1, 8, 4, 191, 64, 63),      # a window one row short of a tile
    (2, 4, 1, 50, 16, 8),        # the reduced configs' D
    (1, 2, 2, 1, 16, 0),         # one row
    (1, 8, 4, 700, 256, 1024)])  # a window wider than S
def test_flash_attention_wgmma_bf16(cuda, b, h, hkv, s, d, window):
    """The bf16 tensor-core kernel (and only it) runs bf16 inputs, within
    half a bf16 unit of the float32 plain output and of the float32
    emulation of its split-P arithmetic, the same bits on a second call."""
    q, k, v = _model_layout_qkv(b, h, hkv, s, d, torch.bfloat16, s + d, cuda)
    kernels.reset_launch_counts()
    got = multi_head_attention(q, k, v, causal=True, window=window)
    again = multi_head_attention(q, k, v, causal=True, window=window)
    assert kernels.variant_counts() == {"flash_attention.wgmma_bf16": 2,
                                        "flash_attention.fma_f32": 0}
    assert torch.equal(got, again)
    args = dict(causal=True, window=window or None)
    _assert_attention_close(got, attention_ref(q.float(), k.float(), v.float(), **args))
    _assert_attention_close(got, attention_split_p_ref(q.float(), k.float(),
                                                       v.float(), **args))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (False, 40)])
def test_flash_attention_f32_runs_the_fma_kernel(cuda, causal, window):
    q, k, v = _model_layout_qkv(2, 8, 4, 150, 256, torch.float32, 7, cuda)
    kernels.reset_launch_counts()
    got = multi_head_attention(q, k, v, causal=causal, window=window)
    again = multi_head_attention(q, k, v, causal=causal, window=window)
    assert kernels.variant_counts() == {"flash_attention.wgmma_bf16": 0,
                                        "flash_attention.fma_f32": 2}
    assert torch.equal(got, again)
    _assert_attention_close(got, attention_ref(q, k, v, causal=causal,
                                               window=window or None))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("kv,g", [(4, 1), (4, 2), (2, 4), (1, 8)])
def test_decode_attention_at_chunk_edges(cuda, kv, g, window, dtype):
    """Lengths at the kernel's 64-row chunk edges of a 300-row cache (5
    chunks, the last ragged), every group size, and two calls bit-equal:
    the partials merge in a fixed order."""
    lens = [1, 63, 64, 65, 128, 129, 299, 300]
    gen = torch.Generator(device=cuda).manual_seed(kv * 10 + g)
    q = torch.randn((len(lens), kv, g, 128), generator=gen, device=cuda).to(dtype)
    k, v = torch.randn((2, len(lens), 300, kv, 128), generator=gen,
                       device=cuda).to(dtype)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = grouped_decode_attention(q, k, v, length, window=window)
    again = grouped_decode_attention(q, k, v, length, window=window)
    assert torch.equal(got, again)
    _assert_attention_close(got, decode_attention_ref(
        q.float(), k.float(), v.float(), length, window=window))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma-2b"])
def test_reduced_serve_on_the_card_runs_the_attention_kernels(cuda, arch):
    """The reduced config served on the card launches K6 once per layer and
    prefill sub-batch and K7 once per layer and decode step, and matches
    the same weights served on the CPU token for token (float32; the
    random model's logits are far from ties)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models import Model, init_params, stages_meta
    from repro_torch.serving import Request, ServingEngine
    cfg = reduced_config(get_config(arch))
    n_layers = sum(c for _, c in stages_meta(cfg))
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
        "flash_attention.fma_f32": counts["flash_attention"]}
    want, _ = ServingEngine(Model(cfg), params, s_max=32).serve(reqs, 1)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid])
