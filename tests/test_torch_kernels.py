"""The port's kernel modules against the reference package's kernels: the
plain torch versions (``ref.py``, reached through ``ops`` for CPU tensors)
equal the Pallas kernels run in interpret mode and their jnp oracles, bit
for bit; and the CPU path never touches a launch counter.  The CUDA kernels
against the plain versions on the card are in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.fused_intersect import (fused_intersect_compact_pairs as
                                           j_compact_kernel)
from repro.kernels.fused_intersect import fused_intersect_pairs as j_kernel
from repro.kernels.fused_intersect.ref import (fused_intersect_compact_ref as
                                               j_compact_ref)
from repro.kernels.fused_intersect.ref import fused_intersect_ref as j_ref
from repro.kernels.trimatrix import trimatrix as j_trimatrix
from repro.kernels.trimatrix import trimatrix_ref as j_trimatrix_ref
from repro.core.bitmap import popcount_np

from repro_torch import kernels as tk
from repro_torch.device import words_from_numpy, words_to_numpy
from repro_torch.kernels.fused_intersect import (compact_survivors,
                                                 fused_intersect,
                                                 fused_intersect_compact,
                                                 fused_intersect_compact_ref,
                                                 fused_intersect_partial,
                                                 fused_intersect_ref)
from repro_torch.kernels.popcount_support import intersect_support
from repro_torch.kernels.trimatrix import cooccurrence, trimatrix_ref
from repro_torch.kernels.decode_attention import grouped_decode_attention
from repro_torch.kernels.flash_attention import multi_head_attention

MODES = [0, 1, 2]
# (P, W, Q, n_valid): singleton, W not a multiple of 128 (two interpret-mode
# word blocks), a padded tail (n_valid < Q)
PAIR_SHAPES = [(1, 1, 1, 1), (9, 5, 7, 7), (20, 130, 13, 9), (33, 7, 40, 40)]


def _pair_case(p, w, q, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (p, w), dtype=np.uint32)
    left = rng.integers(0, p, q).astype(np.int32)
    right = rng.integers(0, p, q).astype(np.int32)
    sup_left = popcount_np(words[left]).sum(-1).astype(np.int32)
    return words, left, right, sup_left


def _median_min_sup(words, left, right):
    return int(np.median(popcount_np(words[left] & words[right]).sum(-1)))


def _torch_args(words, left, right, sup_left, device="cpu"):
    return (words_from_numpy(words, device),
            torch.from_numpy(left).to(device), torch.from_numpy(right).to(device),
            torch.from_numpy(sup_left).to(device))


def _jax_args(words, left, right, sup_left):
    return (jnp.asarray(words), jnp.asarray(left), jnp.asarray(right),
            jnp.asarray(sup_left))


def _eq_words(t, j):
    np.testing.assert_array_equal(words_to_numpy(t), np.asarray(j))


def _eq_ints(t, j):
    np.testing.assert_array_equal(t.cpu().numpy().reshape(-1),
                                  np.asarray(j).reshape(-1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q,nv", PAIR_SHAPES)
def test_fused_intersect_ref_matches_pallas_kernel_and_oracle(p, w, q, nv, mode):
    words, left, right, sup_left = _pair_case(p, w, q, seed=p + w + q + mode)
    ms = _median_min_sup(words, left, right)
    inter, sup, mask = fused_intersect(*_torch_args(words, left, right, sup_left),
                                       ms, mode=mode)
    for ji, js, jm in (j_kernel(*_jax_args(words, left, right, sup_left), ms,
                                mode=mode, block_w=128, interpret=True),
                       j_ref(*_jax_args(words, left, right, sup_left), ms,
                             mode=mode)):
        _eq_words(inter, ji)
        _eq_ints(sup, js)
        _eq_ints(mask, jm)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q,nv", PAIR_SHAPES)
@pytest.mark.parametrize("survivors", ["median", "none", "all"])
def test_fused_intersect_compact_ref_matches_pallas(p, w, q, nv, mode, survivors):
    """(sup, mask, S) exactly, rows [:S] exactly, pad rows equal to row 0 of
    the uncompacted intersection — against the interpret-mode kernel and the
    jnp oracle."""
    words, left, right, sup_left = _pair_case(p, w, q, seed=3 * p + w + q + mode)
    ms = {"median": _median_min_sup(words, left, right), "none": 10**6,
          "all": 0}[survivors]
    compact, sup, mask, n_surv = fused_intersect_compact(
        *_torch_args(words, left, right, sup_left), ms, nv, mode=mode)
    s = int(n_surv)
    expect_s = {"none": 0, "all": nv}.get(survivors)
    if expect_s is not None:
        assert s == expect_s
    for jc, js, jm, jn in (
            j_compact_kernel(*_jax_args(words, left, right, sup_left), ms, nv,
                             mode=mode, block_w=128, interpret=True),
            j_compact_ref(*_jax_args(words, left, right, sup_left), ms, nv,
                          mode=mode)):
        assert s == int(jn)
        _eq_ints(sup, js)
        _eq_ints(mask, jm)
        _eq_words(compact[:s], np.asarray(jc)[:s])
        _eq_words(compact, jc)
    inter, _, _ = fused_intersect_ref(*_torch_args(words, left, right, sup_left),
                                      ms, mode=mode)
    assert torch.equal(compact[s:], inter[:1].expand(q - s, w))


@pytest.mark.parametrize("n,w", [(1, 1), (9, 5), (33, 7), (20, 130)])
def test_trimatrix_ref_matches_pallas_kernel_and_oracle(n, w):
    words = np.random.default_rng(n * w).integers(0, 2**32, (n, w), dtype=np.uint32)
    got = cooccurrence(words_from_numpy(words, "cpu")).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        j_trimatrix(jnp.asarray(words), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(j_trimatrix_ref(jnp.asarray(words))))


def test_trimatrix_ref_row_blocks_agree():
    """The row-blocked plain version gives the same matrix at any block."""
    words = words_from_numpy(np.random.default_rng(1).integers(
        0, 2**32, (17, 9), dtype=np.uint32), "cpu")
    full = trimatrix_ref(words)
    for block in (1, 9 * 5, 17 * 9 * 3):
        assert torch.equal(trimatrix_ref(words, block_elems=block), full)


def test_cpu_tensors_never_touch_launch_counters():
    tk.reset_launch_counts()
    words, left, right, sup_left = _pair_case(9, 5, 7, seed=0)
    args = _torch_args(words, left, right, sup_left)
    fused_intersect(*args, 3, mode=0)
    fused_intersect_compact(*args, 3, 5, mode=1)
    fused_intersect_partial(*args[:3], mode=2, store=False)
    compact_survivors(*args[:3], torch.ones(7, dtype=torch.int32), 5, mode=0)
    intersect_support(args[0], args[0])
    cooccurrence(args[0])
    q = torch.zeros((1, 4, 8, 16))
    multi_head_attention(q, q[:, :2], q[:, :2])
    grouped_decode_attention(q[:, :2, :2], q.transpose(1, 2)[:, :, :2],
                             q.transpose(1, 2)[:, :, :2],
                             torch.tensor([3], dtype=torch.int32))
    assert tk.launch_counts() == {"fused_intersect": 0,
                                  "fused_intersect_compact": 0,
                                  "fused_intersect_partial": 0, "trimatrix": 0,
                                  "flash_attention": 0, "decode_attention": 0,
                                  "popcount_support": 0}


def test_cuda_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.fused_intersect import (
        fused_intersect_compact_pairs, fused_intersect_pairs,
        fused_support_pairs)
    from repro_torch.kernels.trimatrix import trimatrix
    tk.reset_launch_counts()
    words, left, right, sup_left = _pair_case(9, 5, 7, seed=0)
    args = _torch_args(words, left, right, sup_left)
    with pytest.raises(ValueError, match="CUDA"):
        fused_intersect_pairs(*args, 3, mode=0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_support_pairs(*args, 3, mode=0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_intersect_compact_pairs(*args, 3, 5, mode=0)
    with pytest.raises(ValueError, match="CUDA"):
        trimatrix(args[0])
    assert not any(tk.launch_counts().values())


# ---------------------------------------------------------------------------
# K3: the shard-local partial popcount of the word-sharded backends
# ---------------------------------------------------------------------------

# (P, W, Q, n_shards): W = 101 and 9 are no multiple of 4 (the last slice
# ends in zero pad words), Q = 0 and Q = 1, a slice of one word
PARTIAL_SHAPES = [(20, 101, 13, 4), (9, 9, 40, 4), (7, 6, 0, 2),
                  (5, 13, 1, 4), (12, 3, 17, 3)]


def _word_slices(words, n):
    """Every rank's (P, ceil(W / n)) slice of a zero-padded frontier."""
    ws = -(-words.shape[1] // n)
    padded = np.zeros((words.shape[0], ws * n), np.uint32)
    padded[:, :words.shape[1]] = words
    return [padded[:, i * ws:(i + 1) * ws] for i in range(n)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q,n", PARTIAL_SHAPES)
def test_fused_intersect_partial_ref_matches_pallas_kernel_and_oracle(p, w, q, n, mode):
    from repro.kernels.fused_intersect import fused_intersect_partial_pairs as j_partial
    from repro.kernels.fused_intersect.ref import fused_intersect_partial_ref as j_partial_ref
    from repro_torch.kernels.fused_intersect import fused_intersect_partial_ref
    words, left, right, _ = _pair_case(p, w, q, seed=p * 31 + w + q)
    total = np.zeros(q, np.int64)
    for block in _word_slices(words, n):
        bm, l, r = (words_from_numpy(block, "cpu"), torch.from_numpy(left),
                    torch.from_numpy(right))
        got_inter, got_pop = fused_intersect_partial_ref(bm, l, r, mode=mode)
        jargs = (jnp.asarray(block), jnp.asarray(left), jnp.asarray(right))
        want_ref = j_partial_ref(*jargs, mode=mode)
        wants = [want_ref]
        if q:
            wants.append(j_partial(*jargs, mode=mode, interpret=True))
        for want_inter, want_pop in wants:
            assert np.array_equal(words_to_numpy(got_inter),
                                  np.asarray(want_inter).reshape(q, block.shape[1]))
            assert np.array_equal(got_pop.numpy(), np.asarray(want_pop))
        # the dispatch on a CPU tensor is the plain version, with or without
        # the (Q, Ws) store
        inter, pop = fused_intersect_partial(bm, l, r, mode=mode)
        assert torch.equal(inter, got_inter) and torch.equal(pop, got_pop)
        none, pop = fused_intersect_partial(bm, l, r, mode=mode, store=False)
        assert none is None and torch.equal(pop, got_pop)
        total += got_pop.numpy()
    # the slices' counts sum to the count of the whole rows
    _, whole = fused_intersect_partial_ref(words_from_numpy(words, "cpu"),
                                           torch.from_numpy(left),
                                           torch.from_numpy(right), mode=mode)
    assert np.array_equal(total, whole.numpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q,nv", PAIR_SHAPES)
def test_compact_survivors_ref_matches_compact_epilogue(p, w, q, nv, mode):
    """The compaction from a given mask equals the reference's epilogue on
    the same mask (the word-sharded backends compact after the reduce)."""
    from repro.kernels.fused_intersect import compact_epilogue as j_epilogue
    from repro_torch.kernels.fused_intersect import compact_survivors_ref
    words, left, right, sup_left = _pair_case(p, w, q, seed=p + 5 * w + q)
    mask = (np.arange(q) % 3 != 1).astype(np.int32)
    targs = _torch_args(words, left, right, sup_left)
    got = compact_survivors_ref(*targs[:3], torch.from_numpy(mask), nv, mode=mode)
    inter, _ = j_ref(*_jax_args(words, left, right, sup_left), 0, mode=mode)[:2]
    want = j_epilogue(inter, jnp.asarray(sup_left), jnp.asarray(mask), jnp.int32(nv))
    assert np.array_equal(words_to_numpy(got[0]), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[2]))
    assert int(got[2]) == int(want[3])


# ---------------------------------------------------------------------------
# K5: popcount_support (no mining path calls it)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,w", [(1, 1), (9, 5), (300, 130), (0, 4), (7, 513)])
def test_popcount_support_ref_matches_pallas_kernel_and_oracle(m, w):
    from repro.kernels.popcount_support import popcount_support as j_ps
    from repro.kernels.popcount_support import popcount_support_ref as j_ps_ref
    from repro_torch.kernels.popcount_support import popcount_support_ref
    rng = np.random.default_rng(m * 7 + w)
    a = rng.integers(0, 2**32, (m, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, w), dtype=np.uint32)
    got = popcount_support_ref(words_from_numpy(a, "cpu"), words_from_numpy(b, "cpu"))
    wants = [j_ps_ref(jnp.asarray(a), jnp.asarray(b))]
    if m:
        wants.append(j_ps(jnp.asarray(a), jnp.asarray(b), block_m=128,
                          block_w=128, interpret=True))
    for want_inter, want_sup in wants:
        assert np.array_equal(words_to_numpy(got[0]), np.asarray(want_inter))
        assert np.array_equal(got[1].numpy(), np.asarray(want_sup))
    via = intersect_support(words_from_numpy(a, "cpu"), words_from_numpy(b, "cpu"))
    assert torch.equal(via[0], got[0]) and torch.equal(via[1], got[1])


# ---------------------------------------------------------------------------
# K4 on the tensor cores: the emulation of its arithmetic and its split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w,splits", [(1, 1, 1), (9, 5, 1), (9, 5, 2), (9, 5, 5),
                                        (33, 7, 1), (33, 7, 3), (33, 7, 7),
                                        (20, 130, 1), (20, 130, 17),
                                        (20, 130, 130)])
def test_trimatrix_unpacked_ref_matches_mxu_ref_and_pallas(n, w, splits):
    """The card kernel's arithmetic (0/1 indicator, one integer product per
    range of words, the ranges summed) equals the reference's MXU oracle
    over all 32 W bits and its Pallas kernel in interpret mode, for one
    range, several and one per word."""
    from repro.kernels.trimatrix.ref import cooccurrence_mxu_ref
    from repro_torch.kernels.trimatrix import trimatrix_unpacked_ref
    words = np.random.default_rng(n * 7 + w).integers(0, 2**32, (n, w), dtype=np.uint32)
    got = trimatrix_unpacked_ref(words_from_numpy(words, "cpu"), splits).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        cooccurrence_mxu_ref(jnp.asarray(words), n_txn=32 * w)))
    np.testing.assert_array_equal(got, np.asarray(
        j_trimatrix(jnp.asarray(words), interpret=True)))


@pytest.mark.parametrize("n,w", [(187, 3125), (4096, 3125), (37, 100), (1000, 3125),
                                 (1, 1), (65, 7), (129, 8), (300, 9), (187, 0),
                                 (870, 256), (75, 16)])
def test_trimatrix_split_plan_covers_every_word_once(n, w):
    """The word ranges of the split plan cover [0, W) once, none empty, each
    a whole number of stages but the last; T10I4D100K's N = 187 fills the
    132 SMs, the 4,096-item cap keeps one range."""
    from repro_torch.kernels.trimatrix.trimatrix import (SMS, STAGE_WORDS,
                                                          split_plan, tile_count)
    splits, split_words = split_plan(n, w)
    assert split_words % STAGE_WORDS == 0 and 1 <= splits <= 65535
    ranges = [(s * split_words, min(w, (s + 1) * split_words)) for s in range(splits)]
    covered = np.zeros(w, np.int64)
    for lo, hi in ranges:
        assert lo < hi or (w == 0 and splits == 1)
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if (n, w) == (187, 3125):
        assert tile_count(n) * splits >= SMS
    if (n, w) == (4096, 3125):
        assert splits == 1



@pytest.mark.parametrize("w", [256, 16, 3125, 7, 8, 1])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_trimatrix_plan_for_covers_every_word_once(w, splits):
    """A forced split (the timing sweep at the streaming miner's block
    shapes) is a plan the CUDA launcher accepts: whole stages, at most
    ``splits`` ranges, none empty, covering [0, W) once."""
    from repro_torch.kernels.trimatrix import plan_for
    from repro_torch.kernels.trimatrix.trimatrix import STAGE_WORDS
    used, split_words = plan_for(w, splits)
    assert split_words % STAGE_WORDS == 0 and 1 <= used <= splits
    # the launcher's check (csrc/trimatrix.cu trimatrix_launch)
    assert (used - 1) * split_words < max(w, 1) <= used * split_words
    if w == 256:
        assert used == splits


# ---------------------------------------------------------------------------
# K2's one-pass compaction: the plain versions at the look-back's edges
# ---------------------------------------------------------------------------

# (P, W, Q, n_valid): Q = 1; one past a tile of 8 (rows of W = 3125 words,
# a warp per pair) and of 128 pairs (W = 100: 8 lanes per pair); Q over 3 and
# more tiles; n_valid = 0
EDGE_SHAPES = [(4, 3, 1, 1), (10, 3125, 9, 9), (30, 100, 129, 129),
               (30, 100, 129, 120), (40, 25, 389, 389), (40, 25, 389, 300),
               (12, 33, 300, 0)]


@pytest.mark.parametrize("survivors", ["median", "none", "all"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,w,q,nv", EDGE_SHAPES)
def test_compaction_refs_match_compact_epilogue_at_tile_edges(p, w, q, nv, mode,
                                                              survivors):
    """Both front ends' plain versions (fused: threshold inside; given: the
    mask from outside) equal the reference's compact_epilogue and its fused
    oracle at the tile edges: S = 0 and S = n_valid, n_valid = 0 and < Q."""
    from repro.kernels.fused_intersect import compact_epilogue as j_epilogue
    from repro_torch.kernels.fused_intersect import compact_survivors_ref
    words, left, right, sup_left = _pair_case(p, w, q, seed=11 * p + w + q + mode)
    ms = {"median": _median_min_sup(words, left, right), "none": 10**6,
          "all": -10**6}[survivors]
    targs = _torch_args(words, left, right, sup_left)
    compact, sup, mask, n_surv = fused_intersect_compact_ref(*targs, ms, nv, mode=mode)
    jc, js, jm, jn = j_compact_ref(*_jax_args(words, left, right, sup_left), ms, nv,
                                   mode=mode)
    assert int(n_surv) == int(jn) == {"none": 0, "all": nv}.get(survivors, int(jn))
    _eq_words(compact, jc)
    _eq_ints(sup, js)
    _eq_ints(mask, jm)
    # the given-mask front end on the unmasked threshold flags
    inter, _, flags = j_ref(*_jax_args(words, left, right, sup_left), ms, mode=mode)
    got = compact_survivors_ref(*targs[:3], torch.from_numpy(np.array(flags)), nv,
                                mode=mode)
    want = j_epilogue(inter, jnp.asarray(sup_left), flags, jnp.int32(nv))
    _eq_words(got[0], want[0])
    _eq_ints(got[1], want[2])
    assert int(got[2]) == int(want[3]) == int(n_surv)


def test_kernel_library_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header names a new library, so a stale one is
    never loaded."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._tag(_build._sources())
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._tag(_build._sources()) != before
    assert [p.name for p in _build._sources()] == ["k.cu"]


# ---------------------------------------------------------------------------
# K1 and K3 on the card: tiles of consecutive pairs, a staged window of
# consecutive rows, word chunks -- a numpy emulation of the plan
# ---------------------------------------------------------------------------

_SENTINEL = np.uint32(0xDEADBEEF)   # shared words no copy wrote


def _stage(smem, base, flat, g0, nw, mis):
    """One staged segment as ``stage_window`` copies it: the frontier's
    words ``[g0, g0 + nw)`` land at shared words ``base + o + j``; the
    16-byte aligned interior goes by one bulk copy, which must be aligned
    and a whole number of 16 bytes on both sides, the 0-3 words before and
    after it one by one."""
    o = (mis + g0) & 3
    head = min((4 - o) & 3, nw)
    body = (nw - head) & ~3
    if body:
        assert (mis + g0 + head) % 4 == 0 and (base + o + head) % 4 == 0
    assert nw - head - body < 4
    smem[base + o:base + o + nw] = flat[g0:g0 + nw]
    return o


def _emulate_window_pairs(words, left, right, mode, plan, mis=0):
    """K1/K3's tiles, window and chunks in numpy: per tile of ``plan.tile``
    consecutive pairs, the window rows ``[lo, hi]`` (lo the first left row,
    hi the largest operand row below lo + rows) are staged only if at least
    as many operands as pairs lie inside; they are copied chunk by chunk
    into an emulated shared memory of ``plan.smem`` bytes (unwritten words
    hold a sentinel, and chunk c + 1 is staged before chunk c is read, as
    the kernel's two stages are); an operand row inside the window is read
    from it, any other from the frontier.  ``mis`` is the frontier's address
    / 4 mod 4.  Returns ``(inter, pop, staged rows, tiles staged, tiles
    not)``."""
    p_rows, w = words.shape
    flat = words.reshape(-1)
    q = left.shape[0]
    tp, rows, chunk = plan.tile, plan.rows, plan.chunk
    assert 256 % tp == 0 and 1 <= 256 // tp <= 32   # groups of 256 / TP lanes
    whole = chunk >= w
    n_chunks = 1 if whole else -(-w // chunk)
    pitch = chunk + 4
    stage_words = 0 if whole else rows * pitch
    inter = np.zeros((q, w), np.uint32)
    pop = np.zeros(q, np.int64)
    staged = tiles_staged = tiles_not = 0
    for q0 in range(0, q, tp):
        n = min(tp, q - q0)
        ls, rs = left[q0:q0 + n].astype(np.int64), right[q0:q0 + n].astype(np.int64)
        lo = int(ls[0])
        inside = lambda x: x[(x >= lo) & (x < lo + rows)]
        hi = max(lo, int(inside(ls).max(initial=lo)), int(inside(rs).max(initial=lo)))
        n_in = inside(ls).size + inside(rs).size
        n_rows = hi - lo + 1 if n_in >= n else 0
        staged += n_rows
        tiles_staged += n_rows > 0
        tiles_not += n_rows == 0
        smem = np.full(plan.smem // 4, _SENTINEL, np.uint32)

        def stage(c):
            buf = (c & 1) * stage_words
            if whole:
                _stage(smem, buf, flat, lo * w, n_rows * w, mis)
            else:
                c0 = c * chunk
                for i in range(n_rows):
                    o = _stage(smem, buf + i * pitch, flat, (lo + i) * w + c0,
                               min(chunk, w - c0), mis)
                    assert o + min(chunk, w - c0) <= pitch

        if n_rows:
            stage(0)
        for c in range(n_chunks):
            if n_rows and c + 1 < n_chunks:
                stage(c + 1)
            c0 = 0 if whole else c * chunk
            cw = w if whole else min(chunk, w - c0)
            buf = (c & 1) * stage_words

            def row(x):
                i = x - lo
                if 0 <= i < n_rows:
                    start = (buf + ((mis + lo * w) & 3) + i * w if whole
                             else buf + i * pitch + ((mis + x * w + c0) & 3))
                    return smem[start:start + cw]
                return flat[x * w + c0:x * w + c0 + cw]

            for k in range(n):
                a, b = row(int(ls[k])), row(int(rs[k]))
                x = a & b if mode == 0 else (a & ~b if mode == 1 else b & ~a)
                inter[q0 + k, c0:c0 + cw] = x
                pop[q0 + k] += int(popcount_np(x).sum())
    return inter, pop, staged, tiles_staged, tiles_not


def _window_family(family, w, seed):
    """Pair inputs of one family on the CPU: class-ordered pairs over
    classes of 1-25 rows, the same with a PairBuffers zero-pad tail, random
    pairs, and a class of 300 rows among small ones."""
    from repro_torch.core.engine import PairBuffers
    from repro_torch.core.equivalence import segment_pairs
    from repro_torch.launch.kernel_timing import class_pair_inputs, pair_inputs
    if family == "random":
        return pair_inputs(60, w, 301, seed, device="cpu")
    rng = np.random.default_rng(seed)
    sizes = ([300, 3, 1, 7, 2] if family == "wide_class"
             else rng.integers(1, 26, 8).tolist())
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    n_pairs = segment_pairs(starts, np.asarray(sizes))[0].shape[0]
    if family == "wide_class":
        n_pairs = 1200       # the class's first pairs: its window overflows
    q = n_pairs
    if family == "class_pad":
        zeros = np.zeros(n_pairs, np.int32)
        q = PairBuffers(128).fill(zeros, zeros, zeros)[0]
    return class_pair_inputs(sum(sizes), w, q, n_pairs, seed, sizes=sizes,
                             device="cpu")


def _small_plan(tile, rows, chunk, w):
    """A plan of the kernel's form at sizes the emulation can afford."""
    from repro_torch.kernels.fused_intersect.fused_intersect import WindowPlan
    if chunk >= w:
        return WindowPlan(tile, rows, w, 1, rows * w * 4 + 16)
    return WindowPlan(tile, rows, chunk, 2, 2 * rows * (chunk + 4) * 4)


WINDOW_FAMILIES = ["class", "class_pad", "random", "wide_class"]


@pytest.mark.parametrize("plan_kind", ["kernel", "small"])
@pytest.mark.parametrize("w", [1, 7, 25, 50, 100, 130])
@pytest.mark.parametrize("family", WINDOW_FAMILIES)
def test_window_emulation_matches_partial_ref(family, w, plan_kind):
    """The tile / window / chunk plan gives K3's raw popcounts and rows, and
    with K1's epilogue its supports and mask, equal to the plain versions,
    in every mode and at every frontier alignment: with the kernel's own
    plan and with a small one that chunks the words and overflows the
    window."""
    from repro_torch.kernels.fused_intersect import fused_intersect_partial_ref
    from repro_torch.kernels.fused_intersect.fused_intersect import window_plan
    bm, l, r, s, ms = _window_family(family, w, seed=w + len(family))
    q = l.shape[0]
    plan = window_plan(q, w) if plan_kind == "kernel" else _small_plan(16, 8, 12, w)
    words = words_to_numpy(bm)
    for mode in MODES:
        want_inter, want_pop = fused_intersect_partial_ref(bm, l, r, mode=mode)
        want = fused_intersect_ref(bm, l, r, s, ms, mode=mode)
        for mis in ((0, 1, 2, 3) if mode == 0 else (1,)):
            inter, pop, _, tiles_staged, tiles_not = _emulate_window_pairs(
                words, l.numpy(), r.numpy(), mode, plan, mis)
            assert np.array_equal(inter, words_to_numpy(want_inter))
            assert np.array_equal(pop, want_pop.numpy())
            sup = pop if mode == 0 else s.numpy() - pop
            assert np.array_equal(sup, want[1].numpy())
            assert np.array_equal((sup >= ms).astype(np.int32), want[2].numpy())
        # class-ordered tiles stage their windows; random ones do not
        if family == "random":
            assert tiles_staged <= tiles_not
        else:
            assert tiles_staged > tiles_not


@pytest.mark.parametrize("family", WINDOW_FAMILIES)
def test_window_rows_count_the_emulated_windows(family):
    """kernel_timing.window_rows, which chip_smoke.py prints for the
    recorded pair lists, counts the rows the emulated kernel stages."""
    from repro_torch.launch.kernel_timing import window_rows
    bm, l, r, _, _ = _window_family(family, 7, seed=9)
    words, l, r = words_to_numpy(bm), l.numpy(), r.numpy()
    for plan in (_small_plan(16, 8, 12, 7), _small_plan(32, 64, 12, 7)):
        _, _, staged, _, _ = _emulate_window_pairs(words, l, r, 0, plan)
        assert window_rows(l, r, plan.tile, plan.rows)[0] == staged


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", WINDOW_FAMILIES)
def test_window_emulation_matches_pallas(family, mode):
    """Through the plain version, the emulation is held to the reference
    package's Pallas kernels in interpret mode: K3 (partial popcount) and
    K1 (supports, mask, rows) on the first 40 pairs of each family, with a
    plan of 8-pair tiles, 4-row windows and 4-word chunks."""
    from repro.kernels.fused_intersect import fused_intersect_partial_pairs as j_partial
    bm, l, r, s, ms = _window_family(family, 9, seed=3 + mode)
    l, r, s = l[:40], r[:40], s[:40]
    words = words_to_numpy(bm)
    inter, pop, _, _, _ = _emulate_window_pairs(words, l.numpy(), r.numpy(), mode,
                                                _small_plan(8, 4, 4, 9), mis=3)
    jargs = (jnp.asarray(words), jnp.asarray(l.numpy()), jnp.asarray(r.numpy()))
    j_inter, j_pop = j_partial(*jargs, mode=mode, interpret=True)
    np.testing.assert_array_equal(inter, np.asarray(j_inter))
    np.testing.assert_array_equal(pop, np.asarray(j_pop))
    j_inter, j_sup, j_mask = j_kernel(*_jax_args(words, l.numpy(), r.numpy(), s.numpy()),
                                      ms, mode=mode, interpret=True)
    sup = pop if mode == 0 else s.numpy() - pop
    np.testing.assert_array_equal(sup, np.asarray(j_sup))
    np.testing.assert_array_equal((sup >= ms).astype(np.int32), np.asarray(j_mask))
    np.testing.assert_array_equal(inter, np.asarray(j_inter)[:, :9])


# static shared memory of the window kernels: left, right and sup_left of
# 256 pairs, and a word per warp
_WINDOW_STATIC_SMEM = 3 * 256 * 4 + 8 * 4


@pytest.mark.parametrize("q", [1, 100, 4096, 16_896, 33_792, 393_216])
def test_window_plan_fits_shared_memory(q):
    """For every row width from 1 to 3,125 words, the plan's stages fit the
    227 KB a block may use, chunks are whole 16-byte slots, and the tile's
    pairs take all 256 threads in groups of 1 to 32 lanes."""
    from repro_torch.kernels.fused_intersect.fused_intersect import window_plan
    for w in range(1, 3126):
        plan = window_plan(q, w)
        assert plan.smem + _WINDOW_STATIC_SMEM <= 227 * 1024, (q, w, plan)
        lanes = 256 // plan.tile
        assert lanes * plan.tile == 256 and 1 <= lanes <= 32
        assert plan.rows >= plan.tile
        if plan.stages == 1:
            assert plan.chunk == w and plan.smem >= (plan.rows * w + 3) * 4
        else:
            assert plan.stages == 2 and 0 < plan.chunk < w and plan.chunk % 4 == 0
            assert plan.smem == 2 * plan.rows * (plan.chunk + 4) * 4
            assert (plan.chunk + 4) % 32 == max(lanes, 4) % 32


def test_window_plan_at_the_main_path_shapes():
    """chess level 5 (Q = 393,216) stages whole rows at every slice width
    with a thread per pair; T10I4D100K level 3 (Q = 4,096) takes 16-pair
    tiles, whole rows of its 4-shard slice and word chunks above."""
    from repro_torch.kernels.fused_intersect.fused_intersect import window_plan
    for w in (25, 50, 100):
        assert window_plan(393_216, w)[:4] == (256, 256, w, 1)
    assert window_plan(4096, 782)[:4] == (16, 32, 782, 1)
    for w in (1563, 3125):
        plan = window_plan(4096, w)
        assert plan.tile == 16 and plan.stages == 2 and plan.chunk < w


def test_miner_inputs_record_the_largest_expansion():
    """The timing inputs are the padded pair block of the mine's largest
    expansion, class-ordered; the spy is gone after the mine."""
    from repro_torch.core.engine import FusedEngine
    from repro_torch.launch.kernel_timing import miner_inputs, rank0_slice
    from repro_torch.dist.sharding import padded_word_count
    before = FusedEngine._intersect_compact
    rng = np.random.default_rng(4)
    txns = [sorted(set(rng.integers(0, 14, rng.integers(3, 9)).tolist()))
            for _ in range(600)]
    rec = miner_inputs(txns, 14, 30, "v4", device="cpu")
    assert FusedEngine._intersect_compact is before
    l, r, nv = rec["left"].numpy(), rec["right"].numpy(), rec["n_valid"]
    assert 0 < nv <= l.shape[0] and (l[nv:] == 0).all() and (r[nv:] == 0).all()
    assert (np.diff(l[:nv]) >= 0).all() and (r[:nv] > l[:nv]).all()
    assert rec["mode"] == 0 and rec["bitmaps"].shape[0] > r.max()
    part = rank0_slice(rec["bitmaps"])
    w = rec["bitmaps"].shape[1]
    assert part.shape == (rec["bitmaps"].shape[0], padded_word_count(w, 4) // 4)
    assert torch.equal(part[:, :min(w, part.shape[1])],
                       rec["bitmaps"][:, :part.shape[1]])
