"""The port's CUDA kernels against their plain torch versions, and the
paths that run them (the miner, on one device and on gloo ranks sharing
the card; LM serving), on the card.

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

MINING_KERNELS = ("fused_intersect", "fused_intersect_compact", "trimatrix")

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


@pytest.mark.parametrize("n,w", [(1, 1), (33, 7), (187, 3125), (130, 64),
                                 (1000, 100)])
def test_trimatrix_matches_ref(cuda, n, w):
    words = np.random.default_rng(n).integers(0, 2**32, (n, w), dtype=np.uint32)
    t = words_from_numpy(words, cuda)
    assert torch.equal(cooccurrence(t), trimatrix_ref(t))


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
        assert counts["flash_attention"] == counts["decode_attention"] == 0
    cpu = mine(txns, 12, EclatConfig(min_sup=20, variant="v6", p=3,
                                     use_diffsets=True), device="cpu")
    assert sums["fused"] == sums["ref"] == support_checksum(cpu.support_map())


# (P, Ws, Q): a slice of one word, Ws = 25 (chess at 4 word shards, 7 idle
# lanes), Q = 0 and 1, several pair blocks
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
