"""The port's CUDA kernels against their plain torch versions, and the
paths that run them (the miner, LM serving), on the card.

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
from repro_torch.kernels.fused_intersect import (fused_intersect,
                                                 fused_intersect_compact,
                                                 fused_intersect_compact_ref,
                                                 fused_intersect_ref,
                                                 fused_support_pairs)
from repro_torch.kernels.trimatrix import cooccurrence, trimatrix_ref
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  grouped_decode_attention)
from repro_torch.kernels.flash_attention import (attention_ref,
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
    want, _ = ServingEngine(Model(cfg), params, s_max=32).serve(reqs, 1)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid])
