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
from repro_torch.kernels.fused_intersect import (fused_intersect,
                                                 fused_intersect_compact,
                                                 fused_intersect_compact_ref,
                                                 fused_intersect_ref)
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
    cooccurrence(args[0])
    q = torch.zeros((1, 4, 8, 16))
    multi_head_attention(q, q[:, :2], q[:, :2])
    grouped_decode_attention(q[:, :2, :2], q.transpose(1, 2)[:, :, :2],
                             q.transpose(1, 2)[:, :, :2],
                             torch.tensor([3], dtype=torch.int32))
    assert tk.launch_counts() == {"fused_intersect": 0,
                                  "fused_intersect_compact": 0, "trimatrix": 0,
                                  "flash_attention": 0, "decode_attention": 0}


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
