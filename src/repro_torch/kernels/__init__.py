"""repro_torch.kernels — hand-written CUDA kernels for Hopper (``sm_90a``).

fused_intersect : gather + AND/ANDNOT + popcount + min-support threshold,
                  with on-card survivor compaction (the level-expansion
                  hot loop behind ``core.engine``'s ``fused`` and
                  ``sharded`` backends), and its shard-local partial
                  popcount (the ``tidsharded`` and ``grid`` backends)
trimatrix       : 2-itemset co-occurrence counts (the paper's Phase-2
                  triangular matrix, behind ``core.triangular``)
flash_attention : online-softmax attention, causal / sliding window / GQA
                  (every prefill layer of ``models.attention``): a bf16
                  tensor-core (wgmma + TMA) kernel and a float32 FMA one
decode_attention: one-token grouped-query attention over the KV cache,
                  split over blocks along the cache and merged in one
                  launch (every decode step of ``models.attention``)
popcount_support: AND + per-row popcount of pre-gathered row pairs (the
                  paper's Algorithm-1 inner loop; no mining path calls it)

Each subpackage: ``<name>.py`` (ctypes binding of the CUDA source under
``csrc/``, with launch counters), ``ops.py`` (CUDA tensor -> kernel, CPU
tensor -> reference) and ``ref.py`` (plain torch oracle).  The CUDA sources
are built by :mod:`._build` at first use.
"""
from . import (decode_attention, flash_attention, fused_intersect,
               popcount_support, trimatrix)

__all__ = ["fused_intersect", "trimatrix", "flash_attention",
           "decode_attention", "popcount_support", "launch_counts",
           "reset_launch_counts", "variant_counts"]


def _counted():
    return {"fused_intersect": fused_intersect.fused_intersect_pairs,
            "fused_intersect_compact": fused_intersect.fused_intersect_compact_pairs,
            "fused_intersect_partial": fused_intersect.fused_intersect_partial_pairs,
            "trimatrix": trimatrix.trimatrix,
            "flash_attention": flash_attention.flash_attention,
            "decode_attention": decode_attention.decode_attention,
            "popcount_support": popcount_support.popcount_support}


def launch_counts() -> dict:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in _counted().items()}


def variant_counts() -> dict:
    """Launches of each variant of a kernel that has several, since the last
    reset: ``{"flash_attention.wgmma_bf16": n, "flash_attention.fma_f32": n}``."""
    fn = flash_attention.flash_attention
    return {f"flash_attention.{v}": n for v, n in fn.variant_launches.items()}


def reset_launch_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
    variants = flash_attention.flash_attention.variant_launches
    for v in variants:
        variants[v] = 0
