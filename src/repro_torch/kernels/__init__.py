"""repro_torch.kernels — hand-written CUDA kernels for Hopper (``sm_90a``).

fused_intersect : gather + AND/ANDNOT + popcount + min-support threshold,
                  with on-card survivor compaction (the level-expansion
                  hot loop behind ``core.engine``'s ``fused`` and
                  ``sharded`` backends), and its shard-local partial
                  popcount (the ``tidsharded`` and ``grid`` backends)
trimatrix       : 2-itemset co-occurrence counts (the paper's Phase-2
                  triangular matrix, behind ``core.triangular``)
flash_attention : online-softmax attention, causal / sliding window / GQA
                  (every full-sequence layer of ``models.attention``): a
                  bf16 tensor-core (wgmma + TMA) kernel and a float32 FMA
                  one; and its backward (``flash_attention_bwd``: bf16
                  wgmma + TMA dK/dV, reduction and dQ kernels, float32
                  FMA ones) behind ``FlashAttentionFunction``, for
                  training
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
           "reset_launch_counts", "variant_counts", "shape_counts"]


def _counted():
    return {"fused_intersect": fused_intersect.fused_intersect_pairs,
            "fused_intersect_compact": fused_intersect.fused_intersect_compact_pairs,
            "fused_intersect_partial": fused_intersect.fused_intersect_partial_pairs,
            "trimatrix": trimatrix.trimatrix,
            "flash_attention": flash_attention.flash_attention,
            "flash_attention_bwd": flash_attention.flash_attention_bwd,
            "decode_attention": decode_attention.decode_attention,
            "popcount_support": popcount_support.popcount_support}


def launch_counts() -> dict:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in _counted().items()}


def _with_variants():
    return {"flash_attention": flash_attention.flash_attention,
            "flash_attention_bwd": flash_attention.flash_attention_bwd}


def variant_counts() -> dict:
    """Launches of each variant of a kernel that has several, since the last
    reset: ``{"flash_attention.wgmma_bf16": n, "flash_attention.fma_f32": n,
    "flash_attention_bwd.wgmma_bf16": n, "flash_attention_bwd.fma_f32": n}``."""
    return {f"{name}.{v}": n for name, fn in _with_variants().items()
            for v, n in fn.variant_launches.items()}


def shape_counts() -> dict:
    """Launches of the attention kernels by what they attend over, since
    the last reset: ``flash_attention.causal``, ``flash_attention.full``
    (non-causal over the queries' own rows) and ``flash_attention.cross``
    (keys that are not the queries), the same split of the backward's
    calls (``flash_attention_bwd.causal`` ...), and
    ``decode_attention.rows=R`` for each cache of R rows a decode launch
    read."""
    out = {f"{name}.{m}": n for name, fn in _with_variants().items()
           for m, n in fn.mask_launches.items()}
    out.update((f"decode_attention.rows={r}", n)
               for r, n in decode_attention.decode_attention.rows_launches.items())
    return out


def reset_launch_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
    for fn in _with_variants().values():
        for v in fn.variant_launches:
            fn.variant_launches[v] = 0
    for fn in _with_variants().values():
        for m in fn.mask_launches:
            fn.mask_launches[m] = 0
    decode_attention.decode_attention.rows_launches.clear()
