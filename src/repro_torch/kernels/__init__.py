"""repro_torch.kernels — hand-written CUDA kernels for Hopper (``sm_90a``).

fused_intersect : gather + AND/ANDNOT + popcount + min-support threshold,
                  with on-card survivor compaction (the level-expansion
                  hot loop behind ``core.engine``'s ``fused`` backend)
trimatrix       : 2-itemset co-occurrence counts (the paper's Phase-2
                  triangular matrix, behind ``core.triangular``)
flash_attention : online-softmax attention, causal / sliding window / GQA
                  (every prefill layer of ``models.attention``)
decode_attention: one-token grouped-query attention over the KV cache
                  (every decode step of ``models.attention``)

Each subpackage: ``<name>.py`` (ctypes binding of the CUDA source under
``csrc/``, with launch counters), ``ops.py`` (CUDA tensor -> kernel, CPU
tensor -> reference) and ``ref.py`` (plain torch oracle).  The CUDA sources
are built by :mod:`._build` at first use.
"""
from . import decode_attention, flash_attention, fused_intersect, trimatrix

__all__ = ["fused_intersect", "trimatrix", "flash_attention",
           "decode_attention", "launch_counts", "reset_launch_counts"]


def _counted():
    return {"fused_intersect": fused_intersect.fused_intersect_pairs,
            "fused_intersect_compact": fused_intersect.fused_intersect_compact_pairs,
            "trimatrix": trimatrix.trimatrix,
            "flash_attention": flash_attention.flash_attention,
            "decode_attention": decode_attention.decode_attention}


def launch_counts() -> dict:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in _counted().items()}


def reset_launch_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
