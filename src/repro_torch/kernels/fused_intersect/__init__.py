from .fused_intersect import (COMPACT_LANES, COMPACT_TILE_PAIRS,
                              MODE_DIFFSET, MODE_TID_TO_DIFF, MODE_TIDSET,
                              compact_survivors_pairs,
                              fused_intersect_compact_pairs,
                              fused_intersect_pairs,
                              fused_intersect_partial_pairs,
                              fused_support_pairs)
from .ops import (compact_survivors, fused_intersect, fused_intersect_compact,
                  fused_intersect_partial)
from .ref import (compact_epilogue, compact_survivors_ref,
                  fused_intersect_compact_ref, fused_intersect_partial_ref,
                  fused_intersect_ref)

__all__ = ["MODE_TIDSET", "MODE_TID_TO_DIFF", "MODE_DIFFSET",
           "COMPACT_LANES", "COMPACT_TILE_PAIRS",
           "fused_intersect", "fused_intersect_compact",
           "fused_intersect_partial", "compact_survivors",
           "fused_intersect_pairs", "fused_support_pairs",
           "fused_intersect_compact_pairs", "fused_intersect_partial_pairs",
           "compact_survivors_pairs",
           "fused_intersect_ref", "fused_intersect_compact_ref",
           "fused_intersect_partial_ref", "compact_survivors_ref",
           "compact_epilogue"]
