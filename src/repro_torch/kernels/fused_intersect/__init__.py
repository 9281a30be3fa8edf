from .fused_intersect import (MODE_DIFFSET, MODE_TID_TO_DIFF, MODE_TIDSET,
                              fused_intersect_compact_pairs,
                              fused_intersect_pairs, fused_support_pairs)
from .ops import fused_intersect, fused_intersect_compact
from .ref import (compact_epilogue, fused_intersect_compact_ref,
                  fused_intersect_ref)

__all__ = ["MODE_TIDSET", "MODE_TID_TO_DIFF", "MODE_DIFFSET",
           "fused_intersect", "fused_intersect_compact",
           "fused_intersect_pairs", "fused_support_pairs",
           "fused_intersect_compact_pairs",
           "fused_intersect_ref", "fused_intersect_compact_ref",
           "compact_epilogue"]
