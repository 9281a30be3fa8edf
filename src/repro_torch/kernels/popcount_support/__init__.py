from .ops import intersect_support
from .popcount_support import popcount_support
from .ref import popcount_support_ref

__all__ = ["intersect_support", "popcount_support", "popcount_support_ref"]
