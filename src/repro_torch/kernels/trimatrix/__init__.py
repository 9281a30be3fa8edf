from .ops import cooccurrence
from .ref import trimatrix_ref, trimatrix_unpacked_ref
from .trimatrix import plan_for, split_plan, trimatrix

__all__ = ["cooccurrence", "trimatrix", "split_plan", "plan_for", "trimatrix_ref",
           "trimatrix_unpacked_ref"]
