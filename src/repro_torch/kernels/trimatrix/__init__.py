from .ops import cooccurrence
from .ref import trimatrix_ref, trimatrix_unpacked_ref
from .trimatrix import split_plan, trimatrix

__all__ = ["cooccurrence", "trimatrix", "split_plan", "trimatrix_ref",
           "trimatrix_unpacked_ref"]
