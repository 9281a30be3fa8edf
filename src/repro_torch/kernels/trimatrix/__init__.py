from .ops import cooccurrence
from .ref import trimatrix_ref
from .trimatrix import trimatrix

__all__ = ["cooccurrence", "trimatrix", "trimatrix_ref"]
