"""Layout rule shared by the attention kernels' bindings: the kernels load
16 bytes per thread along the last axis, addressed by strides."""
from __future__ import annotations

import torch

__all__ = ["rows_of_16_bytes"]


def rows_of_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last axis is contiguous and every other stride
    and its address are multiples of 16 bytes (8 elements, which the
    kernels' 8-element loads need for bf16 and float32 alike); else a
    contiguous copy.  Raises if even the copy is not aligned."""
    def ok(x):
        return (x.stride(-1) == 1
                and all(s % 8 == 0 for s in x.stride()[:-1])
                and x.data_ptr() % 16 == 0)
    if ok(t):
        return t
    t = t.contiguous()
    if not ok(t):
        raise ValueError(f"tensor of shape {tuple(t.shape)} cannot be laid "
                         "out in 16-byte rows (last axis not a multiple of 8?)")
    return t
