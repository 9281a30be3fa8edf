"""Device resolution and the word convention of the port.

**Device.**  Every entry point takes ``device=None``, which means CUDA.  With
no card, ``None`` raises instead of running on the host: a run on the CPU is
always asked for explicitly (``device="cpu"``), so a missing card never
turns into a silently slower run.

**Words.**  The reference packs tidsets as ``uint32`` words.  PyTorch's
``torch.uint32`` lacks ``~``, ``>>``, subtraction, ``nonzero`` and
``index_select``, so the port carries the same bits in ``torch.int32``
tensors: a ``uint32`` numpy array crosses over through
``ndarray.view(np.int32)`` and back through ``view(np.uint32)``.  Bitwise
AND/ANDNOT and popcount do not care about the sign; only shifts do
(``>>`` on int32 is arithmetic), which :func:`popcount_words` handles by
masking after every shift.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "words_from_numpy", "words_to_numpy",
           "popcount_words"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the host")
    return dev


def words_from_numpy(words: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """``uint32`` words (a ``VerticalDB.bitmaps`` array or a frontier) ->
    an ``int32`` tensor with the same bits, on ``device`` (a copy)."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(resolve_device(device), copy=True)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`words_from_numpy`: ``int32`` tensor -> ``uint32``
    numpy array with the same bits, on the host."""
    if words.dtype != torch.int32:
        raise TypeError(f"expected int32 words, got {words.dtype}")
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of ``int32`` words (SWAR, plain torch ops).

    Every shift is followed by a mask that clears the bits an arithmetic
    shift may have filled with the sign, and no step multiplies, so no
    intermediate leaves the int32 range except by the wrap-around of the
    first subtraction, which keeps the same bits as ``uint32`` arithmetic.
    """
    x = words
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F
