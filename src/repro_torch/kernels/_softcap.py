"""The reference model's attention/logit soft-cap, shared by the attention
kernels' plain versions and the model layers, so they cannot drift apart."""
from __future__ import annotations

import torch

__all__ = ["softcap"]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``tanh(x / cap) * cap`` (Gemma-style soft-capping); ``cap`` 0: ``x``
    as it is."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
