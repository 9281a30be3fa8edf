"""Shared model layers: norms, rotary embeddings, logit soft-capping.

Float32 internals exactly as the reference package's ``models/layers.py``:
each function computes in float32 and casts back to its input's dtype.
"""
from __future__ import annotations

import torch

__all__ = ["rms_norm", "layer_norm", "norm", "rope", "apply_rope", "init_norm",
           "softcap"]


def init_norm(d: int, kind: str, dtype, device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a plain ``scale`` (not ``1 + w``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float()
    if "bias" in p:
        out = out + p["bias"].float()
    return out.to(x.dtype)


def norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    return layer_norm(p, x) if kind == "layernorm" else rms_norm(p, x)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit soft-capping."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """Rotary cos/sin tables for integer positions (..., S), float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)
