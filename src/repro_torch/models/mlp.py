"""Dense MLP blocks: SwiGLU / GeGLU / GELU (the reference's ``models/mlp.py``
on one device, where its sharding constraints are the identity)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["init_mlp", "mlp"]


def init_mlp(generator: torch.Generator, cfg, dtype, stacked: int = 0,
             device=None) -> dict:
    """Weights with the reference's scales, drawn from ``generator``."""
    d, f = cfg.d_model, cfg.d_ff
    shp = (lambda *s: (stacked, *s)) if stacked else (lambda *s: s)
    pre = "stk_" if stacked else ""

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * scale).to(dtype)

    p = {}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p[pre + "w_gate"] = normal(shp(d, f), d ** -0.5)
    p[pre + "w_up"] = normal(shp(d, f), d ** -0.5)
    p[pre + "w_down"] = normal(shp(f, d), f ** -0.5)
    return p


def mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    act = cfg.mlp_act
    up = x @ p["w_up"]
    if act == "swiglu":
        hidden = F.silu(x @ p["w_gate"]) * up
    elif act == "geglu":
        # jax.nn.gelu(approximate=True) is the tanh form
        hidden = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    else:
        hidden = F.gelu(up, approximate="tanh")
    return hidden @ p["w_down"]
