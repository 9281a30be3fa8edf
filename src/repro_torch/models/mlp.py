"""Dense MLP blocks: SwiGLU / GeGLU / GELU (the reference's
``models/mlp.py``).  On one device its sharding constraints are the
identity.  On a mesh with a ``model`` axis that splits d_ff (and without
``mlp_dp``: :func:`mlp_split`) the block is tensor-parallel: ``w_up``/
``w_gate`` are column-split (the input replicated over ``model``, its
gradient summed over it) and ``w_down`` is row-parallel (each rank's
partial product all-reduced over ``model``); under sequence parallelism the
input is gathered from the ranks' rows instead and the output
reduce-scattered back to them (``layers.tp_enter``, ``layers.tp_leave``).
Where the placement replicates the FFN (``mlp_dp``, or a d_ff the axis does
not divide) ``transformer`` runs it with no mesh, on the rows it is given."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import draw_normal, tp_enter, tp_leave

__all__ = ["init_mlp", "mlp", "mlp_split"]


def init_mlp(generator: torch.Generator, cfg, dtype, stacked: int = 0,
             device=None) -> dict:
    """Weights with the reference's scales, drawn from ``generator``."""
    d, f = cfg.d_model, cfg.d_ff
    shp = (lambda *s: (stacked, *s)) if stacked else (lambda *s: s)
    pre = "stk_" if stacked else ""

    def normal(shape, scale):
        return draw_normal(generator, shape, scale, dtype, device)

    p = {}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p[pre + "w_gate"] = normal(shp(d, f), d ** -0.5)
    p[pre + "w_up"] = normal(shp(d, f), d ** -0.5)
    p[pre + "w_down"] = normal(shp(f, d), f ** -0.5)
    return p


def mlp_split(cfg, m: int) -> bool:
    """Whether the placement splits the FFN over a model axis of ``m``
    ranks (``dist.sharding.param_spec``: d_ff divided, no ``mlp_dp``)."""
    return not cfg.mlp_dp and cfg.d_ff % m == 0


def mlp(p: dict, x: torch.Tensor, cfg, mesh=None, seq=None) -> torch.Tensor:
    """``mesh``: tensor-parallel over its ``model`` axis; ``seq`` (a
    ``layers.SeqShard``): ``x`` is the rank's rows of the sequence."""
    act = cfg.mlp_act
    tp = mesh is not None and "model" in (mesh.mesh_dim_names or ())
    if tp:
        x = tp_enter(x, mesh, seq)
    up = x @ p["w_up"]
    if act == "swiglu":
        hidden = F.silu(x @ p["w_gate"]) * up
    elif act == "geglu":
        # jax.nn.gelu(approximate=True) is the tanh form
        hidden = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    else:
        hidden = F.gelu(up, approximate="tanh")
    out = hidden @ p["w_down"]
    return tp_leave(out, mesh, seq) if tp else out
