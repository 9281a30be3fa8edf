"""Shared model layers: norms, rotary embeddings, logit soft-capping, and
the helpers of the layers' tensor- and sequence-parallel forms on a mesh.

Float32 internals exactly as the reference package's ``models/layers.py``:
each function computes in float32 and casts back to its input's dtype.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..dist import collectives as coll
from ..dist.sharding import axis_index, axis_size, spec_axes
from ..kernels._softcap import softcap

__all__ = ["rms_norm", "layer_norm", "norm", "rope", "apply_rope", "init_norm",
           "softcap", "model_split", "gather_columns", "draw_normal", "SeqShard",
           "tp_enter", "tp_leave", "gather_whole"]

# a weight of more elements than this is drawn one slice of its leading
# (layer) axis at a time
DRAW_WHOLE_MAX = 1 << 30


def draw_normal(generator: torch.Generator, shape, scale: float, dtype,
                device=None) -> torch.Tensor:
    """``randn(shape) * scale`` in ``dtype``, drawn in float32 from
    ``generator``.  A leaf of more than ``DRAW_WHOLE_MAX`` elements is drawn
    one slice of its leading axis at a time, so the float32 draw never holds
    the whole leaf (a stacked MLP leaf of command-r-35b is 29.5 GB in
    float32, twice that with its scaled copy, beside 60.6 GB of bf16
    weights on an 80 GB card)."""
    if len(shape) < 2 or torch.Size(shape).numel() <= DRAW_WHOLE_MAX:
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in out:
        part.copy_(torch.randn(tuple(shape[1:]), generator=generator,
                               dtype=torch.float32, device=device) * scale)
    return out


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


def rope(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """Rotary cos/sin tables for integer positions (..., S), float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python base, not a tensor made on the card: that copy would make
    # every decode step wait for the card once per layer
    freqs = torch.pow(float(theta), exps)
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


def model_split(mesh, state, block: str) -> tuple:
    """(m, r): the size of ``mesh``'s ``model`` axis and this rank's
    coordinate on it, (1, 0) without one; a decode state on a mesh raises."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return 1, 0
    if state is not None:
        raise NotImplementedError(
            f"the {block} with a decode state on a mesh (sharded serving) is "
            "not ported (ROADMAP item 12)")
    return axis_size(mesh, "model"), axis_index(mesh, "model")


def gather_columns(t: torch.Tensor, mesh, ranks: int) -> torch.Tensor:
    """``t``'s last dim gathered over ``model`` (``t`` itself when
    ``ranks`` is 1): one all-gather, its gradient reduce-scattered."""
    return t if ranks == 1 else coll.gather_over_axis(t, mesh, "model", dim=-1)


class SeqShard(NamedTuple):
    """A (B, S, D) sequence whose rows are split over ``mesh``'s ``model``
    axis (Megatron sequence parallelism, the reference's ``seq_parallel``):
    the rows padded with zeros to a multiple of the axis' ranks, each rank
    holding its contiguous block of them; ``length`` is S before the
    padding, so every gather cuts the padding off again and no layer that
    mixes positions sees it.  Its four conjugate pairs
    (``dist.collectives``) enter and leave the layers that need the whole
    sequence: :meth:`gather` and :meth:`scatter` around a tensor-parallel
    layer, :meth:`unsplit` and :meth:`split` around one every rank runs
    whole."""
    mesh: Any
    length: int

    def _pad(self, x):
        pad = (-x.shape[1]) % axis_size(self.mesh, "model")
        return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x

    def gather(self, x):
        """The whole sequence from the ranks' rows (one all-gather); its
        gradient, each rank's part, summed and cut back to the rank's rows
        (one reduce-scatter)."""
        return coll.gather_over_axis(x, self.mesh, "model", 1)[:, :self.length]

    def scatter(self, y):
        """The rank's rows of the sum of every rank's (B, S, D) partial
        ``y`` (one reduce-scatter); the rows' gradients all-gathered back."""
        return coll.reduce_scatter_over_axis(self._pad(y), self.mesh, "model", 1)

    def unsplit(self, x):
        """The whole sequence from the ranks' rows (one all-gather), for a
        layer every rank runs whole: its gradient is whole on every rank and
        each keeps its rows of it."""
        return coll.unsplit_over_axis(x, self.mesh, "model", 1)[:, :self.length]

    def split(self, y):
        """The rank's rows of a (B, S, D) ``y`` every rank holds whole (no
        collective); the rows' gradients all-gathered back."""
        return coll.split_over_axis(self._pad(y), self.mesh, "model", 1)


def tp_enter(x: torch.Tensor, mesh, seq: SeqShard | None = None) -> torch.Tensor:
    """The input of a tensor-parallel layer on ``mesh``: the replicated
    ``x`` itself, its gradient summed over ``model`` (``copy_to_axis``); or,
    with ``seq``, the whole sequence gathered from the ranks' rows."""
    return coll.copy_to_axis(x, mesh, "model") if seq is None else seq.gather(x)


def tp_leave(y: torch.Tensor, mesh, seq: SeqShard | None = None) -> torch.Tensor:
    """The output of a tensor-parallel layer, each rank's partial sum
    ``y``: summed over ``model`` (one all-reduce), or with ``seq``
    reduce-scattered to the rank's rows."""
    return coll.reduce_over_axis(y, mesh, "model") if seq is None else seq.scatter(y)


def gather_whole(p: dict, specs: dict, mesh, names) -> dict:
    """``p`` with each leaf of ``names`` that its placement (``specs``, the
    layer's: no stack dim) splits over ``model`` gathered whole (one
    all-gather a leaf, ``unsplit_over_axis``: each rank then computes with
    it whole and keeps its block of the gradient).  The other leaves are
    replicated already."""
    out = dict(p)
    for name in names:
        for dim, entry in enumerate(specs.get(name, ())):
            if "model" in spec_axes(entry):
                out[name] = coll.unsplit_over_axis(out[name], mesh, "model", dim)
    return out
