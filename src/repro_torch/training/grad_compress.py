"""Gradient compression for the data-parallel all-reduce (the port of the
reference package's ``training/grad_compress.py``).

Two schemes, both with error feedback (the residual of the lossy round
trip is added to the next step's gradient, which is what makes compressed
SGD converge — Karimireddy et al., 2019):

  int8:  per-leaf absmax scaling -> int8 quantize -> sum -> dequantize.
  topk:  keep the largest k-fraction of entries (magnitude).

``compressed_psum`` is the collective building block, over one axis of a
``torch.distributed`` device mesh (the reference's ``shard_map`` axis name
becomes the mesh and its axis; the collectives go through
``dist.collectives``); ``make_compressor`` wraps a gradient tree.  The
single-card train step does not call them: they wait for mesh training
(ROADMAP item 12).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..dist import collectives as coll
from .optimizer import tree_map, tree_unzip

__all__ = ["int8_roundtrip", "topk_mask", "make_compressor", "compressed_psum"]


def _int8_scale(gf: torch.Tensor) -> torch.Tensor:
    return torch.clamp(gf.abs().max(), min=1e-12) / 127.0


def int8_roundtrip(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize to int8 with a per-tensor absmax scale; return (dequant, err)."""
    gf = g.float()
    scale = _int8_scale(gf)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


def topk_mask(g: torch.Tensor, frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    flat = gf.abs().reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    kept = torch.where(gf.abs() >= thresh, gf, torch.zeros((), device=gf.device))
    return kept, gf - kept


def make_compressor(method: str, topk_frac: float = 0.05):
    """Returns (init_err, apply) where apply(grads, err) -> (grads', err')."""
    if method == "none":
        return (lambda params: None,
                lambda grads, err: (grads, err))

    def init_err(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def one(g, e):
        g = g.float() + e
        if method == "int8":
            return int8_roundtrip(g)
        if method == "topk":
            return topk_mask(g, topk_frac)
        raise ValueError(method)

    def apply(grads, err):
        out = tree_map(one, grads, err)
        return tree_unzip(out, 0), tree_unzip(out, 1)

    return init_err, apply


def compressed_psum(x: torch.Tensor, mesh, axis: str = "data",
                    method: str = "int8") -> torch.Tensor:
    """Lossy-compress, sum over the ranks of ``axis``, mean.

    The int8 path all-reduces the scale with a max first, so every rank
    quantizes on one grid, then sums the int32-upcast quanta and rescales by
    that scale over the world size (the reference's one-pass
    approximation)."""
    n = mesh.get_group(axis).size()
    if method == "none":
        return coll.all_reduce(x.clone(), mesh, axis) / n
    xf = x.float()
    scale = coll.all_reduce(_int8_scale(xf).reshape(1), mesh, axis, op="max")[0]
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    total = coll.all_reduce(q, mesh, axis)
    return total.float() * scale / float(n)
