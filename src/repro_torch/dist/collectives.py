"""The one place that calls ``torch.distributed`` collectives.

The reference's ``shard_map`` bodies reduce with ``psum`` and its engines
gather results across devices implicitly (``device_get`` of a sharded
array, a row ``take`` across shards).  Here each rank is a process, so those
exchanges are explicit calls, each over one named axis of a
``torch.distributed.device_mesh.DeviceMesh`` (its subgroup from
``mesh.get_group(axis)``).

Backends: an NCCL group exchanges the tensors on the card.  A gloo group
(ranks on the host, or several ranks sharing one card, which NCCL refuses)
exchanges host copies: a tensor on the card is copied to the host, reduced
or gathered there, and copied back.  That copy is made here and nowhere
else.  Nothing switches from one backend to the other; a failed collective
raises.

Counters: every call adds one to its (axis, op) count and the bytes of its
local input to its payload, read with :func:`collective_counts` (as
``kernels.launch_counts`` reads the kernel launches).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "broadcast", "broadcast_from_lead",
           "lead_int", "collective_counts", "reset_collective_counts",
           "counts_since"]

_COUNTS: Dict[tuple, Dict[str, int]] = defaultdict(lambda: {"calls": 0, "bytes": 0})


def _count(axis: str, op: str, t: torch.Tensor) -> None:
    c = _COUNTS[(axis, op)]
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def collective_counts() -> dict:
    """``{axis: {op: {"calls": n, "bytes": b}}}`` since the last reset."""
    out: dict = {}
    for (axis, op), c in sorted(_COUNTS.items()):
        out.setdefault(axis, {})[op] = dict(c)
    return out


def counts_since(before: dict) -> dict:
    """The calls and bytes added since ``before`` (an earlier
    :func:`collective_counts`), in the same form, zero entries left out."""
    out: dict = {}
    for axis, ops in collective_counts().items():
        for op, c in ops.items():
            b = before.get(axis, {}).get(op, {"calls": 0, "bytes": 0})
            if c["calls"] != b["calls"]:
                out.setdefault(axis, {})[op] = {
                    "calls": c["calls"] - b["calls"],
                    "bytes": c["bytes"] - b["bytes"]}
    return out


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _on_host(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


_REDUCE_OPS = {"sum": (dist.ReduceOp.SUM, "all_reduce"),
               "max": (dist.ReduceOp.MAX, "all_reduce_max")}


def all_reduce(t: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over the ranks of ``axis`` (``op`` ``"sum"`` or
    ``"max"``), in place; returns ``t``.  Counted as ``all_reduce`` (sum)
    or ``all_reduce_max``."""
    group = mesh.get_group(axis)
    reduce_op, name = _REDUCE_OPS[op]
    _count(axis, name, t)
    if _on_host(group) and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, op=reduce_op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=reduce_op, group=group)
    return t


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``(n, *t.shape)`` stack of every rank's ``t`` along ``axis``, in
    axis-coordinate order, on ``t``'s device."""
    group = mesh.get_group(axis)
    _count(axis, "all_gather", t)
    t = t.contiguous()
    n = dist.get_world_size(group)
    if _on_host(group):
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.stack(parts).to(t.device)
    out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def broadcast(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Overwrite ``t`` with the value of the rank at coordinate 0 of
    ``axis``, in place; returns ``t``."""
    group = mesh.get_group(axis)
    _count(axis, "broadcast", t)
    src = dist.get_global_rank(group, 0)
    if _on_host(group) and t.device.type != "cpu":
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def broadcast_from_lead(t: torch.Tensor, mesh) -> torch.Tensor:
    """Overwrite ``t`` on every rank of the mesh with the lead rank's value
    (coordinate 0 on every axis): one broadcast per mesh axis, each from
    coordinate 0 of that axis, in axis order."""
    for axis in mesh.mesh_dim_names:
        broadcast(t, mesh, axis)
    return t


def lead_int(value: int, mesh) -> int:
    """The lead rank's ``value`` on every rank (one 8-byte broadcast per
    mesh axis); ``value`` itself without a mesh."""
    if mesh is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device="cuda" if mesh.device_type == "cuda" else "cpu")
    return int(broadcast_from_lead(t, mesh).item())
