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

Sums are taken in the tensor's own dtype on both backends (NCCL on the
card, gloo on the host copy): a bfloat16 sum is a bfloat16 sum.  Over two
ranks, as on every axis of the ``tiny`` mesh, that is one addition
rounded once, the same bits as a float32 sum rounded to bfloat16.

Tensor, sequence and expert parallelism need seven operations that
autograd can differentiate through (Megatron's conjugate pairs), each over
one mesh axis:

  copy_to_axis       identity forward, all-reduce (sum) backward: the input
                     of a column-parallel product, replicated over the axis
  reduce_over_axis   all-reduce (sum) forward, identity backward: the
                     partial sums of a row-parallel product
  gather_over_axis   all-gather along a dim forward, reduce-scatter (sum,
                     then this rank's block) backward
  reduce_scatter_over_axis  the reverse pair: reduce-scatter forward,
                     all-gather backward
  split_over_axis    this rank's block along a dim forward (no
                     collective), all-gather of the blocks' gradients
                     backward: a replicated tensor cut into the ranks' rows
  unsplit_over_axis  the reverse pair: all-gather forward, this rank's
                     block of the (replicated) gradient backward
  all_to_all_over_axis  block j of the leading dim to the rank at
                     coordinate j forward; the same exchange backward (it
                     is its own inverse): the MoE's move of the capacity
                     buffers between data shards and expert shards

Counters: every call adds one to its (axis, op) count and the bytes of its
local input to its payload, read with :func:`collective_counts` (as
``kernels.launch_counts`` reads the kernel launches); the backward halves
of the seven operations above count like any other call.
:func:`collective_widths` reads the ranks each (axis, op)'s calls spanned
(the width of the group the call ran over).
:func:`collective_seconds` reads the host time spent inside the calls, by
(axis, op): on gloo that is the whole exchange, host copies included (a
copy from the card waits for the work queued before it); on NCCL only the
enqueue.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict

import torch
import torch.distributed as dist

from .sharding import axis_index, axis_size

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "broadcast",
           "broadcast_from_lead", "lead_int", "collective_counts",
           "collective_seconds", "collective_widths", "reset_collective_counts",
           "counts_since",
           "copy_to_axis", "reduce_over_axis", "gather_over_axis",
           "reduce_scatter_over_axis", "split_over_axis", "unsplit_over_axis",
           "all_to_all_over_axis"]

_COUNTS: Dict[tuple, Dict[str, int]] = defaultdict(lambda: {"calls": 0, "bytes": 0})
_SECONDS: Dict[tuple, float] = defaultdict(float)
_WIDTHS: Dict[tuple, set] = defaultdict(set)


def _count(axis: str, op: str, t: torch.Tensor, group) -> float:
    """Count a call over ``group``; returns its start on the host clock (for
    :func:`_done`)."""
    c = _COUNTS[(axis, op)]
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()
    _WIDTHS[(axis, op)].add(dist.get_world_size(group))
    return time.perf_counter()


def _done(axis: str, op: str, t0: float) -> None:
    _SECONDS[(axis, op)] += time.perf_counter() - t0


def collective_seconds() -> dict:
    """``{axis: {op: seconds}}``: host seconds spent inside the collectives
    since the last reset."""
    out: dict = {}
    for (axis, op), sec in sorted(_SECONDS.items()):
        out.setdefault(axis, {})[op] = sec
    return out


def collective_counts() -> dict:
    """``{axis: {op: {"calls": n, "bytes": b}}}`` since the last reset."""
    out: dict = {}
    for (axis, op), c in sorted(_COUNTS.items()):
        out.setdefault(axis, {})[op] = dict(c)
    return out


def collective_widths() -> dict:
    """``{axis: {op: [ranks, ...]}}``: the group widths each (axis, op)'s
    calls spanned since the last reset, sorted."""
    out: dict = {}
    for (axis, op), widths in sorted(_WIDTHS.items()):
        out.setdefault(axis, {})[op] = sorted(widths)
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
    _SECONDS.clear()
    _WIDTHS.clear()


def _on_host(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of card tensor ``t`` for gloo, in page-locked memory
    (a third faster to copy than pageable memory on an H100 host), the
    copy finished before it returns."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


_REDUCE_OPS = {"sum": (dist.ReduceOp.SUM, "all_reduce"),
               "max": (dist.ReduceOp.MAX, "all_reduce_max")}


_TWO_BYTE_FLOATS = (torch.bfloat16, torch.float16)


def all_reduce(t: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over the ranks of ``axis`` (``op`` ``"sum"`` or
    ``"max"``), in place; returns ``t``.  Counted as ``all_reduce`` (sum)
    or ``all_reduce_max``, in ``t``'s dtype."""
    group = mesh.get_group(axis)
    reduce_op, name = _REDUCE_OPS[op]
    t0 = _count(axis, name, t, group)
    work = t if t.is_contiguous() else t.contiguous()
    if _on_host(group) and t.device.type != "cpu":
        work = _host_copy(t)
    dist.all_reduce(work, op=reduce_op, group=group)
    if work is not t:
        t.copy_(work)
    _done(axis, name, t0)
    return t


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``axis``, cut along ``dim`` into
    as many blocks as the axis has ranks: this rank's block (a new tensor).
    Counted as ``reduce_scatter``.  On gloo (which has no reduce-scatter)
    it is an all-reduce of the host copy, then the block."""
    group = mesh.get_group(axis)
    t0 = _count(axis, "reduce_scatter", t, group)
    n = dist.get_world_size(group)
    dim = dim % t.ndim
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{n} ranks")
    size = t.shape[dim] // n
    rank = dist.get_group_rank(group, dist.get_rank())
    if _on_host(group):
        work = (_host_copy(t) if t.device.type != "cpu"
                else t.clone(memory_format=torch.contiguous_format))
        dist.all_reduce(work, group=group)
        out = work.narrow(dim, rank * size, size)
    else:
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((size, *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        out = out.movedim(0, dim)
    out = out.to(t.device).contiguous()
    _done(axis, "reduce_scatter", t0)
    return out


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``(n, *t.shape)`` stack of every rank's ``t`` along ``axis``, in
    axis-coordinate order, on ``t``'s device."""
    group = mesh.get_group(axis)
    t0 = _count(axis, "all_gather", t, group)
    t = t.contiguous()
    n = dist.get_world_size(group)
    if _on_host(group):
        # a gather moves bits: 2-byte floats travel as bytes
        host = _host_copy(t) if t.device.type != "cpu" else t
        host = host.view(torch.uint8) if t.dtype in _TWO_BYTE_FLOATS else host
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        out = torch.stack(parts).view(t.dtype).to(t.device)
    else:
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
    _done(axis, "all_gather", t0)
    return out


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t``'s leading dim has one block per rank of ``axis``: block ``j``
    goes to the rank at coordinate ``j``, and the result's block ``j`` is
    the block the rank at coordinate ``j`` sent here (a new tensor of
    ``t``'s shape, on ``t``'s device).  Counted as ``all_to_all``.  On gloo
    the host copy is exchanged, 2-byte floats as bytes (it moves bits)."""
    group = mesh.get_group(axis)
    t0 = _count(axis, "all_to_all", t, group)
    n = dist.get_world_size(group)
    if t.ndim == 0 or t.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} needs a leading dim of "
                         f"{n} blocks, got {tuple(t.shape)}")
    t = t.contiguous()
    if _on_host(group):
        host = _host_copy(t) if t.device.type != "cpu" else t
        host = host.view(torch.uint8) if t.dtype in _TWO_BYTE_FLOATS else host
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        out = out.view(t.dtype).to(t.device)
    else:
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
    _done(axis, "all_to_all", t0)
    return out


def broadcast(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Overwrite ``t`` with the value of the rank at coordinate 0 of
    ``axis``, in place; returns ``t``."""
    group = mesh.get_group(axis)
    t0 = _count(axis, "broadcast", t, group)
    src = dist.get_global_rank(group, 0)
    if _on_host(group) and t.device.type != "cpu":
        host = _host_copy(t)
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    _done(axis, "broadcast", t0)
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


# ---------------------------------------------------------------------------
# autograd-aware operations for tensor parallelism
# ---------------------------------------------------------------------------

def _gathered(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return torch.cat(all_gather(t, mesh, axis).unbind(0), dim=dim)


def _own_block(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (no collective)."""
    n = axis_size(mesh, axis)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{n} ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, axis_index(mesh, axis) * size, size)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gathered(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ReduceScatterOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _SplitOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own_block(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _UnsplitOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gathered(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_own_block(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(),
                None, None, None)


class _AllToAllOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


def copy_to_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``axis`` (one
    all-reduce in the backward pass)."""
    return _CopyToAxis.apply(x, mesh, axis)


def reduce_over_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis`` (one all-reduce); the
    gradient passes through unchanged."""
    return _ReduceOverAxis.apply(x, mesh, axis)


def gather_over_axis(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` over ``axis`` concatenated along ``dim`` in axis
    order (one all-gather); the gradient is summed over the axis and each
    rank keeps its block (one reduce-scatter)."""
    return _GatherOverAxis.apply(x, mesh, axis, dim)


def reduce_scatter_over_axis(x: torch.Tensor, mesh, axis: str,
                             dim: int) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis``, this rank's block of it
    along ``dim`` (one reduce-scatter); the gradient is every rank's block
    gradient concatenated along ``dim`` (one all-gather)."""
    return _ReduceScatterOverAxis.apply(x, mesh, axis, dim)


def split_over_axis(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x`` the same on every
    rank of ``axis``; no collective); the gradient is every rank's block
    gradient concatenated along ``dim`` (one all-gather), so it is whole on
    every rank."""
    return _SplitOverAxis.apply(x, mesh, axis, dim)


def unsplit_over_axis(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` over ``axis`` concatenated along ``dim`` (one
    all-gather), for a result every rank then computes with whole: its
    gradient, the same on every rank, is cut to this rank's block (no
    collective).  :func:`gather_over_axis` is the form for a result whose
    gradient is each rank's part."""
    return _UnsplitOverAxis.apply(x, mesh, axis, dim)


def all_to_all_over_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """:func:`all_to_all` of ``x`` (its leading dim one block per rank of
    ``axis``); the gradient goes back by the same exchange."""
    return _AllToAllOverAxis.apply(x, mesh, axis)
