"""Word-axis sharding of a frontier over a ``torch.distributed`` device mesh.

The reference places arrays with ``PartitionSpec``s over a
``jax.sharding.Mesh`` and lets ``shard_map`` hand each device its block.
Here every rank is its own process holding its own block, so sharding an
array is taking this rank's block of it.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions:
``("data",)`` for the 1-D backends, ``("class", "data")`` for the grid.

The reference's placements, over the array axes (``None`` = replicated),
and what stands for each here:

  word_shard_spec   (None, data)   frontier (rows, words): rows on every
                                   rank, words split (``shard_words``)
  grid_pair_spec    (class,)       the grid engine's flattened
                                   (n_class * qmax,) pair block: each rank
                                   takes its class block's pairs
  grid_block_spec   (class, data)  its (rows, words) intersection tiles

A frontier sharded over ``data`` is replicated over ``class`` for free: its
placement never names ``class``.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["padded_word_count", "shard_words", "axis_size", "axis_index",
           "is_lead_rank", "mesh_descriptor"]


def padded_word_count(n_words: int, n_shards: int) -> int:
    """Smallest word count >= ``n_words`` divisible by ``n_shards`` (zero pad
    words carry no set bits, so supports are unchanged)."""
    n_shards = max(int(n_shards), 1)
    return max(int(n_words), 0) + (-int(n_words)) % n_shards


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along the named mesh axis."""
    return int(mesh.size(_dim(mesh, axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along the named mesh axis."""
    return int(mesh.get_local_rank(axis))


def is_lead_rank(mesh) -> bool:
    """Whether this rank is the mesh's lead (coordinate 0 on every axis):
    the one rank that writes what every rank holds alike, such as a
    checkpoint.  Without a mesh the one process is the lead."""
    if mesh is None:
        return True
    return all(axis_index(mesh, a) == 0 for a in mesh.mesh_dim_names)


def _dim(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis; its axes are {names}")
    return names.index(axis)


def shard_words(arr: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's block of a (rows, n_words) bitmap sharded on its word
    axis: the word axis is zero-padded to a multiple of the axis size
    (popcount-neutral) and the rank at coordinate i keeps words
    ``[i * Ws, (i + 1) * Ws)``, ``Ws = ceil(n_words / size)``, as a
    contiguous tensor on ``arr``'s device."""
    if arr.ndim != 2:
        raise ValueError(f"expected a (rows, words) bitmap, got {tuple(arr.shape)}")
    n = axis_size(mesh, axis)
    ws = padded_word_count(arr.shape[1], n) // n
    lo = axis_index(mesh, axis) * ws
    block = arr[:, lo: lo + ws]
    if block.shape[1] < ws:
        block = torch.nn.functional.pad(block, (0, ws - block.shape[1]))
    return block.contiguous()


def mesh_descriptor(mesh) -> Optional[dict]:
    """Logical description of a mesh, ``{"axes": [...], "shape": [...]}``,
    the same dict as the reference's; ``None`` without a mesh."""
    if mesh is None:
        return None
    axes = [str(a) for a in (mesh.mesh_dim_names or ())]
    return {"axes": axes, "shape": [int(s) for s in mesh.shape]}
