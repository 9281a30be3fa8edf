"""Placements over a ``torch.distributed`` device mesh: the word axis of a
frontier, and the parameters and batches of a model.

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

The model's placement rules are the reference's (``param_spec``,
``batch_spec``, ``spec_tree``, ``dp_axes``), rule for rule; a spec is a
plain tuple with one entry per array axis: ``None`` (replicated), an axis
name, or a tuple of axis names (the axis split over their product, the
first name major).  Megatron conventions: column-parallel weights (wq, wk,
wv, w_up, w_gate) split their output dim over ``model``, row-parallel ones
(wo, w_down) their input dim; the embedding its vocab rows (``lm_head`` its
vocab columns); experts over the last data axis with d_ff over ``model``
(or over (data, model) for ``expert_sharding="tp2d"``); norms, biases and
routers replicate, and so does any dim its axes do not divide.  A mesh here
is a ``DeviceMesh`` or anything with ``axis_names`` and a ``shape`` mapping
(``launch.mesh.named_mesh_layout``, the reference's meshes), so the rules
can be read for meshes no process group holds.  :func:`shard_tree` and
:func:`gather_tree` stand for the reference's ``sharding_tree`` with
``jax.device_put`` and for reading a sharded array back whole: the mesh is
passed to each call, as everywhere in the port (there is no process-wide
mesh).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["padded_word_count", "shard_words", "axis_size", "axis_index",
           "is_lead_rank", "mesh_descriptor", "mesh_axes", "DP_AXIS_NAMES",
           "dp_axes", "data_axes", "data_rank", "param_spec", "batch_spec",
           "spec_tree", "spec_axes", "shard_tree", "gather_tree"]

# axis names that count as gradient-reduction ("data-parallel") axes
DP_AXIS_NAMES = ("pod", "data")


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


# ---------------------------------------------------------------------------
# parameter and batch placement rules (the reference's, rule for rule)
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of an object with
    ``axis_names`` and a ``shape`` mapping, as the reference's meshes and
    ``launch.mesh.named_mesh_layout`` give ({} for None)."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {str(a): int(mesh.size(i)) for i, a in enumerate(names)}
    return {str(a): int(mesh.shape[a]) for a in mesh.axis_names}


def dp_axes(mesh=None) -> Tuple[str, ...]:
    """Gradient-reduction axis names in mesh order; ``("data",)`` without a
    mesh or when the mesh names none."""
    dp = tuple(a for a in mesh_axes(mesh) if a in DP_AXIS_NAMES)
    return dp or ("data",)


def data_axes(mesh) -> Tuple[str, ...]:
    """The gradient-reduction axes the mesh has (none without a mesh): the
    axes a batch's rows, the loss and the gradients are summed over."""
    return tuple(a for a in dp_axes(mesh) if a in mesh_axes(mesh))


def data_rank(mesh) -> Tuple[int, int]:
    """(this rank's index over the mesh's data axes, their rank count): the
    index flattened pod-major, the order in which :func:`batch_spec` gives
    the data ranks their rows; ``(0, 1)`` without data axes."""
    return _block(mesh, data_axes(mesh)) if mesh is not None else (0, 1)


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (``None`` names none)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _repl(shape) -> tuple:
    return (None,) * len(shape)


# row-parallel projections: input dim (-2) over 'model'
_ROW_NAMES = ("wo", "xwo", "w_down", "out_proj")
# leaves that always replicate regardless of shape
_REPLICATED_NAMES = ("router", "enc_pos", "conv", "a_log")


def _leaf_name(path: str) -> str:
    name = path.split("/")[-1]
    if name.startswith("stk_"):
        name = name[4:]
    return name


def param_spec(path: str, shape, mesh, expert_sharding: str = "ep",
               mlp_dp: bool = False) -> tuple:
    """Placement rule for one parameter leaf (the reference's
    ``param_spec``).

    ``path`` is the '/'-joined tree path (e.g. "stages/s0/stk_wq"),
    ``shape`` the leaf shape (a leading stack dim is transparent).
    ``expert_sharding``: "ep"/"ep_pad" split experts over the last dp axis
    with d_ff over 'model'; "tp2d" leaves experts replicated and splits
    d_ff over (data, model) jointly.  ``mlp_dp`` replicates the dense FFN
    weights."""
    shape = tuple(shape)
    name = _leaf_name(path)
    sizes = mesh_axes(mesh)
    m = sizes.get("model", 0)

    def over_model(dim: int) -> bool:
        return m > 0 and dim % m == 0

    # --- always-replicated leaves ---------------------------------------
    if len(shape) == 0 or any(t in name for t in ("norm", "scale", "bias")):
        return _repl(shape)
    if any(name == t or name.endswith(t) for t in _REPLICATED_NAMES):
        return _repl(shape)

    # --- embedding / unembedding ----------------------------------------
    if name == "embed":
        if over_model(shape[0]):
            return ("model",) + (None,) * (len(shape) - 1)
        return _repl(shape)
    if name == "lm_head":
        if over_model(shape[-1]):
            return (None,) * (len(shape) - 1) + ("model",)
        return _repl(shape)

    # --- experts ----------------------------------------------------------
    if "experts" in name:
        # (stack?, E, d_in, d_ff) for up/gate, (stack?, E, d_ff, d_out) down
        entries: list = [None] * len(shape)
        ff_dim = len(shape) - 1 if name.endswith(("up", "gate")) else len(shape) - 2
        if expert_sharding == "tp2d":
            axes = tuple(a for a in (*dp_axes(mesh), "model") if a in sizes)
            size = math.prod(sizes[a] for a in axes) if axes else 0
            if axes and size and shape[ff_dim] % size == 0:
                entries[ff_dim] = axes if len(axes) > 1 else axes[0]
            return tuple(entries)
        ep_axis = dp_axes(mesh)[-1]
        e_dim = len(shape) - 3
        if ep_axis in sizes and shape[e_dim] % max(sizes[ep_axis], 1) == 0:
            entries[e_dim] = ep_axis
        if over_model(shape[ff_dim]):
            entries[ff_dim] = "model"
        return tuple(entries)

    # --- dense FFN under mlp_dp: replicate over 'model' -------------------
    if mlp_dp and name in ("w_up", "w_gate", "w_down"):
        return _repl(shape)

    # --- row-parallel (output projections): input dim over 'model' --------
    if len(shape) >= 2 and any(name == t or name.endswith(t) for t in _ROW_NAMES):
        if over_model(shape[-2]):
            entries = [None] * len(shape)
            entries[-2] = "model"
            return tuple(entries)
        return _repl(shape)

    # --- column-parallel (everything else >= 2D): output dim over 'model' -
    if len(shape) >= 2 and over_model(shape[-1]):
        entries = [None] * len(shape)
        entries[-1] = "model"
        return tuple(entries)
    return _repl(shape)


def batch_spec(batch: int, mesh=None) -> tuple:
    """Leading-axis spec for a global batch: split over the dp axes when the
    batch divides their product, else replicated."""
    if mesh is None:
        return (None,)
    sizes = mesh_axes(mesh)
    dp = dp_axes(mesh)
    size = math.prod(sizes.get(a, 0) for a in dp)
    if size and batch % size == 0:
        return (dp if len(dp) > 1 else dp[0],)
    return (None,)


def _map_tree(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts (every other
    value is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k], *(r[k] for r in rest),
                             path=path + (str(k),)) for k in tree}
    return fn("/".join(path), tree, *rest)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def spec_tree(tree, mesh, expert_sharding: str = "ep", mlp_dp: bool = False):
    """:func:`param_spec` over a parameter tree of dicts whose leaves are
    arrays or shapes (anything with ``.shape``, or a tuple) -> a tree of
    specs."""
    return _map_tree(lambda path, leaf: param_spec(
        path, _shape(leaf), mesh, expert_sharding, mlp_dp), tree)


def _entries(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _block(mesh, axes) -> Tuple[int, int]:
    """(this rank's block index, the block count) of a dim split over
    ``axes`` (the first major)."""
    index, count = 0, 1
    for a in axes:
        n = axis_size(mesh, a)
        index, count = index * n + axis_index(mesh, a), count * n
    return index, count


def shard_tree(tree, mesh, specs):
    """This rank's block of every leaf of ``tree`` under ``specs`` (a tree
    of the same structure; a spec shorter than its leaf's rank leaves the
    trailing dims whole), each a new contiguous tensor on its leaf's device:
    what the reference's ``jax.device_put(tree, sharding_tree(...))``
    places on this rank's device.  Raises ``ValueError`` on a dim its axes
    do not divide."""
    def take(path, leaf, spec):
        t = leaf
        for dim, entry in enumerate(_entries(spec, t.ndim)):
            axes = spec_axes(entry)
            if not axes:
                continue
            index, count = _block(mesh, axes)
            if t.shape[dim] % count:
                raise ValueError(f"{path}: dim {dim} of {tuple(leaf.shape)} does "
                                 f"not split over {axes} ({count} blocks)")
            size = t.shape[dim] // count
            t = t.narrow(dim, index * size, size)
        return t.clone(memory_format=torch.contiguous_format)
    return _map_tree(take, tree, specs)


def gather_tree(tree, mesh, specs):
    """The global value of every leaf of a tree sharded under ``specs``
    (the inverse of :func:`shard_tree`), rebuilt by all-gathers over each
    split dim's axes (one per axis, minor axis first; each counted in
    ``collective_counts``).  Every rank takes part; the lead rank keeps the
    result and the others get ``None`` leaves."""
    from . import collectives as coll

    lead = is_lead_rank(mesh)

    def whole(path, leaf, spec):
        t = leaf
        for dim, entry in enumerate(_entries(spec, t.ndim)):
            for a in reversed(spec_axes(entry)):
                t = torch.cat(coll.all_gather(t, mesh, a).unbind(0), dim=dim)
        return t if lead else None
    return _map_tree(whole, tree, specs)
