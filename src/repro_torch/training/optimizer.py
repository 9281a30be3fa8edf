"""AdamW (decoupled weight decay) on dicts of tensors: the port of the
reference package's ``training/optimizer.py``.

The optimizer state is a plain tree, ``{"mu", "nu", "step"}`` (plus
``"master"`` when asked for), with the parameters' keys, so the checkpoint
writes it in the reference's on-disk form.  Moments are float32 whatever
the parameters' dtype; the update runs in float32 and casts each parameter
back to its dtype.  Without a master copy (the reference's default) a bf16
update below half a bf16 unit is lost, as it is in the reference.

The arithmetic is the reference's, operation for operation.  To save
memory the port works in place, as the reference's compiled train cell
does with the buffers it donates (``donate_argnums=(0, 1)``):
``adamw_update`` overwrites the given parameters (and master copy) and the
state's ``mu`` and ``nu`` tensors, a slice of at most ``CHUNK`` elements at
a time, which changes no result (every operation is elementwise), so a
second tree of parameters is never alive (11.5 GB at grok's width).
:func:`global_norm` takes each leaf's sum of squares a slice at a time (a
float32 copy of one of grok's stacked expert leaves, 1.6 G elements, would
be 6.4 GB), and :func:`clip_by_global_norm_` scales the gradients in place
a slice at a time, with the reference's per-element arithmetic, so no
second tree of gradients is alive beside the first (+11.5 GB).

On a mesh each rank updates its own block of every leaf (the update is
elementwise); only the global norm needs the other ranks
(:func:`global_norm` with ``mesh`` and ``specs``).  ``zero1_spec_tree`` is
the reference's ZeRO-1 placement of the moments, a pure placement
function: as in the reference, whose ``launch.train`` keeps each moment
where its parameter is, no step applies it.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

__all__ = ["adamw_init", "adamw_update", "global_norm", "clip_by_global_norm_",
           "lr_schedule", "tree_map", "tree_leaves",
           "tree_unflatten", "tree_unzip", "zero1_spec_tree", "CHUNK"]

# elements per slice of a large leaf in adamw_update, global_norm and the
# clip (bounds their float32 temporaries: the 256,000 x 2,048 embedding of
# gemma-2b is 524 M elements)
CHUNK = 1 << 26


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts, in sorted-key order (the reference's
    ``jax.tree.leaves`` order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, flat):
    """A tree shaped like ``like`` holding ``flat`` (in :func:`tree_leaves`
    order)."""
    return _unflatten(like, iter(flat))


def _unflatten(node, it):
    # a module-level walk: a recursive closure would hold ``flat`` in a
    # reference cycle until the garbage collector ran (a train step's whole
    # gradient tree, 11.5 GB at grok's width, kept into the next step)
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leafwise to trees of dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_unzip(tree, i: int):
    """Element ``i`` of every tuple leaf of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: tree_unzip(v, i) for k, v in tree.items()}
    return tree[i]


def adamw_init(params, master: bool = False, moment_dtype=torch.float32):
    def zero(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    leaf = tree_leaves(params)[0]
    state = {"mu": tree_map(zero, params), "nu": tree_map(zero, params),
             "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}
    if master:
        state["master"] = tree_map(lambda p: p.float().clone(), params)
    return state


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """A leaf's float32 sum of squares, over its slices (:func:`_slices`)
    in order: the whole leaf's sum when it is one slice."""
    total = None
    for sl in _slices(x):
        sq = torch.sum(torch.square(sl.float()))
        total = sq if total is None else total + sq
    return total


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's sum of
    squares, in float32 (a leaf of more than ``CHUNK`` elements summed a
    slice at a time, the slices' sums added in order).  On a mesh, ``tree``
    holds this rank's blocks under ``specs`` (a tree of placements like it,
    replicated over every axis they do not name): the norm of the global
    tree.  The sums of
    squares of the leaves split over the same axes are added, then
    all-reduced over those axes (one all-reduce per axis and set of axes);
    a replicated leaf is counted once."""
    if mesh is None:
        total = 0
        for x in tree_leaves(tree):
            total = total + _sum_sq(x)
        return torch.sqrt(total)
    from ..dist import collectives as coll
    from ..dist.sharding import spec_axes
    groups: dict = {}
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        axes = tuple(sorted({a for e in spec for a in spec_axes(e)}))
        sq = _sum_sq(x)
        groups[axes] = groups[axes] + sq if axes in groups else sq
    total = 0
    for axes in sorted(groups):
        part = groups[axes]
        for a in axes:
            part = coll.all_reduce(part.reshape(1), mesh, a)[0]
        total = total + part
    return torch.sqrt(total)


def clip_by_global_norm_(grads, max_norm: float, mesh=None, specs=None):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``,
    each element as the reference computes it, ``(g * scale)`` in float32
    cast back to ``g``'s dtype, a slice of each leaf at a time; returns
    ``(grads, norm)`` (the same tree, the norm before the clip): the
    reference's ``clip_by_global_norm`` done in place."""
    norm = global_norm(grads, mesh, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        for sl in _slices(g):
            sl.copy_((sl.float() * scale).to(sl.dtype))
    return grads, norm


def lr_schedule(step, base_lr: float, warmup: int, total: int):
    """Linear warmup + cosine decay to 10%."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return base_lr * warm * cos


def _slices(t: torch.Tensor):
    """Contiguous ``t`` as flat views of at most ``CHUNK`` elements each, in
    memory order (``t`` itself when it is small or 0-d): a leaf whose first
    axis is short, such as a one-layer stack of grok's experts (1.6 G
    elements), is cut too."""
    if t.ndim == 0 or t.numel() <= CHUNK:
        return [t]
    return list(torch.split(t.view(-1), CHUNK))


def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    """One AdamW step -> ``(new_params, new_state)``: the given parameters
    (and master copy), ``state["mu"]`` and ``state["nu"]`` overwritten a
    slice at a time (each slice read before it is written); the returned
    trees hold the same tensors (module docstring)."""
    step = state["step"] + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    use_master = "master" in state
    ref = state["master"] if use_master else params

    def upd(p, g, mu, nu):
        pf = p.float()
        g = g.float()
        mu.copy_(b1 * mu.float() + (1 - b1) * g)
        nu.copy_(b2 * nu.float() + (1 - b2) * g * g)
        update = (mu.float() / c1) / (torch.sqrt(nu.float() / c2) + eps)
        return pf - lr * (update + weight_decay * pf)

    def leaf(p, g, mu, nu, orig):
        for ps, gs, ms, ns, os_ in zip(_slices(p), _slices(g), _slices(mu),
                                       _slices(nu), _slices(orig)):
            pf = upd(ps, gs, ms, ns)
            if use_master:
                ps.copy_(pf)
            os_.copy_(pf.to(os_.dtype))
        return orig, p if use_master else None

    out = tree_map(leaf, ref, grads, state["mu"], state["nu"], params)
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    if use_master:
        new_state["master"] = tree_unzip(out, 1)
    return tree_unzip(out, 0), new_state


def zero1_spec_tree(param_specs, mesh):
    """ZeRO-1 (the reference's): a function ``widen(spec, shape)`` that
    further shards an optimizer-moment leaf over the data axes the spec
    does not use yet, on its largest unsharded dim that their product
    divides (the spec unchanged when none does).  ``param_specs`` is
    unused, as in the reference."""
    from ..dist.sharding import mesh_axes, spec_axes
    sizes = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)

    def widen(spec, shape):
        entries = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for e in entries for a in spec_axes(e)}
        avail = tuple(a for a in dp if a not in used)
        if not avail:
            return tuple(spec)
        size = math.prod(sizes[a] for a in avail)
        if size <= 1:
            return tuple(spec)
        best, best_dim = None, -1
        for i, (e, s) in enumerate(zip(entries, shape)):
            if e is None and s % size == 0 and s > best_dim:
                best, best_dim = i, s
        if best is not None:
            entries[best] = avail if len(avail) > 1 else avail[0]
        return tuple(entries)

    return widen
