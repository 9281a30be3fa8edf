"""Train step: loss and gradients, microbatch accumulation, clipping, AdamW
(the port of the reference package's ``training/train_step.py``).

The reference's ``jax.value_and_grad`` becomes ``torch.autograd.grad`` over
the parameter leaves; its accumulating ``lax.scan`` over microbatches a
loop that sums float32 gradients in the same order.  On the card the
attention of every layer runs the flash-attention kernel forward and its
hand-written backward (``kernels.flash_attention.FlashAttentionFunction``).

On a mesh (a ``Model`` built with one) the step is the reference's jitted
step under its placements: the model's loss is the global one and each
rank's gradients those of its share of it on its block of the batch
(``Model.loss``), each gradient leaf is
summed over the data axes its placement does not name (one all-reduce per
leaf and per such axis, before clipping; an expert leaf split over ``data``
holds its own slots' or d_ff slice's whole gradient already, as under
GSPMD), and the global norm is the norm of the global gradient; AdamW
updates each rank's blocks.  A leaf the placement replicates over
``model`` (a norm, a vocabulary the axis does not divide, the SSM's conv)
holds its whole gradient on every model rank when the layers compute with
it whole there or take it through ``copy_to_axis`` where a rank reads only
its part.  Where a rank computes with it on its own rows of the sequence
only, its gradient is that rows' part and is summed over ``model`` too
(:func:`grad_sum_axes`): under ``seq_parallel`` every norm's scale and bias
and a replicated FFN (``mlp_dp``, or a d_ff the axis does not divide),
under ``mlp_dp`` alone the FFN.  The global norm then counts each such leaf
once, as it counts every replicated leaf.

Microbatches split the *global* batch, as the reference's scan over the
jitted step's global batch does: microbatch ``i`` is the global rows
``[i B / m, (i + 1) B / m)``.  On a mesh the step gathers the batch's
tensors over the data axes (one all-gather of each tensor an axis), and
data rank ``r`` (pod-major, as ``dist.sharding.batch_spec`` orders the
rows) takes the ``r``-th contiguous slice of each microbatch when the data
axes divide its rows, or the microbatch whole otherwise (marked
``"whole_batch"``).  So a mixture of experts routes each microbatch's
groups as the reference does: its aux loss and each group's capacity
depend on which rows a microbatch holds.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..dist import collectives as coll
from ..dist.sharding import data_axes, data_rank, mesh_axes, spec_axes
from .optimizer import (adamw_update, clip_by_global_norm_, lr_schedule,
                        tree_leaves, tree_map, tree_unflatten)

__all__ = ["make_train_step", "make_eval_step", "value_and_grad",
           "microbatches", "grad_sum_axes", "DonatedStateError"]

# the dense FFN's leaves: replicated over ``model`` under ``mlp_dp`` or for
# a d_ff the axis does not divide
_FFN_LEAVES = ("w_up", "w_gate", "w_down")


class DonatedStateError(RuntimeError):
    """A train step failed after its AdamW update began overwriting the
    parameters and optimizer state it was given: they are part-updated, and
    the step cannot be run again on them (``TrainingRunner`` restores the
    latest checkpoint instead of retrying)."""


def value_and_grad(loss_fn: Callable, params, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)``: the loss detached,
    the gradients a tree like ``params`` in the parameters' dtypes."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), *args)
    # a leaf the loss does not read (command-r's norm2 in its parallel
    # block) gets a zero gradient, as jax.grad gives it
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def microbatches(batch: dict, m: int, mesh=None) -> list:
    """The ``m`` microbatches of ``batch`` (this rank's block of it on
    ``mesh``) that this rank computes: microbatch ``i`` holds the global
    rows ``[i B / m, (i + 1) B / m)``, on a mesh this data rank's
    contiguous slice of them, or all of them (``"whole_batch"``) when the
    data axes do not divide them (module docstring).  The batch's other
    entries (flags) carry over."""
    tensors = {k: v for k, v in batch.items() if torch.is_tensor(v)}
    flags = {k: v for k, v in batch.items() if not torch.is_tensor(v)}
    rank, nd = data_rank(mesh)
    if nd > 1 and not flags.get("whole_batch"):
        # the global batch: each tensor gathered over the data axes, the
        # last axis first, so the rows come pod-major
        for a in reversed(data_axes(mesh)):
            tensors = {k: torch.cat(coll.all_gather(v, mesh, a).unbind(0))
                       for k, v in tensors.items()}
    rows = next(iter(tensors.values())).shape[0]
    if rows % m:
        raise ValueError(f"a batch of {rows} rows does not split into {m} "
                         "microbatches")
    per = rows // m
    split = per % nd == 0
    part, first = (per // nd, rank * (per // nd)) if split else (per, 0)
    flags = {k: v for k, v in flags.items() if k != "whole_batch"}
    if not split:
        flags["whole_batch"] = True
    return [{**{k: v.narrow(0, i * per + first, part) for k, v in tensors.items()},
             **flags} for i in range(m)]


def _leaf_paths(tree, path=()):
    """The '/'-joined paths of a tree's leaves, in :func:`tree_leaves`
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], path + (k,))]
    return ["/".join(path)]


def grad_sum_axes(cfg, specs, mesh) -> list:
    """The mesh axes each gradient leaf is summed over before the clip, one
    tuple a leaf in :func:`tree_leaves` order of ``specs`` (the model's
    placements on ``mesh``, a ``DeviceMesh`` or a layout): the data axes its
    placement does not split it over, then ``model`` for a leaf replicated
    there whose rank computes with it on the rank's rows of the sequence
    only: under ``seq_parallel`` (the residual's rows split over a model
    axis of more than one rank) the norms' and a replicated FFN's leaves;
    under ``mlp_dp`` the FFN's."""
    sizes = mesh_axes(mesh)
    split_model = sizes.get("model", 1) > 1
    sums = []
    for path, spec in zip(_leaf_paths(specs), tree_leaves(specs)):
        named = {a for e in spec for a in spec_axes(e)}
        axes = [a for a in data_axes(mesh) if a not in named]
        name = path.split("/")[-1].removeprefix("stk_")
        rows = ((cfg.seq_parallel and ("norm" in path or name in _FFN_LEAVES))
                or (cfg.mlp_dp and name in _FFN_LEAVES))
        if split_model and rows and "model" not in named:
            axes.append("model")
        sums.append(tuple(axes))
    return sums


def make_train_step(model, tcfg) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds tensors on the parameters' device.  The
    step donates ``params`` and ``opt_state``, as the reference's compiled
    train cell does: it updates their tensors in place and returns them; a
    failure before the update leaves them as they were, one inside it
    raises :class:`DonatedStateError`.  On the model's mesh ``params``, ``opt_state`` and ``batch`` are this rank's
    blocks and the ``loss`` and ``grad_norm`` metrics the global ones."""
    mesh = model.mesh
    sums = [] if mesh is None else grad_sum_axes(model.cfg, model.specs, mesh)

    def loss_fn(params, batch):
        return model.loss(params, batch, remat=tcfg.remat)

    def grads_of(params, batch):
        m = tcfg.microbatches
        if m <= 1:
            return value_and_grad(loss_fn, params, batch)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for micro in microbatches(batch, m, mesh):
            loss, g = value_and_grad(loss_fn, params, micro)
            g_sum = tree_map(lambda a, b_: a + b_.float(), g_sum, g)
            loss_sum = loss_sum + loss
        return loss_sum / m, tree_map(lambda g: g / m, g_sum)

    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        for g, axes in zip(tree_leaves(grads), sums):
            for a in axes:
                coll.all_reduce(g, mesh, a)
        grads, gnorm = clip_by_global_norm_(grads, tcfg.grad_clip, mesh,
                                           model.specs)
        lr = lr_schedule(opt_state["step"], tcfg.learning_rate,
                         tcfg.warmup_steps, tcfg.total_steps)
        try:
            params, opt_state = adamw_update(
                params, grads, opt_state, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
                weight_decay=tcfg.weight_decay)
        except RuntimeError as err:
            raise DonatedStateError(
                f"the AdamW update failed part-way through the donated state: {err}"
            ) from err
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": opt_state["step"]}
        return params, opt_state, metrics

    return step


def make_eval_step(model) -> Callable:
    """Returns ``step(params, batch) -> loss`` without gradients; on the
    model's mesh the global loss of the ranks' blocks."""
    def step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch)
    return step
