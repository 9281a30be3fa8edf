"""Model assembly: stages, forward passes, prefill and decode, loss.

The port of the reference package's ``models/transformer.py`` for the
decoders whose layers are ``attn`` or ``local`` attention with a dense MLP
or, in the ``+moe`` kinds, a mixture of experts (:mod:`.moe`; each layer's
load-balance loss is summed over the stack and the loss adds ``0.01``
times it, as the reference does); xLSTM's ``mlstm`` and ``slstm`` blocks
(:mod:`.xlstm`; a norm and the block, no MLP); and hymba's ``hybrid``
layers, windowed attention and a selective SSM (:mod:`.ssm`) side by side
on one norm, averaged, then the MLP.  The per-layer kind list
(``ModelConfig.layer_pattern``) is run-length grouped into *stages*; a
stage's weights are stacked along a leading axis (``stk_wq`` is
``(count, d, h * hd)``), with the reference's parameter keys, and the
reference's ``lax.scan`` over a stage becomes a Python loop over that axis
(the stacked leaves are unbound once per stage, so their gradients land on
the stacked leaf in one piece).  ``Model.loss`` is the reference's next-token
loss, its cross-entropy in sequence chunks against the embedding, with the
reference's ``remat`` modes as ``torch.utils.checkpoint`` per layer.
The decode cache of a stage holds each layer's state: attention's K/V
rows, the mLSTM's ``c, n, m``, the sLSTM's ``c, n, m, h``, the SSM's ``h``
and its causal-conv tail; ``run_stage`` hands each layer its slice of
every leaf and the layer writes its new state there.  whisper's ``enc``
layers (non-causal self-attention with rope, then the MLP) run in
``Model.encode``, after the learned ``enc_pos``; its ``xdec`` layers
(causal self-attention through the cache, cross-attention over the
encoder's K/V, which ``Model.cross_kv`` computes once per input and
``backbone``, ``prefill`` and ``decode_step`` take as ``enc_out``, then
the MLP) are its decoder; its loss encodes the batch's ``enc_embeds`` and
runs the decoder over their cross K/V, as the reference's does, the
gradient flowing through the cross-attention (K6's backward at Sk != S on
the card) into the encoder.  phi-3-vision's loss prefixes the text with
the batch's ``img_embeds``, as the reference's early-fusion stub does; its
prefill and decode take no image, as the reference's.  The cost-analysis
mode raises ``NotImplementedError``.

``Model(cfg, mesh=mesh)`` trains a decoder on a ``("data", "model")``
or ``("pod", "data", "model")`` mesh (``launch.mesh.make_mesh_named``,
``launch.mesh.make_mesh``) with the parameters placed by the
reference's rules (``self.specs``, from ``dist.sharding.spec_tree``, with
``mlp_dp``): each rank holds its block of every leaf
(``dist.sharding.shard_tree``) and its block of the batch.  Attention and
the MLP are tensor-parallel over ``model`` (:mod:`.attention`, :mod:`.mlp`);
the embedding is vocab-parallel: the lookup masks the ids outside the
rank's rows and all-reduces over ``model``, and the loss computes each
chunk's logits against the rank's vocab slice and all-reduces the max, the
sum of exponentials and the gold logit, never the (B, S, V) logits.  The
loss is divided by the mask count summed over the data axes, so the sum of
the data ranks' losses (and of their gradients) is the global loss: a batch
split over ``data`` and a batch each data rank holds whole (one the data
axes do not divide) both come out right.  A mixture of experts routes the
reference's groups per data shard and moves its buffers between data and
expert shards (:mod:`.moe`; the batch dict's ``"whole_batch"``, set by
``training.fault_tolerance.batch_block``, says that each data rank holds
the whole batch); its load-balance loss is global and the loss adds ``0.01``
times it once.  The recurrent and hybrid layers are tensor-parallel too
(:mod:`.xlstm`, :mod:`.ssm`: each gathers its column-split projections
over ``model``, runs its recurrence on the rank's heads or channels and
all-reduces its row-parallel output).  What the placement replicates,
because the model axis does not divide it, the layers run whole: a
vocabulary (whisper's 51,865, hymba's 32,001) is looked up and its logits
computed on every model rank with no collective; heads the axis does not
divide (hymba's 25) all run on every rank (:mod:`.attention`); and a part
of a layer whose leaves the axis does not split as its tensor-parallel form
needs (the KV projections' columns, a d_ff, the mLSTM's heads or head
width, the sLSTM's or the SSM's channels) gathers its split leaves whole and
runs whole on every rank (:func:`_mixer`, :func:`_ffn`).  whisper's encoder
runs tensor-parallel too, and its cross K/V are what each rank's head form
reads (:meth:`Model.cross_kv`); phi-3-vision's image rows are each data
rank's rows of the batch.  A mesh may have two data axes, the reference's
``pod`` and ``data``: the batch, the loss and the gradients are summed over
both, and a mixture of experts routes their product of groups.

``seq_parallel`` (Megatron sequence parallelism, on a model axis of more
than one rank) splits the residual's sequence over ``model``
(``layers.SeqShard``; a sequence the axis does not divide is padded with
zero rows that every gather cuts off): the embedding's vocab-parallel sum
becomes a reduce-scatter to the rank's rows (a replicated vocabulary's
lookup is cut to them), after the image prefix or the encoder's positions
are added to the whole sequence; the norms run on the rank's rows; each
tensor-parallel part gathers the sequence in front and reduce-scatters its
output back; a part run whole, and a mixture of experts (its routing groups
are the data shard's tokens), gathers the sequence and cuts its output back
to the rank's rows; and the loss gathers the final rows whole.  ``mlp_dp``
replicates the dense FFN, which then runs on the rank's rows of the
sequence (cut from the replicated residual and gathered after, without
``seq_parallel``).  A leaf a rank computes with on its own rows only (the
norms', a replicated FFN's) has that rows' part of the gradient, which the
train step sums over ``model`` (``training.train_step.grad_sum_axes``).
Off a mesh the flags change nothing.  Serving on a mesh raises
``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..dist import collectives as coll
from ..dist.sharding import axis_index, data_axes, mesh_axes, spec_tree
from .attention import (attention, head_split, init_attention, kv_of_form,
                        projections_split)
from .attention import init_cache as kv_init_cache
from .layers import SeqShard, gather_whole, init_norm, norm, tp_enter
from .mlp import init_mlp, mlp, mlp_split
from .moe import expert_placement, init_moe, moe
from .ssm import init_ssm, init_ssm_state, ssm_block, ssm_split
from .xlstm import (init_mlstm, init_mlstm_state, init_slstm, init_slstm_state,
                    mlstm_block, mlstm_split, slstm_block, slstm_split)

__all__ = ["stages_meta", "init_params", "Model", "PORTED_KINDS",
           "LOSS_CHUNK", "REMAT_MODES", "check_mesh", "has_attention"]

PORTED_KINDS = ("attn", "local", "attn+moe", "local+moe", "hybrid", "mlstm",
                "slstm", "enc", "xdec")


class _Block(NamedTuple):
    """A layer kind's block beside or instead of attention: its stacked
    weights' init, its forward (``(params, x, cfg, state=, mesh=, seq=) ->
    (y, state)``), its decode state's init, whether attention and the MLP
    run too, whether a model axis of ``m`` ranks splits it (``split(cfg,
    m)``: tensor-parallel, else whole on every rank) and its leaves'
    prefix."""
    init: Callable
    forward: Callable
    init_state: Callable
    with_attention: bool
    split: Callable
    prefix: str


# the layer kinds (the part before "+") with a block of their own: the
# hybrid's SSM sits beside attention, the recurrent blocks take the place of
# attention and the MLP
_BLOCKS = {"hybrid": _Block(init_ssm, ssm_block, init_ssm_state, True, ssm_split,
                            "ssm_"),
           "mlstm": _Block(init_mlstm, mlstm_block, init_mlstm_state, False,
                           mlstm_split, "m_"),
           "slstm": _Block(init_slstm, slstm_block, init_slstm_state, False,
                           slstm_split, "s_")}
# the attention projections a layer run whole on every rank gathers (the
# cross-attention's K/V projections run in Model.cross_kv)
_ATTN_LEAVES = ("wq", "wk", "wv", "wo")
_CROSS_LEAVES = ("xwq", "xwo")
LOSS_CHUNK = 512
REMAT_MODES = ("none", "dots", "full")


def stages_meta(cfg) -> List[Tuple[str, int]]:
    """Run-length encode the layer pattern into (kind, count) stages."""
    stages: List[Tuple[str, int]] = []
    for kind in cfg.layer_pattern():
        if stages and stages[-1][0] == kind:
            stages[-1] = (kind, stages[-1][1] + 1)
        else:
            stages.append((kind, 1))
    return stages


def _check_ported(cfg) -> None:
    bad = sorted({k for k, _ in stages_meta(cfg) if k not in PORTED_KINDS})
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {bad} are not ported to repro_torch "
            f"(it runs {list(PORTED_KINDS)}; ROADMAP item 12)")


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _model_axis(mesh) -> int:
    """The size of the mesh's ``model`` axis (1 without one); ``mesh`` a
    ``DeviceMesh`` or a layout (``launch.mesh.named_mesh_layout``)."""
    return mesh_axes(mesh).get("model", 1)


def _block(kind: str):
    """``kind``'s own block (:data:`_BLOCKS`), None for attention's kinds."""
    return _BLOCKS.get(kind.split("+")[0])


def has_attention(kind: str) -> bool:
    """Whether a layer of ``kind`` runs attention (K6 in a prefill, K7 in a
    decode step), caches K/V rows and has a norm2 and an MLP."""
    blk = _block(kind)
    return blk is None or blk.with_attention


def check_mesh(cfg, mesh) -> None:
    """Raise ``NotImplementedError`` for what mesh training does not run
    on ``mesh``: a layer kind the port does not run.  Every placement the
    reference's rules give a ported config is taken.  What the model axis
    splits runs tensor-parallel; what it does not divide the placement
    replicates and the layers run whole on every rank, as GSPMD runs the
    reference's replicated leaves: heads (:func:`.attention.head_split`), a
    vocabulary, the attention projections' columns, a d_ff, the mLSTM's heads
    or head width, the sLSTM's channels and the SSM's (a layer's split
    leaves are then gathered whole).  ``seq_parallel`` splits the residual's
    sequence over ``model`` and ``mlp_dp`` runs the replicated FFN on the
    rank's rows (:class:`Model`); on a mesh whose model axis has one rank
    both change nothing."""
    _check_ported(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer_stack(generator, cfg, kind: str, count: int,
                      device) -> Dict[str, torch.Tensor]:
    dtype = _dtype(cfg)
    p: Dict[str, torch.Tensor] = {}

    def add_norm(name):
        for k, v in init_norm(cfg.d_model, cfg.norm, dtype, device).items():
            p[f"stk_{name}_{k}"] = v[None].expand(count, *v.shape).contiguous()

    blk = _block(kind)
    add_norm("norm1")
    if has_attention(kind):
        p.update(init_attention(generator, cfg, dtype, stacked=count,
                                device=device))
    if kind == "xdec":   # whisper's decoder: cross-attention on its own norm
        add_norm("normx")
        p.update(init_attention(generator, cfg, dtype, stacked=count,
                                device=device, cross=True))
    if blk is not None:
        p.update(blk.init(generator, cfg, dtype, stacked=count, device=device))
    if not has_attention(kind):
        return p
    add_norm("norm2")
    if kind.endswith("+moe"):
        p.update(init_moe(generator, cfg, dtype, stacked=count, device=device))
    elif cfg.mlp_act != "none":
        p.update(init_mlp(generator, cfg, dtype, stacked=count, device=device))
    return p


def init_params(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random weights with the reference's scales, drawn from an explicit
    ``generator`` (which must live on ``device``).  Same tree and shapes as
    the reference's ``init_params``; the numbers differ, since a
    ``torch.Generator`` is not ``jax.random``: carry the reference's weights
    over with :func:`..models.convert.params_from_numpy` to compare."""
    _check_ported(cfg)
    dtype = _dtype(cfg)
    embed = (torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                         dtype=torch.float32, device=device) * 0.02).to(dtype)
    params: Dict[str, Any] = {
        "embed": embed,
        "stages": {f"s{i}": _init_layer_stack(generator, cfg, kind, count, device)
                   for i, (kind, count) in enumerate(stages_meta(cfg))},
        "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=generator,
            dtype=torch.float32, device=device) * cfg.d_model ** -0.5).to(dtype)
    if cfg.n_encoder_layers:
        params["enc_stages"] = {"e0": _init_layer_stack(
            generator, cfg, "enc", cfg.n_encoder_layers, device)}
        params["enc_final_norm"] = init_norm(cfg.d_model, cfg.norm, dtype, device)
        params["enc_pos"] = (torch.randn(
            (cfg.encoder_len, cfg.d_model), generator=generator,
            dtype=torch.float32, device=device) * 0.02).to(dtype)
    return params


# ---------------------------------------------------------------------------
# stage execution
# ---------------------------------------------------------------------------

def _sub(lp: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k.split("_", 1)[1]: v for k, v in lp.items() if k.startswith(prefix)}


def _mixer(fn, lp, h, cfg, split, names, mesh, seq, specs, **kw):
    """A part of a layer that mixes positions (attention, a recurrent
    block), ``fn(lp, h, cfg, mesh=, seq=, **kw) -> (out, state)``:
    tensor-parallel on ``mesh`` where its model axis splits the part
    (``split``); else run whole on every rank, its leaves of ``names`` that
    the placement (``specs``) splits gathered whole and, with ``seq``, the
    sequence gathered from the ranks' rows in front and cut back to them
    after."""
    if mesh is None or split:
        return fn(lp, h, cfg, mesh=mesh, seq=seq, **kw)
    lp = gather_whole(lp, specs, mesh, names)
    out, state = fn(lp, h if seq is None else seq.unsplit(h), cfg, **kw)
    return (out if seq is None else seq.split(out)), state


def _ffn(lp, h, cfg, mesh, seq):
    """The dense FFN: tensor-parallel where the model axis splits it
    (:func:`.mlp.mlp_split`).  A replicated one (``mlp_dp``, or a d_ff the
    axis does not divide) runs with no collective on the rows it is given
    (under ``seq``, the rank's), except under ``mlp_dp`` without ``seq``:
    on the rank's rows of the replicated input, gathered after, as the
    reference reshards it."""
    m = _model_axis(mesh)
    if mesh is None or mlp_split(cfg, m):
        return mlp(lp, h, cfg, mesh=mesh, seq=seq)
    if seq is not None or not cfg.mlp_dp or m == 1:
        return mlp(lp, h, cfg)
    rows = SeqShard(mesh, h.shape[1])
    return rows.unsplit(mlp(lp, rows.split(h), cfg))


def _layer_forward(lp: Dict[str, torch.Tensor], x, cfg, kind: str, *,
                   cache=None, pos=None, enc_out=None, placement=None,
                   mesh=None, whole_batch=False, seq=None, specs=None):
    """One layer.  Returns (x, cache, aux_loss): the MoE's float32
    load-balance loss, None for a dense layer (whose loss the reference
    counts as 0: no tensor is made for it on the decode path).  ``cache``
    is the layer's state, the returned one its new state (a recurrent
    block's may be new tensors: ``run_stage`` writes them into the
    cache).  ``enc_out``: an ``xdec`` layer's cross (k, v).  On ``mesh``,
    ``specs`` is the layer's placement (no stack dim) and ``seq`` (a
    ``layers.SeqShard``) says that ``x`` is the rank's rows of the
    sequence: the norms and a replicated FFN run on them, the parts that
    mix positions and the tensor-parallel FFN on the whole sequence."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported (ROADMAP item 12)")
    blk = _block(kind)
    m = _model_axis(mesh)
    split = projections_split(cfg, m)
    h = norm(_sub(lp, "norm1"), x, cfg.norm)

    def attend(inp, names=_ATTN_LEAVES, **kw):
        return _mixer(attention, lp, inp, cfg, split, names, mesh, seq, specs, **kw)

    def run_block(inp, state):
        return _mixer(blk.forward, lp, inp, cfg, blk.split(cfg, m),
                      [k for k in lp if k.startswith(blk.prefix)], mesh, seq,
                      specs, state=state)

    if blk is not None and not blk.with_attention:
        out, state = run_block(h, cache)
        return x + out, (None if cache is None else state), None
    if blk is not None:
        # hymba: windowed attention and the block side by side, averaged
        attn_cache = block_state = None
        if cache is not None:
            attn_cache = {k: cache[k] for k in ("k", "v")}
            block_state = {k: t for k, t in cache.items() if k not in attn_cache}
        attn_out, _ = attend(h, window=cfg.window, cache=attn_cache, pos=pos)
        blk_out, block_state = run_block(h, block_state)
        x = x + 0.5 * (attn_out + blk_out)
        x = x + _ffn(lp, norm(_sub(lp, "norm2"), x, cfg.norm), cfg, mesh, seq)
        return x, (None if cache is None else {**attn_cache, **block_state}), None
    if kind in ("enc", "xdec"):
        # whisper: the encoder's self-attention sees every frame; the
        # decoder's is causal, then attends over the encoder's rows
        attn_out, cache = attend(h, causal=kind == "xdec", cache=cache, pos=pos)
        x = x + attn_out
        if kind == "xdec":
            if enc_out is None:
                raise ValueError(f"{cfg.name}: an xdec layer needs the "
                                 "encoder's cross K/V (enc_out)")
            cross, _ = attend(norm(_sub(lp, "normx"), x, cfg.norm), _CROSS_LEAVES,
                              cross_kv=enc_out, prefix="x")
            x = x + cross
        x = x + _ffn(lp, norm(_sub(lp, "norm2"), x, cfg.norm), cfg, mesh, seq)
        return x, cache, None
    window = cfg.window if kind.split("+")[0] == "local" else 0
    aux_loss = None
    attn_out, cache = attend(h, window=window, cache=cache, pos=pos)
    if cfg.parallel_block:
        ff_in = h
    else:
        x = x + attn_out
        ff_in = norm(_sub(lp, "norm2"), x, cfg.norm)
    if kind.endswith("+moe"):
        # the routing groups are the data shard's tokens, so under ``seq``
        # the layer runs on the whole sequence of every model rank
        ff_out, aux = moe(lp, ff_in if seq is None else seq.unsplit(ff_in), cfg,
                          placement=placement, mesh=mesh, whole_batch=whole_batch)
        ff_out = ff_out if seq is None else seq.split(ff_out)
        aux_loss = aux["aux_loss"]
    elif cfg.mlp_act != "none":
        ff_out = _ffn(lp, ff_in, cfg, mesh, seq)
    else:
        ff_out = torch.zeros_like(x)
    x = x + attn_out + ff_out if cfg.parallel_block else x + ff_out
    return x, cache, aux_loss


# the outputs ``remat="dots"`` keeps: matrix products with no batch
# dimension (the counterpart of ``dots_with_no_batch_dims_saveable``;
# ``x @ w`` of a (B, S, D) activation and a 2-d weight runs as ``mm``)
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(lp, x, cfg, kind, enc_out, placement, mesh, whole_batch, seq,
                 specs):
    x, _, aux = _layer_forward(lp, x, cfg, kind, enc_out=enc_out,
                               placement=placement, mesh=mesh,
                               whole_batch=whole_batch, seq=seq, specs=specs)
    return x, aux


def run_stage(stage_params, x, cfg, kind: str, *, cache=None, pos=None,
              enc_out=None, placement=None, remat: str = "none", mesh=None,
              whole_batch=False, seq=None, specs=None):
    """Run the stacked layers of one stage in order.  Returns (x, cache,
    aux): the sum of the layers' load-balance losses (None for dense
    layers); a given cache is written in place, layer ``i`` into its slice
    ``i`` of every leaf (a new state tensor is copied there: a bf16 conv
    tail into the float32 buffer exactly).  ``enc_out``: an ``xdec``
    stage's cross (k, v), each (count, B, Sk, KV, D); layer ``i`` reads
    slice ``i``.

    ``remat`` (full-sequence passes only): ``"full"`` keeps only each
    layer's input and recomputes the layer in the backward pass;
    ``"dots"`` keeps the layer's matrix products with no batch dimension
    and recomputes the rest; ``"none"`` keeps everything.  On ``mesh``,
    ``specs`` is the stage's placement and ``seq`` the sequence's split
    (:func:`_layer_forward`)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    count = next(iter(stage_params.values())).shape[0]
    layers: List[Dict[str, torch.Tensor]] = [{} for _ in range(count)]
    for k, v in stage_params.items():
        # a stage of one layer takes a view: unbind's backward would stack
        # the gradient into a copy (3.2 GB for one of grok's expert leaves)
        for i, t in enumerate(v.unbind(0) if count > 1 else (v.squeeze(0),)):
            layers[i][k[4:]] = t
    kw = ({"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                           _dots_policy)}
          if remat == "dots" else {})
    # the layer's placement: the stage's without its stack dim
    lspecs = {k[4:]: tuple(v)[1:] for k, v in (specs or {}).items()}
    aux_total = None
    for i, lp in enumerate(layers):
        e = None if enc_out is None else (enc_out[0][i], enc_out[1][i])
        if cache is None and remat != "none":
            x, aux = checkpoint(_remat_layer, lp, x, cfg, kind, e, placement,
                                mesh, whole_batch, seq, lspecs,
                                use_reentrant=False, **kw)
        else:
            c = None if cache is None else {k: t[i] for k, t in cache.items()}
            x, new, aux = _layer_forward(lp, x, cfg, kind, cache=c, pos=pos,
                                         enc_out=e, placement=placement,
                                         mesh=mesh, whole_batch=whole_batch,
                                         seq=seq, specs=lspecs)
            for k, t in (new or {}).items():
                if t is not c[k]:
                    c[k].copy_(t)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, cache, aux_total


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    """Functional model handle for one architecture config; with ``mesh``
    (a ``DeviceMesh`` with ``data`` and ``model`` axes) the rank's part of
    the model trained on that mesh, its parameters placed by ``specs``."""

    cfg: Any
    mesh: Any = None
    # the expert placement on each device it was asked for, built once
    _placements: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    # None, or a function of a stage's layer kind that returns a context
    # manager to run that stage in (``launch.serve_profile`` times each
    # kind with it)
    on_stage: Any = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        _check_ported(self.cfg)
        self.specs = None
        if self.mesh is not None:
            from .convert import param_shapes
            check_mesh(self.cfg, self.mesh)
            self.specs = spec_tree(param_shapes(self.cfg), self.mesh,
                                   self.cfg.expert_sharding, self.cfg.mlp_dp)

    def _seq(self, length: int):
        """The split of a full sequence of ``length`` rows over ``model``
        (a ``layers.SeqShard``) under ``seq_parallel`` on a mesh whose model
        axis has more than one rank; None otherwise (the flag changes
        nothing there)."""
        m = _model_axis(self.mesh)
        if self.mesh is None or not self.cfg.seq_parallel or m == 1:
            return None
        return SeqShard(self.mesh, length)

    def _stage_specs(self, group: str, sname: str):
        return None if self.specs is None else self.specs[group][sname]

    def _vocab_rank(self):
        """(the number of vocabulary slices, this rank's slice): the
        placement of ``embed`` (``lm_head`` for an untied config) splits the
        vocabulary over ``model`` when the axis divides it, and replicates
        it otherwise (whisper's 51,865, hymba's 32,001): (1, 0) then, as
        off a mesh."""
        if self.specs is None:
            return 1, 0
        spec = (self.specs["embed"][0] if self.cfg.tie_embeddings
                else self.specs["lm_head"][-1])
        if spec != "model":
            return 1, 0
        return _model_axis(self.mesh), axis_index(self.mesh, "model")

    def placement(self, device):
        """The config's expert placement, (E,) int64 on ``device``, or None
        for ``"default"`` (the identity) and dense models; the greedy
        partition and its copy to the card are made once per model and
        device, not once per step."""
        cfg = self.cfg
        if not cfg.n_experts or cfg.expert_placement == "default":
            return None
        device = torch.device(device)
        if device not in self._placements:
            self._placements[device] = torch.from_numpy(
                expert_placement(cfg)).to(device=device, dtype=torch.long)
        return self._placements[device]

    def _lookup(self, params, tokens):
        """(embeddings, partial): on a mesh whose placement splits
        ``embed``, the vocab-parallel lookup, this rank's rows and zeros
        elsewhere, to be summed over ``model`` (``partial``); else the plain
        lookup of the whole table (its gradient whole on every model rank:
        nothing is summed over ``model``).  Scaled by ``sqrt(d_model)``
        for ``scale_embed``: a row has one nonzero term in the sum, so
        scaling before the sum gives the same bits."""
        m, r = self._vocab_rank()
        if m > 1:
            w = params["embed"]
            local = tokens.long() - r * w.shape[0]
            inside = (local >= 0) & (local < w.shape[0])
            x = w[local.clamp(0, w.shape[0] - 1)] * inside[..., None].to(w.dtype)
        else:
            x = params["embed"][tokens]
        if self.cfg.scale_embed:
            # the scale rounded to x's dtype, as the reference's; a host
            # scalar, so the card's decode step does not wait for a copy
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x, m > 1

    def embed(self, params, tokens):
        """Token embeddings; on a mesh that splits the vocabulary, each
        rank's lookup summed over ``model`` (:meth:`_lookup`)."""
        x, partial = self._lookup(params, tokens)
        return coll.reduce_over_axis(x, self.mesh, "model") if partial else x

    def unembed_chunked(self, params, h, targets, mask, seq=None):
        """Chunked softmax cross-entropy in float32; never materializes
        (B, S, V).  h: (B, S, D); targets/mask: (B, S).  Returns
        ``(sum_loss, sum_mask)``, the chunks' sums added in order as the
        reference's scan does.  The logits product is ``torch.matmul`` (the
        reference leaves it to XLA); the embedding is cast to float32 once
        per call.  On a mesh whose placement splits the vocabulary each rank
        holds a vocab slice: the row maxima are all-reduced (max) and the
        sums of exponentials and the gold logits (summed) over ``model``,
        each chunk's in one call.  A replicated vocabulary's logits are
        computed whole on every model rank, with no collective: ``h`` and
        the leaf's gradients are then whole on each rank already.  With
        ``seq`` (a ``layers.SeqShard``) ``h`` is the rank's rows of the
        sequence, gathered whole first (its gradient summed back over
        ``model`` for a split vocabulary, cut to the rank's rows for a
        replicated one)."""
        cfg = self.cfg
        m, r = self._vocab_rank()
        w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        if seq is not None:
            h = seq.gather(h) if m > 1 else seq.unsplit(h)
        b, s, d = h.shape
        c = min(LOSS_CHUNK, s)
        pad = (-s) % c
        if pad:
            h = torch.nn.functional.pad(h, (0, 0, 0, pad))
            targets = torch.nn.functional.pad(targets, (0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        wf = w.float()
        wf = wf.t() if cfg.tie_embeddings else wf
        if m > 1 and seq is None:
            h = coll.copy_to_axis(h, self.mesh, "model")
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        mask_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(h.shape[1] // c):
            sl = slice(i * c, (i + 1) * c)
            logits = h[:, sl].float() @ wf
            if m > 1:
                lse, gold = self._vocab_parallel_lse_gold(
                    logits, targets[:, sl].long() - r * wf.shape[1])
            else:
                lse = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1, targets[:, sl, None].long())[..., 0]
            nll = (lse - gold) * mask[:, sl]
            loss_sum = loss_sum + nll.sum()
            mask_sum = mask_sum + mask[:, sl].sum()
        return loss_sum, mask_sum

    def _vocab_parallel_lse_gold(self, logits, local_targets):
        """(logsumexp, gold logit) of rows whose logits are split over
        ``model``: ``logits`` this rank's (B, c, V / m) slice,
        ``local_targets`` the targets less the slice's first id."""
        mx = logits.detach().amax(-1)
        coll.all_reduce(mx, self.mesh, "model", op="max")
        se = torch.exp(logits - mx[..., None]).sum(-1)
        inside = (local_targets >= 0) & (local_targets < logits.shape[-1])
        gold = torch.gather(logits, -1, local_targets.clamp(
            0, logits.shape[-1] - 1)[..., None])[..., 0] * inside
        se, gold = coll.reduce_over_axis(torch.stack([se, gold]), self.mesh,
                                         "model").unbind(0)
        return torch.log(se) + mx, gold

    def logits_last(self, params, h):
        """(B, S, D) -> (B, 1, V) float32 logits of the last position, the
        product in float32 as the reference computes it."""
        w = params["embed"] if self.cfg.tie_embeddings else params["lm_head"]
        w = w.float()
        return h[:, -1:].float() @ (w.t() if self.cfg.tie_embeddings else w)

    def encode(self, params, enc_embeds, seq=None):
        """whisper's encoder: (B, Se, D) frame embeddings (the stubbed audio
        front end's output) plus the learned ``enc_pos``, the ``enc``
        layers, the encoder's final norm -> (B, Se, D).  The embeddings are
        cast to the model's dtype (the reference would promote float32
        embeddings over bf16 weights to float32 activations; the port's
        products take one dtype).  With ``seq`` (a ``layers.SeqShard`` of
        Se rows) the frames and positions, added whole, are cut to the
        rank's rows, and so is the output."""
        cfg = self.cfg
        pos = params["enc_pos"]
        x = enc_embeds.to(pos.dtype) + pos[None, : enc_embeds.shape[1]]
        if seq is not None:
            x = seq.split(x)
        with (self.on_stage("enc") if self.on_stage else contextlib.nullcontext()):
            x, _, _ = run_stage(params["enc_stages"]["e0"], x, cfg, "enc",
                                mesh=self.mesh, seq=seq,
                                specs=self._stage_specs("enc_stages", "e0"))
        return norm(params["enc_final_norm"], x, cfg.norm)

    def cross_kv(self, params, enc_out, seq=None):
        """Each decoder stage's cross K/V from the encoder's output (B, Se,
        D): ``{stage: (k, v)}``, each (count, B, Se, KV, D), computed once
        per input and read by every prefill and decode step (``enc_out`` of
        :meth:`backbone`).  A plain matrix product of the stacked weights,
        as the reference's einsum.  On a mesh whose model axis splits the
        projections each rank's columns of ``stk_xwk``/``stk_xwv`` give the
        K/V its form reads (:func:`.attention.kv_of_form`: its KV heads, the
        one its query heads share, or all of them), ``enc_out`` entering
        through ``layers.tp_enter`` (the encoder's gradient sums every
        rank's share); else every rank computes them whole.  With ``seq``
        (the encoder's ``layers.SeqShard``) ``enc_out`` is the rank's rows,
        gathered whole first."""
        cfg = self.cfg
        hd = cfg.head_dim
        m = _model_axis(self.mesh)
        split = self.mesh is not None and projections_split(cfg, m)
        if split and m > 1:
            enc_out = tp_enter(enc_out, self.mesh, seq)
        elif seq is not None:
            enc_out = seq.unsplit(enc_out)
        b, se, _ = enc_out.shape
        out = {}
        for sname, sp in params["stages"].items():
            if "stk_xwk" in sp:
                xk, xv = (torch.matmul(enc_out[None], sp[w][:, None])
                          for w in ("stk_xwk", "stk_xwv"))
                if split:
                    xk, xv = kv_of_form(xk, xv, cfg, self.mesh, head_split(cfg, m))
                out[sname] = (xk.reshape(-1, b, se, xk.shape[-1] // hd, hd),
                              xv.reshape(-1, b, se, xv.shape[-1] // hd, hd))
        return out

    def backbone(self, params, x, *, cache=None, pos=None, enc_out=None,
                 remat="none", whole_batch=False, seq=None):
        """The decoder stack and the final norm.  Returns (x, cache, aux):
        the float32 sum of the MoE layers' load-balance losses, None for a
        dense model (whose loss the reference counts as 0; the dense decode
        path makes no tensor for it).  ``enc_out``: whisper's cross K/V,
        :meth:`cross_kv`'s dict.  ``whole_batch``: on a mesh, each data rank
        holds the whole batch (:mod:`.moe`).  ``seq``: ``x`` is the rank's
        rows of the sequence (a ``layers.SeqShard``), and so is the
        output."""
        cfg = self.cfg
        placement = self.placement(x.device)
        aux_total = None
        for i, (kind, _) in enumerate(stages_meta(cfg)):
            sname = f"s{i}"
            xkv = enc_out[sname] if kind == "xdec" and enc_out else None
            with (self.on_stage(kind) if self.on_stage else contextlib.nullcontext()):
                x, _, aux = run_stage(params["stages"][sname], x, cfg, kind,
                                      cache=None if cache is None else cache[sname],
                                      pos=pos, enc_out=xkv, placement=placement,
                                      remat=remat, mesh=self.mesh,
                                      whole_batch=whole_batch, seq=seq,
                                      specs=self._stage_specs("stages", sname))
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return norm(params["final_norm"], x, cfg.norm), cache, aux_total

    def loss(self, params, batch, remat="none"):
        """Next-token loss, float32, plus ``0.01`` times the MoE layers'
        load-balance loss, as in the reference.  batch: ``{"tokens": (B,
        S)}``; position ``i`` predicts token ``i + 1`` and the last position
        is masked, as in the reference.  An encoder-decoder's batch holds
        ``enc_embeds`` (B, Se, D): :meth:`encode`, then :meth:`cross_kv`,
        and the decoder reads them (``remat`` applies to the decoder's
        layers, the encoder's run whole, as in the reference); another
        config ignores them.  A vision config's batch may hold
        ``img_embeds`` (B, F, D): they take the first F positions, followed
        by the embedded ``tokens[:, :S - F]``; position ``i`` predicts the
        sequence's entry ``i + 1``, so the image positions but the last
        (which predicts the first text token) are masked, as in the
        reference (another config ignores them, as the reference does).
        On a mesh ``batch`` is this rank's block (its rows' images and
        frames too, ``training.fault_tolerance.batch_block``) and the
        result the global loss: each rank's share, its rows' loss divided
        by the mask count summed over the data axes, summed over the data
        axes (two all-reduces per data axis; a replicated batch too, its
        count and its shares each taken once a data rank).  Under
        ``seq_parallel`` the sequence (and an encoder's frames) is split
        over ``model`` from the embedding to the loss (module docstring).
        The gradient of the sum passes back unchanged, so each rank's
        gradients are those of its share: the train step sums them over the
        data axes.  The MoE layers' load-balance loss is global on every
        rank in the same way (:mod:`.moe`), so ``0.01`` times it is added
        once; ``batch["whole_batch"]`` (a replicated batch on a mesh) tells
        their routing that every data rank holds every group."""
        cfg = self.cfg
        tokens = batch["tokens"]
        seq = self._seq(tokens.shape[1])
        enc = None
        if cfg.n_encoder_layers:
            frames = batch["enc_embeds"]
            seq_e = self._seq(frames.shape[1])
            enc = self.cross_kv(params, self.encode(params, frames, seq=seq_e),
                                seq=seq_e)
        if cfg.frontend == "vision" and "img_embeds" in batch:
            img = batch["img_embeds"].to(_dtype(cfg))
            fl = img.shape[1]
            text = tokens[:, : tokens.shape[1] - fl]
            x, partial = self._lookup(params, text)
            if partial and axis_index(self.mesh, "model"):
                # the prefix counted once in the sum over model
                img = torch.zeros_like(img)
            x = torch.cat([img, x], dim=1)
            targets = torch.cat([tokens.new_zeros((tokens.shape[0], fl - 1)),
                                 text, text[:, -1:]], dim=1)
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=tokens.device)
            mask[:, : fl - 1] = 0.0
        else:
            x, partial = self._lookup(params, tokens)
            targets = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=tokens.device)
        mask[:, -1] = 0.0
        if seq is not None:
            x = seq.scatter(x) if partial else seq.split(x)
        elif partial:
            x = coll.reduce_over_axis(x, self.mesh, "model")
        h, _, aux = self.backbone(params, x, enc_out=enc, remat=remat,
                                  whole_batch=bool(batch.get("whole_batch")),
                                  seq=seq)
        loss_sum, mask_sum = self.unembed_chunked(params, h, targets, mask, seq=seq)
        axes = data_axes(self.mesh)
        for a in axes:
            coll.all_reduce(mask_sum, self.mesh, a)
        loss = loss_sum / torch.clamp(mask_sum, min=1.0)
        for a in axes:
            loss = coll.reduce_over_axis(loss.reshape(1), self.mesh, a)[0]
        return loss if aux is None else loss + 0.01 * aux

    def init_cache(self, batch: int, s_max: int, dtype=torch.bfloat16,
                   device=None):
        """Per-stage decode cache, the reference's tree: attention stages
        {"k", "v"} of (count, batch, s_max, KV, D) in ``dtype`` (whisper's
        ``xdec`` stages their self-attention's only: the cross K/V are
        ``enc_out``, made once by :meth:`cross_kv`); a hybrid
        stage those and the SSM's "h", "conv"; an mLSTM stage "c", "n",
        "m"; an sLSTM stage "c", "n", "m", "h" (the states float32)."""
        cfg = self.cfg
        cache = {}
        for i, (kind, count) in enumerate(stages_meta(cfg)):
            c = (kv_init_cache(cfg, batch, s_max, count, dtype, device)
                 if has_attention(kind) else {})
            if _block(kind) is not None:
                c.update(_block(kind).init_state(cfg, batch, count, device))
            cache[f"s{i}"] = c
        return cache

    def _no_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} on a mesh (sharded serving) is not ported "
                "(ROADMAP item 12)")

    def prefill(self, params, batch, s_max: int, enc_out=None):
        """Encode a full prompt, returning (last-token logits, filled cache).
        An encoder-decoder reads its cross K/V from ``enc_out``
        (:meth:`cross_kv`'s dict); without it, it encodes
        ``batch["enc_embeds"]`` first, as the reference's prefill does."""
        self._no_mesh("prefill")
        tokens = batch["tokens"]
        b = tokens.shape[0]
        device = params["embed"].device
        x = self.embed(params, tokens)
        if self.cfg.n_encoder_layers and enc_out is None:
            enc_out = self.cross_kv(params, self.encode(params, batch["enc_embeds"]))
        cache = self.init_cache(b, s_max, _dtype(self.cfg), device)
        pos = torch.zeros((b,), dtype=torch.int32, device=device)
        h, cache, _ = self.backbone(params, x, cache=cache, pos=pos,
                                    enc_out=enc_out)
        return self.logits_last(params, h), cache

    def decode_step(self, params, token, cache, pos, enc_out=None):
        """One token step.  token: (B, 1); pos: (B,) current write index;
        ``enc_out``: an encoder-decoder's cross K/V (:meth:`cross_kv`).
        The cache is written in place and returned."""
        self._no_mesh("decode_step")
        x = self.embed(params, token)
        h, cache, _ = self.backbone(params, x, cache=cache, pos=pos,
                                    enc_out=enc_out)
        return self.logits_last(params, h), cache
