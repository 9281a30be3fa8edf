"""Jobs run on every rank of a mesh: the rank function that ``run_ranks``
starts for the mesh mines, streams and training runs of ``chip_smoke.py``,
``launch.train --mesh`` and the tests.

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.mesh_runs import run_jobs
    per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cpu",
                         args=([{"kind": "mine", ...}, ...],))

Each job is a plain dict; each rank returns one plain dict per job, in
order, so results pickle back to the parent.  The mesh of a job comes from
``launch.mesh.mesh_for_mining(backend, shard, grid)``, the routing of the
driver's flags.  Kinds:

``mine``        ``mine()`` of ``txns`` (a list of transactions, or
                ``("generate", name, scale, seed)``) with ``config`` (the
                ``EclatConfig`` fields), ``reps`` times; returns the
                checksum, the levels, the kernel launches and collectives of
                the last run, its engine stats and the wall time of each run
                (``support_map=True`` adds the whole map)
``expand``      one ``Engine.expand`` of a level-1 frontier ``bitmaps``
                (uint32) through ``prepare_frontier``; returns the level
                result with this rank's survivor rows, the engine's stats and
                the collectives of that expand alone (``compact``: the
                engine's knob, default True)
``accumulate``  the v3 mesh accumulator (``build_vertical_accumulated``)
``stream``      a ``StreamingMiner`` with ``config`` (the ``StreamConfig``
                fields) on the rank's mesh, sliding the batches of
                ``stream`` (``(name, batch_txns, n_batches, seed,
                drift_every)``, regenerated on the rank: the stream is
                deterministic) or of ``batches`` (a list of micro-batches);
                returns per slide the checksum, the levels, the engine stats
                of the slide, and the kernel launches and collectives of its
                push and of its mine apart (``support_map=True`` /
                ``cooc=True`` add the map and the count matrix); then the
                rank's device ring and ``validate()``'s verdict
``stream_ckpt`` a ``StreamingMiner`` sliding ``batches`` with a
                ``StreamCheckpointer`` into ``directory`` (every ``every``
                slides, waiting for each write; the lead rank writes), with
                an optional fault ``kill = (point, slide)`` raised at the
                first hit of the kill point from that slide on; after each
                slide the ranks agree (one all-reduce of a flag per mesh
                axis) whether any rank faulted, and all stop if one did;
                returns whether the fault fired and the durable steps
``stream_restore``  ``restore_miner`` of ``directory`` on the rank's mesh
                (``config`` overrides ``backend``/``shard``), then the
                slides of ``batches`` from the restored step on; returns
                the restore's step, seconds and collectives, and per slide
                the same record as ``stream`` (``support_map=True`` adds the
                map), then ``validate()``'s verdict; with ``checkpoint``
                (``(directory, every)``) the replay checkpoints as it goes
``resume``      ``resume_mine`` with ``config`` (the ``EclatConfig`` fields)
                on the rank's mesh; returns the checksum, the levels, the
                launches, the stats' collectives and the resumed level
``mesh``        ``mesh_descriptor`` of the mesh
``compressed_psum``  ``training.compressed_psum`` over the ``data`` axis of
                a 1D mesh of every rank: rank ``r`` contributes ``x[r]`` (a
                numpy array) with ``method``; returns the result as numpy
``train``       ``launch.train.train_run`` of the job on the mesh ``mesh``:
                a name (``launch.mesh.make_mesh_named``; e.g. ``"tiny"``)
                or ``(shape, axes)`` (``launch.mesh.make_mesh``; e.g.
                ``((2, 2, 1), ("pod", "data", "model"))``);
                returns its record (losses, grad norms, per step the
                seconds, launches and collectives; ``gather=True`` adds the
                final params whole on the lead rank)
``moe``         one MoE layer (``models.moe.moe``) of the config (``arch``,
                ``reduced``, ``cfg`` as for ``train``) on the mesh ``mesh``
                (as for ``train``), forward and backward: ``layer`` the layer's
                weights (numpy, the reference's keys without ``stk_``),
                ``x`` and ``dout`` the global (B, S, D) input and output
                weights (numpy); each rank takes its blocks (the batch by
                ``batch_spec``, whole when the data axes do not divide
                it); the objective is ``sum(out * dout) + aux_loss``.
                Returns the rank's index over the data axes (``data``,
                pod-major) and their rank count (``n_data``), its output block,
                the global ``expert_load``, ``dropped_frac`` and
                ``aux_loss``, the input's gradient (this rank's block) and
                the weights' gradients whole on the lead rank
``block``       one recurrent block or attention layer of the config
                (``arch``, ``reduced``, ``cfg`` as for ``train``; ``block``
                ``"mlstm"``, ``"slstm"``, ``"ssm"`` or ``"attention"``,
                the latter with the config's window) on a mesh of one
                ``model`` axis
                over every rank, forward and backward: ``layer`` the
                block's stacked weights (numpy, ``stk_`` keys, a stack of
                one), placed by ``spec_tree``; ``x`` and ``dout`` the
                (B, S, D) input and output weights (numpy, replicated);
                the objective is ``sum(out * dout)``.  Returns the output,
                the input's gradient, the weights' specs and this rank's
                gradients of its blocks (``local``), the gradients whole on
                the lead rank, and the collectives of the call

A job that the port refuses (``ValueError``, ``TypeError``,
``NotImplementedError``) returns ``{"error": "<type>: <message>"}``; any
other failure fails the rank.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import torch

from .. import kernels
from ..kernels import autotune
from ..core import (EclatConfig, build_vertical_accumulated, mine, resume_mine,
                    support_checksum)
from ..core.engine import resolve_engine
from ..data import generate, transaction_stream
from ..device import words_from_numpy, words_to_numpy
from ..dist import collectives as coll
from ..dist.sharding import mesh_descriptor
from ..faults import InjectedFault, clear_kill_hook, set_kill_hook
from ..streaming import (StreamCheckpointer, StreamConfig, StreamingMiner,
                         restore_miner)
from ..training import compressed_psum, valid_steps
from .mesh import mesh_for_mining

__all__ = ["run_jobs"]

_REFUSED = (ValueError, TypeError, NotImplementedError)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Rank:
    """Per-rank caches: one mesh per (backend, shard, grid), one dataset
    per generator call."""

    def __init__(self, device: torch.device):
        self.device = device
        self.meshes: Dict[tuple, object] = {}
        self.data: Dict[tuple, tuple] = {}

    def mesh(self, job: dict):
        key = (job.get("backend", "fused"), job.get("shard", "pairs"),
               job.get("grid"))
        if key not in self.meshes:
            self.meshes[key] = mesh_for_mining(*key)
        return self.meshes[key]

    def batches(self, job: dict):
        if "batches" in job:
            return job["batches"]
        key = ("stream",) + tuple(job["stream"])
        if key not in self.data:
            name, batch_txns, n_batches, seed, drift = job["stream"]
            self.data[key] = list(transaction_stream(
                name, batch_txns, n_batches, seed=seed, drift_every=drift))
        return self.data[key]

    def transactions(self, job: dict):
        txns = job["txns"]
        if isinstance(txns, tuple) and txns and txns[0] == "generate":
            if txns not in self.data:
                got, spec = generate(txns[1], scale=txns[2], seed=txns[3])
                self.data[txns] = (got, spec.n_items)
            return self.data[txns]
        return txns, job["n_items"]


def _mine(rank: _Rank, job: dict) -> dict:
    cfg = EclatConfig(**job["config"])
    mesh = rank.mesh(dict(job, backend=cfg.backend, shard=cfg.shard))
    txns, n_items = rank.transactions(job)
    dev = rank.device
    walls = []
    tuner_before = autotune.launches
    for _ in range(int(job.get("reps", 1))):
        kernels.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        res = mine(txns, n_items, cfg, device=dev, mesh=mesh)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    st = res.stats
    out = dict(checksum=support_checksum(res.support_map()), counts=res.counts,
               total=res.total, launches=kernels.launch_counts(),
               tuner_launches=autotune.launches - tuner_before,
               wall_s=walls, mesh=mesh_descriptor(mesh),
               n_expands=len(st.get("pair_padding", {}).get("per_level", [])),
               stats={k: st[k] for k in (
                   "backend", "phase_s", "n_words", "n_word_shards", "grid",
                   "frontier_words", "collectives", "pair_padding",
                   "device_balance", "n_intersections", "n_padded",
                   "abs_min_sup") if k in st})
    if job.get("support_map"):
        out["support_map"] = res.support_map()
    return out


def _expand(rank: _Rank, job: dict) -> dict:
    mesh = rank.mesh(job)
    dev = rank.device
    engine = resolve_engine(job.get("inner", "fused"), mesh,
                            bucket_min=job.get("bucket_min", 128),
                            shard=job.get("shard", "pairs"),
                            compact=job.get("compact", True))
    frontier = engine.prepare_frontier(words_from_numpy(job["bitmaps"], dev))
    kernels.reset_launch_counts()
    before = coll.collective_counts()
    res = engine.expand(frontier, job["left"], job["right"], job["sup_left"],
                        mode=job["mode"], min_sup=job["min_sup"],
                        device_of_pair=job.get("device_of_pair"))
    _sync(dev)
    return dict(mask=res.mask, supports=res.supports,
                survivors=words_to_numpy(res.bitmaps),
                frontier_shape=tuple(frontier.shape), stats=engine.stats(),
                device_pair_counts=[c.tolist() for c in engine.device_pair_counts],
                collectives=coll.counts_since(before),
                launches=kernels.launch_counts(), mesh=mesh_descriptor(mesh))


def _accumulate(rank: _Rank, job: dict) -> dict:
    mesh = rank.mesh(job)
    txns, n_items = rank.transactions(job)
    before = coll.collective_counts()
    db = build_vertical_accumulated(txns, n_items, job["min_sup"],
                                    order=job.get("order", "support_asc"),
                                    mesh=mesh, axis=job.get("axis", "data"),
                                    device=rank.device)
    return dict(bitmaps=db.bitmaps, items=db.items, supports=db.supports,
                n_txn=db.n_txn, collectives=coll.counts_since(before))


_SLIDE_STATS = ("abs_min_sup", "classes", "window", "phase_s", "backend",
                "n_intersections", "n_padded", "pair_padding",
                "device_balance", "frontier_words", "n_word_shards",
                "total_s")


def _stream(rank: _Rank, job: dict) -> dict:
    cfg = StreamConfig(**job["config"])
    mesh = rank.mesh(dict(job, backend=cfg.backend, shard=cfg.shard))
    dev = rank.device
    miner = StreamingMiner(job["n_items"], cfg, mesh=mesh, device=dev)
    tuner_before = autotune.launches
    slides = [_slide_record(miner, batch, dev, job) for batch in rank.batches(job)]
    valid = _validate(miner)
    ring = miner.ring
    return dict(slides=slides, ring=words_to_numpy(ring.device),
                tuner_launches=autotune.launches - tuner_before,
                ring_geometry=dict(n_words=ring.n_words,
                                   n_words_dev=ring.n_words_dev,
                                   local_words=ring.local_words,
                                   word_lo=ring.word_lo),
                validate=valid, engine=miner.engine.name,
                mesh=mesh_descriptor(mesh))


def _slide_record(miner, batch, dev, job) -> dict:
    """One slide (push, then mine) with its launches and collectives apart,
    as the ``stream`` job records it."""
    kernels.reset_launch_counts()
    before = coll.collective_counts()
    _sync(dev)
    t0 = time.perf_counter()
    push = miner.push(batch)
    _sync(dev)
    push_s = time.perf_counter() - t0
    push_launches = kernels.launch_counts()
    push_coll = coll.counts_since(before)
    kernels.reset_launch_counts()
    before = coll.collective_counts()
    res = miner.mine_window()
    _sync(dev)
    st = res.stats
    slide = dict(checksum=support_checksum(res.support_map()),
                 counts=res.counts, total=res.total, n_txn=res.n_txn,
                 version=res.version, push_s=push_s,
                 n_evicted=push["n_evicted"],
                 slide_s=push_s + st["total_s"],
                 n_expands=len(st.get("pair_padding", {}).get("per_level", [])),
                 push_launches=push_launches,
                 mine_launches=kernels.launch_counts(),
                 push_collectives=push_coll,
                 mine_collectives=coll.counts_since(before),
                 stats={k: st[k] for k in _SLIDE_STATS if k in st})
    if job.get("support_map"):
        slide["support_map"] = res.support_map()
    if job.get("cooc"):
        slide["cooc"] = miner.cooc.copy()
    return slide


def _validate(miner) -> str:
    try:
        miner.ring.validate()
        return "ok"
    except RuntimeError as e:
        return f"RuntimeError: {e}"


def _raiser(point: str):
    """A kill hook raising ``InjectedFault`` at the first hit of ``point``."""
    def hook(name):
        if name == point:
            raise InjectedFault(point)
    return hook


def _any_rank(flag: int, mesh, dev) -> bool:
    """Whether ``flag`` is set on any rank of the mesh (one all-reduce per
    mesh axis)."""
    t = torch.tensor([int(flag)], dtype=torch.int64,
                     device=dev if mesh.device_type == "cuda" else "cpu")
    for axis in mesh.mesh_dim_names:
        coll.all_reduce(t, mesh, axis)
    return bool(t.item())


def _stream_ckpt(rank: _Rank, job: dict) -> dict:
    cfg = StreamConfig(**job["config"])
    mesh = rank.mesh(dict(job, backend=cfg.backend, shard=cfg.shard))
    miner = StreamingMiner(job["n_items"], cfg, mesh=mesh,
                           keep_transactions=False, device=rank.device)
    ck = StreamCheckpointer(job["directory"], every=job.get("every", 1),
                            keep=job.get("keep", 3))
    kill = job.get("kill")
    fired = False
    try:
        for i, batch in enumerate(rank.batches(job)):
            if kill is not None and i == kill[1]:
                set_kill_hook(_raiser(kill[0]))
            fault = False
            try:
                miner.advance(batch)
                if ck.maybe_save(miner, i + 1):
                    ck.wait()
            except InjectedFault:
                fault = True
            if _any_rank(fault, mesh, rank.device) if mesh is not None else fault:
                fired = True
                break
    finally:
        clear_kill_hook()
    return dict(fired=fired, steps=valid_steps(job["directory"]))


def _stream_restore(rank: _Rank, job: dict) -> dict:
    cfg = job["config"]
    mesh = rank.mesh(job)
    dev = rank.device
    kernels.reset_launch_counts()
    miner, start = restore_miner(job["directory"], mesh=mesh,
                                 backend=cfg.get("backend"),
                                 shard=cfg.get("shard"),
                                 keep_transactions=False, device=dev)
    restore_launches = kernels.launch_counts()
    ck = (StreamCheckpointer(job["checkpoint"][0], every=job["checkpoint"][1])
          if job.get("checkpoint") else None)
    slides = []
    batches = rank.batches(job)
    for i in range(start, len(batches)):
        slides.append(_slide_record(miner, batches[i], dev, job))
        if ck is not None and ck.maybe_save(miner, i + 1):
            ck.wait()
    return dict(start=start, restore_stats=dict(miner.restore_stats),
                restore_launches=restore_launches, slides=slides,
                validate=_validate(miner), engine=miner.engine.name,
                mesh=mesh_descriptor(mesh))


def _resume(rank: _Rank, job: dict) -> dict:
    cfg = EclatConfig(**job["config"])
    mesh = rank.mesh(dict(job, backend=cfg.backend, shard=cfg.shard))
    dev = rank.device
    kernels.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    res = resume_mine(cfg, device=dev, mesh=mesh)
    _sync(dev)
    st = res.stats
    return dict(checksum=support_checksum(res.support_map()), counts=res.counts,
                total=res.total, launches=kernels.launch_counts(),
                wall_s=time.perf_counter() - t0, resume_k=st["resume_k"],
                n_expands=len(st.get("pair_padding", {}).get("per_level", [])),
                collectives=st.get("collectives"), backend=st["backend"],
                mesh=mesh_descriptor(mesh))


def _mesh(rank: _Rank, job: dict) -> dict:
    return dict(mesh=mesh_descriptor(rank.mesh(job)))


def _compressed_psum(rank: _Rank, job: dict) -> dict:
    mesh = rank.mesh(dict(job, backend="sharded", shard="pairs"))
    x = torch.from_numpy(job["x"][mesh.get_coordinate()[0]]).to(rank.device)
    out = compressed_psum(x, mesh, "data", method=job.get("method", "int8"))
    return dict(out=out.cpu().numpy(), collectives=coll.collective_counts())


def _job_mesh(rank: _Rank, spec):
    """The mesh a ``train`` or ``moe`` job names (a name, or ``(shape,
    axes)``), built once a rank."""
    from .mesh import make_mesh, make_mesh_named
    named = isinstance(spec, str)
    key = ("named", spec if named else (tuple(spec[0]), tuple(spec[1])))
    if key not in rank.meshes:
        rank.meshes[key] = make_mesh_named(spec) if named else make_mesh(*spec)
    return rank.meshes[key]


def _train(rank: _Rank, job: dict) -> dict:
    from .train import train_run
    return train_run(job, rank.device, _job_mesh(rank, job["mesh"]))


def _moe(rank: _Rank, job: dict) -> dict:
    from ..dist.sharding import (batch_spec, data_axes, data_rank, gather_tree,
                                 shard_tree, spec_axes, spec_tree)
    from ..models import Model
    from ..models.moe import moe
    from .train import _config
    mesh, cfg = _job_mesh(rank, job["mesh"]), _config(job)
    specs = spec_tree({k: v.shape for k, v in job["layer"].items()}, mesh,
                      cfg.expert_sharding, cfg.mlp_dp)
    host = {k: torch.from_numpy(v) for k, v in job["layer"].items()}
    p = {k: v.to(rank.device).requires_grad_()
         for k, v in shard_tree(host, mesh, specs).items()}
    axes = data_axes(mesh)
    index, nd = data_rank(mesh)
    rows = batch_spec(job["x"].shape[0], mesh)
    whole = rows == (None,)
    xs, gs = (torch.from_numpy(a) for a in (job["x"], job["dout"]))
    if not whole:
        xs, gs = (shard_tree({"t": t}, mesh, {"t": rows})["t"] for t in (xs, gs))
    x = xs.to(rank.device).requires_grad_()
    out, aux = moe(p, x, cfg, Model(cfg).placement(rank.device), mesh=mesh,
                   whole_batch=whole)
    loss = ((out.float() * gs.to(rank.device)).sum() / (nd if whole else 1)).reshape(1)
    for a in axes:
        loss = coll.reduce_over_axis(loss, mesh, a)
    loss = loss[0] + aux["aux_loss"]
    *gp, gx = torch.autograd.grad(loss, list(p.values()) + [x])
    grads = dict(zip(p, gp))
    # the train step's sums over the data axes: each weight over those it
    # is not split over, and a whole batch's input (each data rank holds a
    # share of its gradient)
    for name, g in grads.items():
        for a in axes:
            if a not in {ax for e in specs[name] for ax in spec_axes(e)}:
                coll.all_reduce(g, mesh, a)
    if whole:
        for a in axes:
            coll.all_reduce(gx, mesh, a)
    whole_grads = gather_tree(grads, mesh, specs)
    return dict(data=index, n_data=nd, whole=whole,
                out=out.detach().cpu().numpy(), dx=gx.cpu().numpy(),
                expert_load=aux["expert_load"].cpu().numpy(),
                dropped_frac=float(aux["dropped_frac"]),
                aux_loss=float(aux["aux_loss"].detach()),
                grads=None if whole_grads is None or any(
                    v is None for v in whole_grads.values())
                else {k: v.cpu().numpy() for k, v in whole_grads.items()})


def _block(rank: _Rank, job: dict) -> dict:
    from ..dist.sharding import gather_tree, is_lead_rank, shard_tree, spec_tree
    from ..models.attention import attention
    from ..models.ssm import ssm_block
    from ..models.xlstm import mlstm_block, slstm_block
    from .mesh import make_data_mesh
    from .train import _config
    key = ("axis", "model")
    if key not in rank.meshes:
        rank.meshes[key] = make_data_mesh("model")
    mesh, cfg = rank.meshes[key], _config(job)
    specs = spec_tree({k: v.shape for k, v in job["layer"].items()}, mesh,
                      cfg.expert_sharding, cfg.mlp_dp)
    host = {k: torch.from_numpy(v) for k, v in job["layer"].items()}
    p = {k: v.to(rank.device).requires_grad_()
         for k, v in shard_tree(host, mesh, specs).items()}
    x = torch.from_numpy(job["x"]).to(rank.device).requires_grad_()
    forward = {"mlstm": mlstm_block, "slstm": slstm_block, "ssm": ssm_block,
               "attention": lambda p, x, cfg, mesh: attention(
                   p, x, cfg, window=cfg.window, mesh=mesh)}[job["block"]]
    before = coll.collective_counts()
    out, _ = forward({k[4:]: v[0] for k, v in p.items()}, x, cfg, mesh=mesh)
    loss = (out.float() * torch.from_numpy(job["dout"]).to(rank.device)).sum()
    *gp, gx = torch.autograd.grad(loss, list(p.values()) + [x])
    calls = {a: {op: c["calls"] for op, c in ops.items()}
             for a, ops in coll.counts_since(before).items()}
    grads = gather_tree(dict(zip(p, gp)), mesh, specs)
    lead = is_lead_rank(mesh)
    return dict(lead=lead, out=out.detach().cpu().numpy(), dx=gx.cpu().numpy(),
                collectives=calls, specs=specs,
                local={k: g.cpu().numpy() for k, g in zip(p, gp)},
                grads={k: v.cpu().numpy() for k, v in grads.items()} if lead else None)


_KINDS = {"mine": _mine, "expand": _expand, "accumulate": _accumulate,
          "stream": _stream, "stream_ckpt": _stream_ckpt,
          "stream_restore": _stream_restore, "resume": _resume, "mesh": _mesh,
          "compressed_psum": _compressed_psum, "train": _train, "moe": _moe,
          "block": _block}


def run_jobs(device: torch.device, jobs: Sequence[dict]) -> List[dict]:
    """Run ``jobs`` in order on this rank's ``device`` (every rank runs the
    same list)."""
    rank = _Rank(device)
    out = []
    for job in jobs:
        try:
            out.append(_KINDS[job["kind"]](rank, job))
        except _REFUSED as e:
            out.append({"error": f"{type(e).__name__}: {e}"})
    return out
