"""Mining jobs run on every rank of a mesh: the rank function that
``run_ranks`` starts for the mesh mines of ``chip_smoke.py``, the tests and
the ``--ranks`` driver.

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
                the collectives of that expand alone
``accumulate``  the v3 mesh accumulator (``build_vertical_accumulated``)
``mesh``        ``mesh_descriptor`` of the mesh

A job that the port refuses (``ValueError``, ``TypeError``,
``NotImplementedError``) returns ``{"error": "<type>: <message>"}``; any
other failure fails the rank.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import torch

from .. import kernels
from ..core import EclatConfig, build_vertical_accumulated, mine, support_checksum
from ..core.engine import resolve_engine
from ..data import generate
from ..device import words_from_numpy, words_to_numpy
from ..dist import collectives as coll
from ..dist.sharding import mesh_descriptor
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
                            shard=job.get("shard", "pairs"))
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


def _mesh(rank: _Rank, job: dict) -> dict:
    return dict(mesh=mesh_descriptor(rank.mesh(job)))


_KINDS = {"mine": _mine, "expand": _expand, "accumulate": _accumulate,
          "mesh": _mesh}


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
