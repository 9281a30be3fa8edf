"""Layer 2: counted collective contracts over the engine backends (the
reference's ``staticcheck/contracts.py``).

The reference lowers each backend's level under a forced multi-device mesh
and walks the post-SPMD HLO.  Here each rank is a process and every
exchange is an explicit call of ``dist.collectives``, which counts its
calls, payload bytes and group width by (axis, op).  So one expansion of
each backend, and the streaming ring's block write, runs on gloo ranks
(``launch.mesh.run_ranks``), and what it counted is held to
:data:`BUDGETS`:

  IR001  the collective set of an expansion is exactly the declared one:
         calls by (axis, op);
  IR002  each collective stays within its declared payload: the
         all-reduce carries 4 bytes a padded pair of the rank's block, never
         bitmap words; a gather of supports 4 bytes a padded pair, of
         survivor rows at most one frontier row a padded pair;
  IR003  the all-reduce spans exactly the declared axis: the width of the
         group it ran over is that axis's size.

Each contract has a committed must-fail fixture (:data:`CONTRACT_FIXTURES`),
a small wrong program over the same collective functions that the same
assertions must reject.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .report import Finding

__all__ = ["BUDGETS", "BACKENDS_CHECKED", "BackendBudget", "RING_WRITE",
           "contract_findings", "check_all_contracts", "CONTRACT_FIXTURES",
           "check_contract_fixture", "RANKS"]

BACKENDS_CHECKED = ("fused", "ref", "sharded", "tidsharded", "grid")
RING_WRITE = "ring_write"
RANKS = 4                       # the mesh: 4 ranks, (data,) or 2 x 2 (class, data)
ROWS, WORDS = 32, 64            # the expanded frontier (every pair of its rows)


@dataclasses.dataclass
class BackendBudget:
    """Declared collectives of one expansion: calls by (axis, op); each
    one's payload, ``"counts"`` (4 bytes a padded pair of the rank's block)
    or ``"counts+rows"`` (that, plus at most one frontier row a padded
    pair); the axis the one all-reduce spans; and how the budget differs
    from the reference's and why."""

    collectives: Dict[Tuple[str, str], int]
    payload: Dict[Tuple[str, str], str]
    reduce_axis: Optional[str]
    versus_reference: str


BUDGETS: Dict[str, BackendBudget] = {
    "fused": BackendBudget({}, {}, None, "the reference's pallas: none"),
    "ref": BackendBudget({}, {}, None, "the reference's jnp: none"),
    "sharded": BackendBudget(
        {("data", "all_gather"): 2}, {("data", "all_gather"): "counts+rows"},
        None,
        "the reference declares none: its frontier is replicated and the host "
        "reads the pair-sharded result implicitly; here each rank is a process, "
        "so every rank's supports and survivor rows are all-gathered over the "
        "pair axis, counted, and nothing is all-reduced"),
    "tidsharded": BackendBudget(
        {("data", "all_reduce"): 1}, {("data", "all_reduce"): "counts"}, "data",
        "the reference's: one all-reduce of the (Q,) partial counts over data"),
    "grid": BackendBudget(
        {("data", "all_reduce"): 1, ("class", "all_gather"): 2},
        {("data", "all_reduce"): "counts", ("class", "all_gather"): "counts+rows"},
        "data",
        "the reference's one all-reduce over data, plus the all-gathers of the "
        "class blocks' supports and survivor rows over class, which the "
        "reference makes implicitly"),
    RING_WRITE: BackendBudget({}, {}, None,
                              "the reference's: a push writes only the rank's words"),
}


# ---------------------------------------------------------------------------
# what one expansion counts, on each rank
# ---------------------------------------------------------------------------

def _frontier(dev):
    import numpy as np
    from ..device import words_from_numpy
    rng = np.random.default_rng(0)
    return words_from_numpy(rng.integers(0, 2**32, (ROWS, WORDS), dtype=np.uint32), dev)


def _record(before: dict, mesh, qpad: int, row_words: int) -> dict:
    from ..dist import collectives as coll
    return {"counts": coll.counts_since(before),
            "widths": coll.collective_widths(),
            "axis_sizes": ({} if mesh is None else
                           dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))),
            "qpad": int(qpad), "row_bytes": 4 * int(row_words)}


def _expansion(dev, backend: str) -> dict:
    """One expansion of every pair of the frontier's rows on ``backend``,
    and what it counted."""
    import numpy as np
    from ..core import engine as eng
    from ..dist import collectives as coll
    from ..launch.mesh import make_data_mesh, make_grid_mesh
    mesh = {"sharded": make_data_mesh, "tidsharded": make_data_mesh,
            "grid": make_grid_mesh}.get(backend, lambda: None)()
    engine = eng.make_engine(backend, mesh=mesh)
    frontier = engine.prepare_frontier(_frontier(dev))
    left, right = np.triu_indices(ROWS, k=1)
    sup = np.full(left.size, 32 * WORDS, np.int32)
    coll.reset_collective_counts()
    before = coll.collective_counts()
    engine.expand(frontier, left.astype(np.int32), right.astype(np.int32), sup,
                  mode=eng.MODE_TIDSET, min_sup=1,
                  device_of_pair=np.arange(left.size) % engine.n_devices)
    q, padded = engine.level_padding[-1]
    return _record(before, mesh, padded // engine.n_devices, frontier.shape[1])


def _ring_write(dev) -> dict:
    """One push into a word-sharded ring (the mesh's ranks own its words)."""
    from ..dist import collectives as coll
    from ..launch.mesh import make_data_mesh
    from ..streaming.window import WindowRing
    mesh = make_data_mesh()
    ring = WindowRing(ROWS, 4, 128, keep_transactions=False, mesh=mesh, device=dev)
    coll.reset_collective_counts()
    before = coll.collective_counts()
    ring.push([[i % ROWS, (i * 7) % ROWS] for i in range(128)])
    return _record(before, mesh, 0, ring.local_words)


# -- must-fail fixtures: wrong programs over the same collectives -----------

def _fixture_extra_psum(dev) -> Tuple[dict, str]:
    """Two all-reduces of the counts where the contract declares one."""
    import torch
    from ..dist import collectives as coll
    from ..launch.mesh import make_data_mesh
    mesh = make_data_mesh()
    pop = torch.ones(256, dtype=torch.int32, device=dev)
    before = coll.collective_counts()
    coll.all_reduce(pop, mesh, "data")
    coll.all_reduce(pop * 0, mesh, "data")      # a second, redundant reduction
    return _record(before, mesh, 256, 16), "tidsharded"


def _fixture_frontier_allgather(dev) -> Tuple[dict, str]:
    """A level that all-gathers the word-sharded frontier and counts it
    whole, with no all-reduce."""
    import torch
    from ..dist import collectives as coll
    from ..launch.mesh import make_data_mesh
    mesh = make_data_mesh()
    block = torch.ones((256, 16), dtype=torch.int32, device=dev)
    before = coll.collective_counts()
    coll.all_gather(block, mesh, "data").sum(dim=(0, 2))
    return _record(before, mesh, 256, 16), "tidsharded"


def _fixture_fat_psum(dev) -> Tuple[dict, str]:
    """One all-reduce, but of the (Q, W) word block, not the (Q,) counts:
    the right collective set, a busted byte budget."""
    import torch
    from ..dist import collectives as coll
    from ..launch.mesh import make_data_mesh
    mesh = make_data_mesh()
    block = torch.ones((256, 16), dtype=torch.int32, device=dev)
    before = coll.collective_counts()
    coll.all_reduce(block, mesh, "data")
    return _record(before, mesh, 256, 16), "tidsharded"


def _fixture_wrong_axis_psum(dev) -> Tuple[dict, str]:
    """A grid level whose all-reduce spans every rank, not the data axis:
    the class blocks' disjoint pair counts get mixed."""
    import torch
    from ..dist import collectives as coll
    from ..launch.mesh import make_data_mesh, make_grid_mesh
    grid = make_grid_mesh()
    every = make_data_mesh()            # a "data" axis over all 4 ranks
    pop = torch.ones(256, dtype=torch.int32, device=dev)
    rows = torch.ones((256, 16), dtype=torch.int32, device=dev)
    before = coll.collective_counts()
    coll.all_reduce(pop, every, "data")
    coll.all_gather(pop, grid, "class")
    coll.all_gather(rows, grid, "class")
    return _record(before, grid, 256, 16), "grid"


CONTRACT_FIXTURES = {
    "extra_psum": _fixture_extra_psum,
    "frontier_allgather": _fixture_frontier_allgather,
    "fat_psum": _fixture_fat_psum,
    "wrong_axis_psum": _fixture_wrong_axis_psum,
}


def _rank(dev, targets: Sequence[str], fixtures: Sequence[str]) -> dict:
    """The job of one rank: every target's and fixture's record."""
    from ..dist import collectives as coll
    out = {}
    for t in targets:
        out[t] = (_ring_write(dev) if t == RING_WRITE else _expansion(dev, t), t)
    for name in fixtures:
        coll.reset_collective_counts()
        out[f"fixture:{name}"] = CONTRACT_FIXTURES[name](dev)
    return out


# ---------------------------------------------------------------------------
# the assertions, the same for the backends and the fixtures
# ---------------------------------------------------------------------------

def _payload_limit(kind: str, rec: dict) -> int:
    counts = 4 * rec["qpad"]
    return counts if kind == "counts" else counts + rec["qpad"] * rec["row_bytes"]


def contract_findings(target: str, rec: dict, budget: BackendBudget) -> List[Finding]:
    """IR001-IR003 of one record against ``budget``."""
    calls = {(axis, op): c["calls"] for axis, ops in rec["counts"].items()
             for op, c in ops.items()}
    findings: List[Finding] = []
    if calls != budget.collectives:
        findings.append(Finding(
            rule="IR001", path=target, line=0,
            message=f"collective set {calls or '{}'} does not match the "
                    f"declared {budget.collectives or '{}'} — an expansion may "
                    f"make exactly the declared calls and must never gather a "
                    f"frontier or window block"))
    for key, kind in budget.payload.items():
        if key not in calls:
            continue
        nbytes = rec["counts"][key[0]][key[1]]["bytes"]
        limit = _payload_limit(kind, rec)
        if nbytes > limit:
            findings.append(Finding(
                rule="IR002", path=target, line=0,
                message=f"{key[1]} over {key[0]} carries {nbytes} bytes > the "
                        f"{limit}-byte {kind} budget ({rec['qpad']} padded "
                        f"pairs x 4 B{' + a row each' if kind != 'counts' else ''}) "
                        f"— bitmap words are crossing ranks"))
    if budget.reduce_axis is not None:
        want = rec["axis_sizes"].get(budget.reduce_axis)
        for (axis, op) in calls:
            if not op.startswith("all_reduce"):
                continue
            widths = rec["widths"].get(axis, {}).get(op, [])
            if widths != [want]:
                findings.append(Finding(
                    rule="IR003", path=target, line=0,
                    message=f"the all-reduce spans {widths} rank(s) but the "
                            f"declared reduce axis {budget.reduce_axis!r} is "
                            f"{want} wide — it mixes shards that own disjoint "
                            f"pair blocks (or misses some that share one)"))
    return findings


def _collect(device: str, targets: Sequence[str], fixtures: Sequence[str]) -> dict:
    """Run ``targets`` (backends, ``"ring_write"``) and ``fixtures`` on
    :data:`RANKS` gloo ranks on ``device`` (``"cuda"``: sharing the card);
    returns each one's ``(record, budget name)`` per rank."""
    from ..launch.mesh import run_ranks
    unknown = [f for f in fixtures if f not in CONTRACT_FIXTURES]
    if unknown:
        raise ValueError(f"unknown contract fixture(s) {unknown}; have: "
                         f"{sorted(CONTRACT_FIXTURES)}")
    per_rank = run_ranks(_rank, RANKS, backend="gloo", device=device,
                         args=(tuple(targets), tuple(fixtures)))
    return {name: [r[name] for r in per_rank] for name in per_rank[0]}


def _findings_of(name: str, per_rank: list) -> List[Finding]:
    findings: List[Finding] = []
    for r, (rec, budget) in enumerate(per_rank):
        target = name if name.startswith("fixture:") else (
            f"streaming:{name}" if name == RING_WRITE else f"backend:{name}")
        findings += contract_findings(f"{target} rank {r}", rec, BUDGETS[budget])
    return findings


def check_all_contracts(device: str = "cuda", fixtures: Sequence[str] = ()
                        ) -> Tuple[List[Finding], dict]:
    """Every backend's expansion and the ring write on gloo ranks, and
    ``fixtures`` in the same start of the ranks: the targets' findings, and
    a summary of what each target counted on rank 0 (with its budget) and
    of the rules each fixture tripped (none: the fixture rotted)."""
    collected = _collect(device, BACKENDS_CHECKED + (RING_WRITE,), fixtures)
    findings: List[Finding] = []
    summary: dict = {"ranks": RANKS, "device": device, "targets": {},
                     "fixtures": {}}
    for name, per_rank in collected.items():
        found = _findings_of(name, per_rank)
        if name.startswith("fixture:"):
            summary["fixtures"][name[len("fixture:"):]] = sorted({f.rule for f in found})
            continue
        findings += found
        rec = per_rank[0][0]
        summary["targets"][name] = {
            "counted_rank0": rec["counts"], "widths_rank0": rec["widths"],
            "declared": {f"{a}/{op}": n
                         for (a, op), n in BUDGETS[name].collectives.items()},
            "versus_reference": BUDGETS[name].versus_reference}
    return findings, summary


def check_contract_fixture(name: str, device: str = "cuda") -> List[Finding]:
    """Run one committed bad program and the real assertions on it; a
    healthy checker returns findings for every fixture."""
    if name not in CONTRACT_FIXTURES:
        raise ValueError(f"unknown contract fixture {name!r}; "
                         f"have: {sorted(CONTRACT_FIXTURES)}")
    per_rank = _collect(device, (), (name,))[f"fixture:{name}"]
    return _findings_of(f"fixture:{name}", per_rank)
