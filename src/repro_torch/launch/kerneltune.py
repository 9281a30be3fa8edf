"""Kernel-tune sweep on the card: the tiles of the main path's shape
classes, the ref-vs-fused crossover table behind ``backend="auto"``, and
the mines with the tuned tiles against the default ones.

    PYTHONPATH=src python3 -m repro_torch.launch.kerneltune \
        [--out BENCH_torch_kerneltune.json] [--reps 20]

The counterpart of the tune and crossover sections of the reference's
``benchmarks/kerneltune_bench.py``.  It writes one JSON file:

``shapes``
    ``kernels.autotune.tune_shape`` at each shape class the main path
    launches: K2 (lanes per pair) at chess level 5, T10I4D100K level 3 and
    the two stream rings; K4 (word split) at T10I4D100K's Phase 2, the
    tri-matrix item cap and the two streams' pushes; K1 (window plan, with
    its (Q, W) store, as ``compact=False`` launches it) at chess level 4,
    T10I4D100K level 3 and the two stream rings; K3 (window plan, without
    its store, as the compacting word-sharded mines launch it) at chess
    and T10I4D100K at 4 word shards and the T10I4D100K ring at 4.  Each
    record holds every candidate's device ms, the pick, the cost model's
    pick and the default tile's (the rule's) ms.  The winners go into the
    autotune cache (``REPRO_TORCH_AUTOTUNE_CACHE``).
``crossover``
    The ``ref`` and ``fused`` backends' ``expand`` (host clock around a
    call that ends in its host read) over a Q x W grid, and each cell's
    winner, ``best_single``: the table ``core.engine.DispatchPolicy`` loads.
    ``best_mesh`` is null: several ranks sharing one card measure no mesh
    of cards, and the reference records single-device winners when its own
    mesh sweep cannot run.
``tuned_vs_default``
    ``mine()`` of T10I4D100K 0.01 and chess 0.7 (full scale) with the tuned
    tiles against the default tiles (``lanes=0``, ``split_plan``), walls
    interleaved, the itemsets' checksums required equal.

It needs a card, and records its name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["K2_SHAPES", "K4_SHAPES", "K1_SHAPES", "K3_SHAPES",
           "CROSSOVER_CELLS", "MINES",
           "tune_shapes", "crossover", "tuned_vs_default", "sweep",
           "use_tables", "main"]

# K2 shape classes of the main path: (label, frontier rows P, words W, pairs Q)
K2_SHAPES = [("chess 0.7 level 5", 60038, 100, 393216),
             ("T10I4D100K 0.01 level 3", 852, 3125, 4096),
             ("T10I4D100K stream ring, level 2", 870, 4096, 1024),
             ("chess stream ring, level 2", 75, 128, 768)]
# K4 shape classes: (label, rows N, words W)
K4_SHAPES = [("T10I4D100K Phase 2", 187, 3125),
             ("tri-matrix item cap", 4096, 3125),
             ("T10I4D100K stream push", 870, 256),
             ("chess stream push", 75, 16)]
# K1 shape classes of the non-compacting mines and streams: (label, P, W, Q)
K1_SHAPES = [("chess 0.7 level 4", 65536, 100, 393216),
             ("T10I4D100K 0.01 level 3", 1024, 3125, 4096),
             ("T10I4D100K stream ring, level 2", 870, 4096, 1024),
             ("chess stream ring, level 2", 75, 128, 768)]
# K3 shape classes of the word-sharded mines and streams at 4 word shards:
# (label, P, Ws, Q)
K3_SHAPES = [("chess 0.7 level 4, 4 shards", 65536, 25, 393216),
             ("T10I4D100K 0.01 level 3, 4 shards", 1024, 782, 4096),
             ("T10I4D100K stream ring, 4 shards", 870, 1024, 1024)]
# the crossover grid (Q pairs, W words): the reference's cells, and the two
# mines' largest expansions
CROSSOVER_CELLS = [(256, 32), (1024, 128), (4096, 512), (16384, 128),
                   (16384, 1024), (4096, 3125), (393216, 100)]
# the tuned-vs-default mines: (dataset, min_sup, variant), generate(scale=1, seed=0)
MINES = [("T10I4D100K", 0.01, "v4"), ("chess", 0.7, "v4")]


def tune_shapes(reps: int = 20) -> list:
    """``tune_shape`` at every shape class of :data:`K2_SHAPES`,
    :data:`K4_SHAPES`, :data:`K1_SHAPES` and :data:`K3_SHAPES` (mode 0), on
    the current card; the records, labelled."""
    from ..kernels import autotune as at
    out = []
    for label, p, w, q in K2_SHAPES:
        rec = at.tune_shape("compact", q, w, 0, device="cuda", rows=p, reps=reps)
        out.append({"label": label, **rec})
    for label, n, w in K4_SHAPES:
        rec = at.tune_shape("trimatrix", n, w, 0, device="cuda", reps=reps)
        out.append({"label": label, **rec})
    for kernel, shapes, store in (("pairs", K1_SHAPES, True),
                                  ("partial", K3_SHAPES, False)):
        for label, p, w, q in shapes:
            rec = at.tune_shape(kernel, q, w, 0, device="cuda", rows=p,
                                reps=reps, store=store)
            out.append({"label": label, "store": store, **rec})
    return out


def _expand_ms(engine, q: int, w: int, reps: int) -> float:
    """Median host ms of one ``expand`` of ``q`` random pairs over a
    ``(min(q, 4096), w)`` frontier on the card (a call ends in its host
    read of the mask and supports)."""
    from ..core.engine import MODE_TIDSET
    from ..device import words_from_numpy
    rng = np.random.default_rng(0)
    p = max(min(q, 4096), 2)
    bitmaps = words_from_numpy(rng.integers(0, 2**32, (p, w), dtype=np.uint32), "cuda")
    left = rng.integers(0, p, q).astype(np.int32)
    right = rng.integers(0, p, q).astype(np.int32)
    supl = np.full(q, 32 * w, np.int32)

    def call():
        return engine.expand(bitmaps, left, right, supl, mode=MODE_TIDSET,
                             min_sup=8 * w)
    call()
    call()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def crossover(cells=CROSSOVER_CELLS, reps: int = 10) -> list:
    """The ref-vs-fused table over ``cells``, in the form
    ``DispatchPolicy`` loads."""
    from ..core.engine import make_engine
    rows = []
    for q, w in cells:
        steady = {name: _expand_ms(make_engine(name), q, w, reps)
                  for name in ("ref", "fused")}
        rows.append({"q": int(q), "w": int(w), "steady_ms": steady,
                     "best_single": min(steady, key=steady.get),
                     "best_mesh": None})
    return rows


def use_tables(autotune_cache: str, crossover_table: Optional[str] = None) -> None:
    """Point this process's autotune cache, and the crossover table
    ``backend="auto"`` reads (none with None), at the given files and drop
    the table it has loaded."""
    from ..core.engine import KERNELTUNE_ENV
    from ..kernels import autotune as at
    os.environ[at.CACHE_ENV] = autotune_cache
    if crossover_table is None:
        os.environ.pop(KERNELTUNE_ENV, None)
    else:
        os.environ[KERNELTUNE_ENV] = crossover_table
    at.reset()


def tuned_vs_default(data: dict, tuned_table: str, repeats: int = 3) -> list:
    """``mine()`` of each of :data:`MINES` on the card with the tiles of
    ``tuned_table`` against the default tiles (an empty table), in turns
    (default, tuned, tuned, default, ...); the least wall of each arm, its
    phases, and both checksums, which must agree.  ``data`` maps a dataset
    name to ``(transactions, spec)``."""
    from ..core import EclatConfig, mine, support_checksum
    empty = os.path.join(tempfile.mkdtemp(prefix="kerneltune-"), "default.json")
    tables = {"default": empty, "tuned": tuned_table}
    out = []
    try:
        for name, min_sup, variant in MINES:
            txns, spec = data[name]
            cfg = EclatConfig(min_sup=min_sup, variant=variant)
            best = {arm: None for arm in tables}
            sums = {}
            order = ["default", "tuned", "tuned", "default"] * repeats
            for arm in ["default", "tuned"] + order:     # the first two warm up
                use_tables(tables[arm])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = mine(txns, spec.n_items, cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                sums[arm] = support_checksum(res.support_map())
                if best[arm] is None or wall < best[arm][0]:
                    best[arm] = (wall, dict(res.stats["phase_s"]))
            if sums["default"] != sums["tuned"]:
                raise RuntimeError(
                    f"{name}: the tuned tiles changed the mined itemsets "
                    f"({sums['tuned']} against {sums['default']})")
            out.append({"dataset": name, "min_sup": min_sup, "variant": variant,
                        "checksum": sums["tuned"],
                        "default_wall_s": best["default"][0],
                        "tuned_wall_s": best["tuned"][0],
                        "default_phase_s": best["default"][1],
                        "tuned_phase_s": best["tuned"][1]})
    finally:
        use_tables(tuned_table)
    return out


def sweep(data: dict, table: str, reps: int = 20, repeats: int = 3) -> dict:
    """The whole report, the tuned table written at ``table``."""
    from .kernel_timing import nvidia_smi
    use_tables(table)
    smi = nvidia_smi("name,power.limit")
    name, _, limit = smi.partition(",")
    return {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "power_limit": limit.strip(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "autotune_cache": table,
        "shapes": tune_shapes(reps),
        "crossover": crossover(reps=max(reps // 2, 3)),
        "tuned_vs_default": tuned_vs_default(data, table, repeats),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="BENCH_torch_kerneltune.json")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls per candidate")
    ap.add_argument("--repeats", type=int, default=3,
                    help="turns of the tuned-vs-default mines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kerneltune: no CUDA device is available")
    from ..data import generate
    from ..kernels import autotune as at
    data = {name: generate(name, scale=1.0, seed=0) for name, _, _ in MINES}
    report = sweep(data, at.table_path(), args.reps, args.repeats)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    print(json.dumps({"shapes": [(r["label"], r["tuned"], r["ms"], r["default"],
                                  r["default_ms"]) for r in report["shapes"]],
                      "crossover": [(c["q"], c["w"], c["best_single"])
                                    for c in report["crossover"]],
                      "tuned_vs_default": report["tuned_vs_default"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
