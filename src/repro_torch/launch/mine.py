"""Mining driver, on one device or on a mesh of ranks:

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset chess \
        --scale 1.0 --min-sup 0.7 --variant v4
    PYTHONPATH=src python -m repro_torch.launch.mine --dataset chess \
        --scale 1.0 --min-sup 0.7 --ranks 4 --dist-backend gloo --shard words

Runs on the card unless ``--device cpu`` is given.  ``--ranks N`` starts N
ranks (``launch.mesh.run_ranks``) joined by ``--dist-backend``: ``nccl``
for ranks on distinct cards, ``gloo`` for ranks on the host or several
ranks sharing one card (NCCL refuses two ranks on one card).
``--backend``/``--shard``/``--grid`` pick the mesh backend as in the
reference's driver; every rank mines, and rank 0's summary is printed.
``--mode closed|maximal`` post-filters the mined lattice (DESIGN.md §9).
``--checkpoint-dir DIR`` writes a mining checkpoint per level (the
reference's ``mining_ckpt_k*.npz``; on a mesh rank 0 writes), and
``--restore`` resumes the deepest one in ``DIR`` instead of mining, under
this invocation's ``--backend``/``--shard``/``--grid``/``--ranks``, which
may differ from the original run's (DESIGN.md §10).  ``--fimi FILE.dat``
mines a FIMI-format transaction file instead of a generated dataset.
``--backend auto`` picks the backend from the measured crossover table
(``BENCH_torch_kerneltune.json``), ``--block-w`` sets the word tile of
the fused-intersect kernel an expansion launches (K2's; K1's or K3's staged
chunk without compaction or on the word-sharded backends) and
``--autotune`` tunes the kernels' tiles on a miss (``kernels.autotune``).
``--top-k K`` replaces the threshold with the adaptive min_sup ladder
(``core.top_k_mine``) and prints the ladder and the first 10 itemsets;
``--min-conf C`` > 0 also prints the number of association rules at
confidence >= C (``core.generate_rules``) after a mine or a restore.
Prints the same ``[mine] ...`` lines as the reference package's driver.
"""
from __future__ import annotations

import argparse
import os
import time

from ..core import EclatConfig, generate_rules, mine, resume_mine, top_k_mine
from ..data import PAPER_DATASETS, generate, load_fimi


def _resumed(res, dt: float) -> str:
    return (f"[mine] resumed {res.stats['resumed_from']} at level "
            f"{res.stats['resume_k']} ({res.stats['backend']}): "
            f"{res.total} itemsets in {dt:.2f}s levels={res.counts}")


def _summary(name: str, args, res, dt: float, mesh) -> str:
    grid_note = (f" grid={mesh.size(0)}x{mesh.size(1)}"
                 if mesh is not None and "class" in mesh.mesh_dim_names else "")
    mode_note = (f" {args.mode}={res.stats['mode_itemsets']}"
                 if args.mode != "all" else "")
    scale_note = "" if args.fimi else f" x{args.scale}"
    return (f"[mine] {name}{scale_note} min_sup={args.min_sup} "
            f"{args.variant}: {res.total} itemsets in {dt:.2f}s "
            f"levels={res.counts}{grid_note}{mode_note}")


def _config(args, tri_matrix) -> EclatConfig:
    return EclatConfig(min_sup=args.min_sup, variant=args.variant, p=args.p,
                       tri_matrix=tri_matrix,
                       use_diffsets=args.diffsets, backend=args.backend,
                       shard=args.shard, mode=args.mode, max_k=args.max_k,
                       block_w=args.block_w, autotune=args.autotune,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every_level=args.checkpoint_dir is not None)


def _database(args):
    """``(transactions, n_items, name, tri_matrix)``: the ``--fimi`` file
    (named by its basename; ``tri_matrix`` left to the item-range rule) or
    the generated ``--dataset``."""
    if args.fimi:
        txns, n_items = load_fimi(args.fimi)
        return txns, n_items, os.path.basename(args.fimi), None
    txns, spec = generate(args.dataset, scale=args.scale, seed=1)
    return txns, spec.n_items, spec.name, spec.tri_matrix or None


def _rules(args, res) -> list:
    """The rules line of ``--min-conf`` (none when it is 0)."""
    if args.min_conf <= 0:
        return []
    rules = generate_rules(res.support_map(), args.min_conf)
    return [f"[mine] {len(rules)} rules at conf>={args.min_conf}"]


def _top_k(args, name, top, dt: float) -> list:
    """The ``--top-k`` lines: the ladder, then the first 10 itemsets."""
    scale_note = "" if args.fimi else f" x{args.scale}"
    lines = [f"[mine] {name}{scale_note} top-{args.top_k} "
             f"({len(top.itemsets)} returned) in {dt:.2f}s: ladder "
             f"{[r['abs_min_sup'] for r in top.ladder]} -> "
             f"abs_min_sup={top.abs_min_sup}"]
    lines += [f"[mine]   {itemset} sup={sup}"
              for itemset, sup in top.itemsets[:min(args.top_k, 10)]]
    return lines


def _run(args, device, mesh) -> str:
    """Mine (or, with ``--restore``, resume; with ``--top-k``, climb the
    ladder) on ``device`` and ``mesh``; returns the ``[mine]`` lines."""
    t0 = time.perf_counter()
    if args.restore:
        cfg = EclatConfig(min_sup=args.min_sup, variant=args.variant,
                          p=args.p, backend=args.backend, shard=args.shard,
                          mode=args.mode, block_w=args.block_w,
                          autotune=args.autotune,
                          checkpoint_dir=args.checkpoint_dir)
        res = resume_mine(cfg, device=device, mesh=mesh)
        lines = [_resumed(res, time.perf_counter() - t0)] + _rules(args, res)
        return "\n".join(lines)
    txns, n_items, name, tri_matrix = _database(args)
    cfg = _config(args, tri_matrix)
    t0 = time.perf_counter()
    if args.top_k is not None:
        top = top_k_mine(txns, n_items, args.top_k, config=cfg, device=device,
                         mesh=mesh)
        return "\n".join(_top_k(args, name, top, time.perf_counter() - t0))
    res = mine(txns, n_items, cfg, device=device, mesh=mesh)
    lines = [_summary(name, args, res, time.perf_counter() - t0, mesh)]
    return "\n".join(lines + _rules(args, res))


def _mine_rank(device, args) -> str:
    """One rank of ``--ranks``: the mesh from the flags, then the run."""
    from .mesh import mesh_for_mining
    return _run(args, device, mesh_for_mining(args.backend, args.shard,
                                              args.grid))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="chess", choices=list(PAPER_DATASETS))
    ap.add_argument("--fimi", default=None, metavar="FILE.dat",
                    help="mine a FIMI-format transaction file instead of "
                         "--dataset (one txn per line, whitespace-separated "
                         "integer item ids)")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--min-sup", type=float, default=0.8)
    ap.add_argument("--mode", default="all",
                    choices=["all", "closed", "maximal"],
                    help="workload mode: all frequent itemsets, or the "
                         "closed/maximal subset (lineage post-filter)")
    ap.add_argument("--top-k", type=int, default=None, metavar="K",
                    help="mine the K highest-support itemsets via the "
                         "adaptive min_sup ladder (--min-sup is ignored)")
    ap.add_argument("--variant", default="v4",
                    choices=["v1", "v2", "v3", "v4", "v5", "v6"])
    ap.add_argument("--p", type=int, default=10)
    ap.add_argument("--backend", default="fused",
                    choices=["fused", "ref", "sharded", "tidsharded", "grid",
                             "auto"],
                    help="engine backend: the CUDA kernels (fused), the "
                         "plain torch path (ref), a mesh backend (needs "
                         "--ranks), or auto (the measured crossover table "
                         "BENCH_torch_kerneltune.json, falling back to fused)")
    ap.add_argument("--shard", default="pairs",
                    choices=["pairs", "words", "grid"],
                    help="mesh split under --ranks: candidate pairs, the "
                         "frontier's word axis, or both on a 2D grid "
                         "(DESIGN.md §7-8)")
    ap.add_argument("--grid", default=None, metavar="RxC",
                    help="class x data mesh shape for --shard grid, e.g. 2x2 "
                         "(default: auto-factorize the ranks)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="start this many ranks and mine on a mesh of them")
    ap.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend of --ranks: nccl (one card "
                         "per rank) or gloo (host ranks, or ranks sharing a "
                         "card)")
    ap.add_argument("--diffsets", action="store_true",
                    help="dEclat diffsets (variant v6 only)")
    ap.add_argument("--max-k", type=int, default=None,
                    help="deepest itemset length to mine")
    ap.add_argument("--block-w", type=int, default=None, metavar="WORDS",
                    help="the fused kernels' word tile: K2's, or the "
                         "chunk K1/K3 stage (default: the autotune table, "
                         "else the kernel's rule)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune on a miss: measure a kernel shape class's "
                         "tiles before its first launch (winners persist in "
                         "the autotune cache)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain torch path on the host)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write a mining checkpoint per level into this "
                         "directory (with --restore: read them)")
    ap.add_argument("--restore", action="store_true",
                    help="resume the deepest mining checkpoint in "
                         "--checkpoint-dir instead of mining from scratch; "
                         "--backend/--shard/--grid/--ranks select the "
                         "*restoring* mesh, which may differ from the "
                         "original run's (live re-meshing, DESIGN.md §10)")
    ap.add_argument("--min-conf", type=float, default=0.0,
                    help="if >0, also generate association rules")
    args = ap.parse_args(argv)
    if args.restore and not args.checkpoint_dir:
        ap.error("--restore requires --checkpoint-dir")

    if args.ranks is not None:
        from .mesh import run_ranks
        if args.device not in (None, "cuda", "cpu"):
            ap.error(f"--ranks places rank r on cuda:r % count, or on the cpu: "
                     f"--device must be cuda or cpu, not {args.device!r}")
        lines = run_ranks(_mine_rank, args.ranks, backend=args.dist_backend,
                          device=args.device or "cuda", args=(args,))
        print(lines[0])
        return
    if args.grid is not None:
        ap.error("--grid needs a mesh: pass --ranks")
    print(_run(args, args.device, None))


if __name__ == "__main__":
    main()
