"""Streaming command line: sliding-window mining over a live micro-batch stream.

    PYTHONPATH=src python -m repro_torch.launch.stream --dataset T10I4D100K \
        --min-sup 0.01 --block-txns 512 --n-blocks 8 --batches 12 \
        --top-k 5 --min-conf 0.8 [--drift-every 6] [--backend fused]
    PYTHONPATH=src python -m repro_torch.launch.stream --dataset chess \
        --min-sup 0.7 --ranks 4 --dist-backend gloo --shard words

Each slide prints the re-mine latency, window occupancy, class churn
(equivalence classes entering/leaving the active set), and the live top-k;
``--min-conf`` adds the rule count of the current window.  The lines are the
reference package's ``launch.stream``'s.

Runs on the card unless ``--device cpu`` is given.  ``--ranks N`` starts N
ranks (``launch.mesh.run_ranks``) joined by ``--dist-backend``, each of which
regenerates the deterministic stream and slides its own miner on the mesh
that ``--backend``/``--shard``/``--grid`` pick (the word-sharded modes keep
only the rank's word slice of the ring); rank 0's lines are printed.

Not ported yet, and refused by name: ``--serve*`` (the admission front end,
ROADMAP item 8), ``--checkpoint-dir``/``--restore``/``--remesh``/
``--kill-after`` (checkpoint and recovery, item 9) and
``--block-w``/``--autotune`` (tile selection, item 6).
"""
from __future__ import annotations

import argparse

from ..data import PAPER_DATASETS, stream_spec, transaction_stream
from ..serving import StreamQueryService
from ..streaming import StreamConfig, StreamingMiner

# flag -> the ROADMAP item that will port it; each parses, and any value but
# its default raises NotImplementedError
UNPORTED_FLAGS = {
    "serve": 8, "serve_queries": 8, "serve_clients": 8, "serve_policy": 8,
    "queue_cap": 8, "stall_timeout": 8,
    "checkpoint_dir": 9, "checkpoint_every": 9, "keep": 9, "restore": 9,
    "remesh": 9, "kill_after": 9,
    "block_w": 6, "autotune": 6,
}


def _config(args) -> StreamConfig:
    return StreamConfig(min_sup=args.min_sup, n_blocks=args.n_blocks,
                        block_txns=args.block_txns, backend=args.backend,
                        shard=args.shard)


def _mesh_note(mesh, backend: str, shard: str) -> str:
    if mesh is None:
        return ""
    names = tuple(mesh.mesh_dim_names)
    if "class" in names:
        return (f", shard=grid over a {mesh.size(0)}x{mesh.size(1)} "
                f"class x data mesh")
    eff_shard = {"tidsharded": "words", "grid": "grid"}.get(backend, shard)
    return f", shard={eff_shard} over {mesh.size(0)} rank(s)"


def run_stream(args, device, mesh, emit) -> None:
    """Slide the stream of ``args`` through a miner on ``device`` (and
    ``mesh``), calling ``emit`` with each output line."""
    spec = stream_spec(args.dataset)
    cfg = _config(args)
    miner = StreamingMiner(spec.n_items, cfg, mesh=mesh,
                           keep_transactions=False, device=device)
    service = StreamQueryService(miner)
    emit(f"[stream] {spec.name}: window={cfg.n_blocks}x{cfg.block_txns} "
         f"txns, min_sup={cfg.min_sup}, backend={args.backend}"
         f"{_mesh_note(mesh, args.backend, args.shard)}")
    for i, batch in enumerate(transaction_stream(
            args.dataset, cfg.block_txns, args.batches,
            seed=args.seed, drift_every=args.drift_every)):
        res = service.ingest(batch)
        cls = res.stats["classes"]
        emit(f"[stream] slide {i:3d}: window={res.n_txn} txns "
             f"({res.stats['window']['filled_blocks']}/{cfg.n_blocks} blocks) "
             f"itemsets={res.total} "
             f"classes={cls['n_active']} (+{cls['n_entered']}/-{cls['n_exited']}) "
             f"latency={res.stats['slide_s']*1e3:.1f}ms")
        for iset, sup in service.top_k_itemsets(args.top_k, min_len=2):
            emit(f"[stream]   top {iset} support={sup} ({sup/res.n_txn:.1%})")
        if args.min_conf > 0:
            rules = service.rules(args.min_conf, k=3)
            emit(f"[stream]   {len(service.rules(args.min_conf))} rules at "
                 f"conf>={args.min_conf}; best: "
                 + "; ".join(f"{a}=>{c} conf={cf:.2f}" for a, c, cf, _ in rules))


def _stream_rank(device, args) -> list:
    """One rank of ``--ranks``: the mesh from the flags, then the stream."""
    from .mesh import mesh_for_mining
    mesh = mesh_for_mining(args.backend, args.shard, args.grid)
    lines: list = []
    run_stream(args, device, mesh, lines.append)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="T10I4D100K",
                    choices=list(PAPER_DATASETS))
    ap.add_argument("--min-sup", type=float, default=0.01)
    ap.add_argument("--block-txns", type=int, default=512,
                    help="transactions per micro-batch block (multiple of 32)")
    ap.add_argument("--n-blocks", type=int, default=8,
                    help="window capacity in blocks")
    ap.add_argument("--batches", type=int, default=12,
                    help="how many micro-batches to stream")
    ap.add_argument("--drift-every", type=int, default=None,
                    help="re-seed the pattern pool every N batches")
    ap.add_argument("--backend", default="fused",
                    choices=["fused", "ref", "sharded", "tidsharded", "grid"],
                    help="engine backend: the CUDA kernels (fused), the "
                         "plain torch path (ref), or a mesh backend (needs "
                         "--ranks)")
    ap.add_argument("--shard", default="pairs",
                    choices=["pairs", "words", "grid"],
                    help="mesh split under --ranks: candidate pairs (ring "
                         "replicated), the ring's word axis, or both on a 2D "
                         "class x data grid (DESIGN.md §7-8)")
    ap.add_argument("--grid", default=None, metavar="RxC",
                    help="class x data mesh shape for --shard grid, e.g. 2x2 "
                         "(default: auto-factorize the ranks)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="start this many ranks and slide the stream on a "
                         "mesh of them")
    ap.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend of --ranks: nccl (one card "
                         "per rank) or gloo (host ranks, or ranks sharing a "
                         "card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain torch path on the host)")
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--min-conf", type=float, default=0.0,
                    help="if >0, also report association rules per slide")
    ap.add_argument("--seed", type=int, default=0)
    # the reference command line's flags that are not ported yet (UNPORTED_FLAGS)
    ap.add_argument("--block-w", type=int, default=None, metavar="WORDS")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR")
    ap.add_argument("--checkpoint-every", type=int, default=None, metavar="N")
    ap.add_argument("--keep", type=int, default=None)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--remesh", action="store_true")
    ap.add_argument("--kill-after", type=int, default=None, metavar="N")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--serve-queries", type=int, default=None, metavar="N")
    ap.add_argument("--serve-clients", type=int, default=None, metavar="N")
    ap.add_argument("--serve-policy", default=None, choices=["block", "shed"])
    ap.add_argument("--queue-cap", type=int, default=None, metavar="N")
    ap.add_argument("--stall-timeout", type=float, default=None, metavar="S")
    args = ap.parse_args(argv)

    for dest, item in UNPORTED_FLAGS.items():
        if getattr(args, dest) not in (None, False):
            raise NotImplementedError(
                f"--{dest.replace('_', '-')} is not ported yet (ROADMAP item "
                f"{item})")
    if args.ranks is not None:
        from .mesh import run_ranks
        if args.device not in (None, "cuda", "cpu"):
            ap.error(f"--ranks places rank r on cuda:r % count, or on the cpu: "
                     f"--device must be cuda or cpu, not {args.device!r}")
        lines = run_ranks(_stream_rank, args.ranks, backend=args.dist_backend,
                          device=args.device or "cuda", args=(args,))
        print("\n".join(lines[0]))
        return
    if args.grid is not None:
        ap.error("--grid needs a mesh: pass --ranks")
    run_stream(args, args.device, None, print)


if __name__ == "__main__":
    main()
