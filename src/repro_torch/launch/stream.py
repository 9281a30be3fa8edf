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

Recovery (DESIGN.md §10): ``--checkpoint-dir`` writes an asynchronous miner
snapshot every ``--checkpoint-every`` slides (rank 0 writes on a mesh, in
the reference's on-disk form); after a crash, rerun with ``--restore``
(same ``--dataset``/``--seed``/``--drift-every``: the stream is
deterministic, so completed slides are skipped and the rest replayed).
``--remesh`` restores under *this* invocation's ``--backend``/``--shard``/
``--grid``/``--ranks`` instead of the checkpoint's recorded config — live
re-meshing, bit-exact either way.  ``--kill-after N`` crashes slide N
mid-append (exit code 3).

Serving (DESIGN.md §11): ``--serve`` puts the stream behind the
asynchronous admission front end — the slides run on a writer thread
(checkpointer and fault injection included) while the main thread fires a
``--serve-queries`` storm at the bounded queue and verifies every answer
against the synchronous path at its stamped ``window_version``.  A writer
that stops beating its heartbeat for ``--stall-timeout`` seconds is
*reported* (exit code 4) instead of hanging the readers.

``--backend auto`` picks the backend from the measured crossover table,
``--block-w`` sets the fused kernels' word tile (K2's, or the chunk K1
and K3 stage) and ``--autotune`` tunes the kernels' tiles on a miss, as in
the reference's command line.
"""
from __future__ import annotations

import argparse
import threading

from ..data import PAPER_DATASETS, stream_spec, transaction_stream
from ..faults import InjectedFault, clear_kill_hook, set_kill_hook
from ..serving import StreamQueryService
from ..streaming import (StreamCheckpointer, StreamConfig, StreamingMiner,
                         peek_config, restore_miner)


def _config(args) -> StreamConfig:
    return StreamConfig(min_sup=args.min_sup, n_blocks=args.n_blocks,
                        block_txns=args.block_txns, backend=args.backend,
                        shard=args.shard, block_w=args.block_w,
                        autotune=args.autotune)


def _mesh_request(args):
    """(backend, shard, grid) of the mesh this run slides on: the flags', or
    with ``--restore`` and no ``--remesh`` the checkpoint's recorded
    config."""
    if args.restore and not args.remesh:
        ck_cfg, _ = peek_config(args.checkpoint_dir)
        return ck_cfg.backend, ck_cfg.shard, None
    return args.backend, args.shard, args.grid


def _arm_kill(args, i: int) -> None:
    if args.kill_after is not None and i == args.kill_after:
        def _die(name):
            if name == "miner:mid_append":
                raise InjectedFault(name)
        set_kill_hook(_die)


def _mesh_note(mesh, backend: str, shard: str) -> str:
    if mesh is None:
        return ""
    names = tuple(mesh.mesh_dim_names)
    if "class" in names:
        return (f", shard=grid over a {mesh.size(0)}x{mesh.size(1)} "
                f"class x data mesh")
    eff_shard = {"tidsharded": "words", "grid": "grid"}.get(backend, shard)
    return f", shard={eff_shard} over {mesh.size(0)} rank(s)"


def run_stream(args, device, mesh, emit) -> int:
    """Slide the stream of ``args`` through a miner on ``device`` (and
    ``mesh``), calling ``emit`` with each output line; returns the exit
    code (0; 3 after an injected crash; 4 after a stalled writer)."""
    spec = stream_spec(args.dataset)
    start = 0
    if args.restore:
        backend, shard, _ = _mesh_request(args)
        miner, start = restore_miner(args.checkpoint_dir, mesh=mesh,
                                     backend=backend, shard=shard,
                                     keep_transactions=False, device=device)
        cfg = miner.config
        emit(f"[stream] restored {args.checkpoint_dir} at slide {start} "
             f"({'re-meshed to ' if args.remesh else ''}backend={backend}, "
             f"shard={shard})")
    else:
        cfg = _config(args)
        backend, shard = args.backend, args.shard
        miner = StreamingMiner(spec.n_items, cfg, mesh=mesh,
                               keep_transactions=False, device=device)
    ck = (StreamCheckpointer(args.checkpoint_dir,
                             every=args.checkpoint_every, keep=args.keep)
          if args.checkpoint_dir else None)
    emit(f"[stream] {spec.name}: window={cfg.n_blocks}x{cfg.block_txns} "
         f"txns, min_sup={cfg.min_sup}, backend={backend}"
         f"{_mesh_note(mesh, backend, shard)}")
    stream = transaction_stream(args.dataset, cfg.block_txns, args.batches,
                                seed=args.seed, drift_every=args.drift_every)
    if args.serve:
        return _serve_mode(args, miner, stream, ck, start, emit)

    service = StreamQueryService(miner)
    try:
        for i, batch in enumerate(stream):
            if i < start:
                continue    # replayed deterministically; already in the state
            _arm_kill(args, i)
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
            if ck is not None:
                ck.maybe_save(miner, i + 1)
    except InjectedFault:
        if ck is not None:
            ck.wait()
        emit(f"[stream] injected crash mid-append at slide "
             f"{args.kill_after}; last durable checkpoint survives — "
             f"recover with --restore")
        return 3
    finally:
        clear_kill_hook()
    if ck is not None:
        ck.wait()
        emit(f"[stream] checkpoints durable in {args.checkpoint_dir}")
    return 0


def _serve_mode(args, miner, stream, ck, start, emit) -> int:
    """--serve: slides on a writer thread, query storm on the calling
    thread.  The writer is the synchronous slide loop (checkpointer and
    kill-hook fault injection included) moved behind ``ServingFrontend``;
    readers never touch the miner, only published snapshots, so a crashed
    or stalled writer degrades to answering from the last complete window —
    detected and reported, never a hang."""
    from ..serving import (AdmissionConfig, ServingFrontend, query_mix,
                           run_storm, verify_storm)
    from ..training import HeartbeatMonitor, WriterStalledError

    acfg = AdmissionConfig(max_queue=args.queue_cap, policy=args.serve_policy,
                           stall_timeout_s=args.stall_timeout or None,
                           keep_versions=max(args.batches + 2, 8))
    frontend = ServingFrontend(miner, acfg)
    writer_fault = []

    def writer():
        try:
            for i, batch in enumerate(stream):
                if i < start:
                    continue
                _arm_kill(args, i)
                res = frontend.ingest(batch)
                emit(f"[stream] slide {i:3d}: window={res.n_txn} txns "
                     f"itemsets={res.total} version={res.version} "
                     f"latency={res.stats['slide_s']*1e3:.1f}ms")
                if ck is not None:
                    ck.maybe_save(miner, i + 1)
        except InjectedFault as e:
            writer_fault.append(e)
        finally:
            clear_kill_hook()
            if ck is not None:
                ck.wait()

    wt = threading.Thread(target=writer, name="miner-writer", daemon=True)
    wt.start()
    monitor = (HeartbeatMonitor(frontend.heartbeat, args.stall_timeout,
                                name="miner writer")
               if args.stall_timeout else None)
    queries = query_mix(args.serve_queries, seed=args.seed)
    outcome = run_storm(frontend, queries, n_clients=args.serve_clients)
    stalled = None
    while wt.is_alive():
        if monitor is not None:
            try:
                monitor.assert_alive()
            except WriterStalledError as e:
                stalled = e
                break
        wt.join(timeout=0.1)

    ver = verify_storm(frontend, queries, outcome)
    m = frontend.metrics.summary()
    c = frontend.cache.stats()
    emit(f"[stream] storm: answered {m['n_answered']}/{len(queries)} "
         f"(shed {m['n_shed']}, errors {m['n_errors']}); latency "
         f"p50 {m['latency_ms']['p50']:.2f}ms p99 "
         f"{m['latency_ms']['p99']:.2f}ms; {m['qps']:.0f} qps; cache hit "
         f"rate {c['hit_rate']:.1%} ({c['stale_evicted']} invalidated)")
    emit(f"[stream] verified {ver['verified']} answers bit-identical at "
         f"their window versions (checksum {ver['checksum']}); final "
         f"window_version={frontend.window_version}")
    frontend.stop()
    if stalled is not None:
        emit(f"[stream] STALL DETECTED: {stalled} — readers kept answering "
             f"from window_version={frontend.window_version}")
        return 4
    if writer_fault:
        emit(f"[stream] injected crash mid-append at slide "
             f"{args.kill_after}; storm kept answering from the last "
             f"published window — recover with --restore")
        return 3
    if outcome["errors"]:
        raise RuntimeError(f"[stream] query errors: {outcome['errors']}")
    if ck is not None:
        emit(f"[stream] checkpoints durable in {args.checkpoint_dir}")
    return 0


def _stream_rank(device, args):
    """One rank of ``--ranks``: the mesh, then the stream; returns the
    rank's lines and exit code."""
    from .mesh import mesh_for_mining
    mesh = mesh_for_mining(*_mesh_request(args))
    lines: list = []
    code = run_stream(args, device, mesh, lines.append)
    return lines, code


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
                    choices=["fused", "ref", "sharded", "tidsharded", "grid",
                             "auto"],
                    help="engine backend: the CUDA kernels (fused), the "
                         "plain torch path (ref), a mesh backend (needs "
                         "--ranks), or auto (the measured crossover table "
                         "BENCH_torch_kerneltune.json, falling back to fused)")
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
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="write an asynchronous miner snapshot (MinerState, "
                         "DESIGN.md §10) every --checkpoint-every slides")
    ap.add_argument("--checkpoint-every", type=int, default=1, metavar="N",
                    help="checkpoint cadence in slides (with --checkpoint-dir)")
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoints retained by GC (with --checkpoint-dir)")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the newest checkpoint in "
                         "--checkpoint-dir: completed slides are skipped and "
                         "the deterministic stream replayed from there; the "
                         "checkpoint's recorded backend/shard/window config "
                         "is reused unless --remesh is given")
    ap.add_argument("--remesh", action="store_true",
                    help="with --restore: re-place the checkpointed state "
                         "under THIS invocation's --backend/--shard/--grid "
                         "and --ranks (live re-meshing) instead of the "
                         "recorded config")
    ap.add_argument("--kill-after", type=int, default=None, metavar="N",
                    help="fault injection: crash mid-append during slide N "
                         "and exit with code 3; recover with --restore")
    ap.add_argument("--serve", action="store_true",
                    help="run the slides on a writer thread behind the "
                         "asynchronous admission front end and storm it "
                         "with queries (DESIGN.md §11)")
    ap.add_argument("--serve-queries", type=int, default=120, metavar="N",
                    help="with --serve: query storm size")
    ap.add_argument("--serve-clients", type=int, default=4, metavar="N",
                    help="with --serve: concurrent client threads")
    ap.add_argument("--serve-policy", default="block",
                    choices=["block", "shed"],
                    help="with --serve: full-queue backpressure policy")
    ap.add_argument("--queue-cap", type=int, default=256, metavar="N",
                    help="with --serve: bounded admission queue capacity")
    ap.add_argument("--stall-timeout", type=float, default=5.0, metavar="S",
                    help="with --serve: writer heartbeat deadline (0 "
                         "disables); a stalled writer is reported, readers "
                         "keep answering from the last published window")
    ap.add_argument("--block-w", type=int, default=None, metavar="WORDS",
                    help="the fused kernels' word tile: K2's, or the "
                         "chunk K1/K3 stage (default: the autotune table, "
                         "else the kernel's rule)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune on a miss: measure a kernel shape class's "
                         "tiles before its first launch")
    args = ap.parse_args(argv)
    if args.restore and not args.checkpoint_dir:
        ap.error("--restore requires --checkpoint-dir")
    if args.ranks is not None:
        from .mesh import run_ranks
        if args.device not in (None, "cuda", "cpu"):
            ap.error(f"--ranks places rank r on cuda:r % count, or on the cpu: "
                     f"--device must be cuda or cpu, not {args.device!r}")
        per_rank = run_ranks(_stream_rank, args.ranks, backend=args.dist_backend,
                             device=args.device or "cuda", args=(args,))
        lines, code = per_rank[0]
        print("\n".join(lines))
    else:
        if args.grid is not None:
            ap.error("--grid needs a mesh: pass --ranks")
        code = run_stream(args, args.device, None, print)
    if code:
        raise SystemExit(code)


if __name__ == "__main__":
    main()
