"""Serving driver: batched LM requests, or the FIM query front end.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
        --arch gemma3-4b --requests 8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --workload fim \
        [--checkpoint-dir DIR --restore] [--device cpu]

``lm``: the reduced config of ``--arch`` (``configs.reduced``) with random
weights from a seeded ``torch.Generator``, as the reference driver has it.
``fim``: the asynchronous itemset-query front end (``ServingFrontend``,
DESIGN.md §11) over a sliding window that a writer thread slides
``--slides`` times under a ``--queries`` storm from ``--clients`` threads;
every answer is verified against the synchronous path at its stamped
window version.  With ``--restore`` the front end is rebuilt from a
``launch.stream`` checkpoint and answers the storm from the restored
window.  The default device is CUDA, and with no card it raises rather than
fall back.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch


def serve_lm(args) -> None:
    from ..configs import get_config
    from ..configs.reduced import reduced_config
    from ..device import resolve_device
    from ..models import Model, init_params
    from ..serving import Request, ServingEngine

    device = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch))
    model = Model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    engine = ServingEngine(model, params, s_max=96)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(4, 48))).astype(np.int32),
        max_new_tokens=args.max_new) for i in range(args.requests)]
    t0 = time.perf_counter()
    results, stats = engine.serve(reqs, n_batches=args.batches)
    lat = stats["latency"]
    print(f"[serve] {cfg.name} on {device}: {len(results)} requests in "
          f"{time.perf_counter()-t0:.1f}s; pack eff "
          f"{stats['padding_efficiency']:.3f}; answer p50 "
          f"{lat['answer_ms']['p50']:.0f}ms p99 {lat['answer_ms']['p99']:.0f}ms")


def serve_fim(args) -> None:
    from ..data import stream_spec, transaction_stream
    from ..serving import (AdmissionConfig, ServingFrontend, query_mix,
                           run_storm, verify_storm)
    from ..streaming import StreamConfig, StreamingMiner
    from ..training import HeartbeatMonitor, WriterStalledError

    acfg = AdmissionConfig(
        max_queue=args.queue_cap, policy=args.policy,
        max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3,
        n_slots=args.slots, stall_timeout_s=args.stall_timeout or None,
        keep_versions=max(args.slides + 2, 8))

    if args.restore:
        if not args.checkpoint_dir:
            raise SystemExit("--restore requires --checkpoint-dir")
        frontend, completed = ServingFrontend.from_checkpoint(
            args.checkpoint_dir, config=acfg, device=args.device)
        print(f"[serve] restored {args.checkpoint_dir}: {completed} completed "
              f"slides, window_version={frontend.window_version}, "
              f"{len(frontend.snapshot.itemsets)} itemsets — serving from "
              f"the restored window")
        writer = None
    else:
        spec = stream_spec(args.dataset)
        cfg = StreamConfig(min_sup=args.min_sup, n_blocks=args.n_blocks,
                           block_txns=args.block_txns, backend=args.backend)
        miner = StreamingMiner(spec.n_items, cfg, keep_transactions=False,
                               device=args.device)
        frontend = ServingFrontend(miner, acfg)
        batches = list(transaction_stream(args.dataset, cfg.block_txns,
                                          args.slides, seed=args.seed))
        frontend.ingest(batches[0])     # serve a non-empty first window

        def slide():
            for b in batches[1:]:
                frontend.ingest(b)
                time.sleep(args.slide_gap_ms / 1e3)
        writer = threading.Thread(target=slide, name="miner-writer",
                                  daemon=True)
        writer.start()
        print(f"[serve] {spec.name}: window={cfg.n_blocks}x{cfg.block_txns} "
              f"txns, min_sup={cfg.min_sup}, {args.slides} slides underneath "
              f"a {args.queries}-query storm ({args.clients} clients, "
              f"policy={args.policy}, queue={args.queue_cap}) on "
              f"{miner.device}")

    queries = query_mix(args.queries, seed=args.seed)
    monitor = (HeartbeatMonitor(frontend.heartbeat, args.stall_timeout,
                                name="miner writer")
               if args.stall_timeout and writer is not None else None)
    outcome = run_storm(frontend, queries, n_clients=args.clients)
    if writer is not None:
        while writer.is_alive():
            if monitor is not None:
                try:
                    monitor.assert_alive()
                except WriterStalledError as e:
                    print(f"[serve] STALL DETECTED: {e}")
                    frontend.stop()
                    raise SystemExit(4)
            writer.join(timeout=0.1)
    ver = verify_storm(frontend, queries, outcome)
    m = frontend.metrics.summary()
    c = frontend.cache.stats()
    print(f"[serve] answered {m['n_answered']}/{len(queries)} "
          f"(shed {m['n_shed']}, errors {m['n_errors']}); "
          f"latency p50 {m['latency_ms']['p50']:.2f}ms "
          f"p99 {m['latency_ms']['p99']:.2f}ms; {m['qps']:.0f} qps; "
          f"mean batch {m['mean_batch']:.1f}")
    print(f"[serve] cache: hit rate {c['hit_rate']:.1%} "
          f"({c['hits']} hits / {c['misses']} misses / {c['stale_evicted']} "
          f"invalidated by slides); final window_version="
          f"{frontend.window_version}")
    print(f"[serve] verified {ver['verified']} answers bit-identical with "
          f"the synchronous path at their window versions "
          f"(checksum {ver['checksum']})")
    frontend.stop()
    if outcome["errors"]:
        raise SystemExit(f"query errors: {outcome['errors']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="lm", choices=["lm", "fim"],
                    help="lm: batched generation; fim: asynchronous "
                         "itemset-query front end under a query storm "
                         "(DESIGN.md §11)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "torch path on the host)")
    # lm workload
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    # fim workload
    ap.add_argument("--dataset", default="T10I4D100K")
    ap.add_argument("--min-sup", type=float, default=0.01)
    ap.add_argument("--n-blocks", type=int, default=4)
    ap.add_argument("--block-txns", type=int, default=256)
    ap.add_argument("--backend", default="fused", choices=["fused", "ref"],
                    help="engine backend of the miner under the front end")
    ap.add_argument("--slides", type=int, default=8,
                    help="window slides the writer performs under the storm")
    ap.add_argument("--slide-gap-ms", type=float, default=5.0,
                    help="writer pause between slides")
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--queue-cap", type=int, default=256,
                    help="bounded admission queue capacity")
    ap.add_argument("--policy", default="block", choices=["block", "shed"],
                    help="full-queue backpressure policy")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="drain trigger: batch size")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="drain trigger: oldest-query deadline")
    ap.add_argument("--slots", type=int, default=4,
                    help="greedy-LPT answer slots per drained batch")
    ap.add_argument("--stall-timeout", type=float, default=5.0,
                    help="writer heartbeat deadline (s); 0 disables")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="with --restore: the launch.stream checkpoint "
                         "directory to serve from")
    ap.add_argument("--restore", action="store_true",
                    help="rebuild the front end from the newest checkpoint "
                         "and answer the storm from the restored window")
    args = ap.parse_args(argv)
    if args.workload == "fim":
        serve_fim(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
