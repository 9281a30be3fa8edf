"""Serving driver: batched LM requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
        --arch gemma3-4b --requests 8 [--device cpu]

The reduced config of ``--arch`` (``configs.reduced``) with random weights
from a seeded ``torch.Generator``, as the reference driver has it; the
default device is CUDA, and with no card it raises rather than fall back.
The FIM query front end (``--workload fim``) waits for ROADMAP item 8.
"""
from __future__ import annotations

import argparse
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="lm", choices=["lm", "fim"],
                    help="lm: batched generation; fim: the itemset-query "
                         "front end (not ported yet)")
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "torch path on the host)")
    args = ap.parse_args(argv)
    if args.workload == "fim":
        raise NotImplementedError(
            "--workload fim (the itemset-query front end) is not ported to "
            "repro_torch yet: ROADMAP item 8")
    serve_lm(args)


if __name__ == "__main__":
    main()
