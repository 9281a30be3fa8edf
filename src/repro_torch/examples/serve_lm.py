"""Batched serving example: heterogeneous prompts packed with the paper's
greedy-LPT partitioner, prefill + KV-cached decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma3-4b \
        --requests 12 [--device cpu]

The reference's ``examples/serve_lm.py`` on the port (a reduced config,
128 wide, vocabulary 2,048).  The weights are random from a
``torch.Generator`` seeded 0, so the generated tokens are not the
reference's; the requests, the packing and the lines are.  Runs on the card
unless ``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.reduced import reduced_config
from ..device import resolve_device
from ..models import Model, init_params
from ..serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "torch paths on the host)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch), d_model=128, vocab=2048)
    model = Model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    engine = ServingEngine(model, params, s_max=128,
                           temperature=args.temperature)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(4, 64))).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    total_prompt = sum(r.prompt.shape[0] for r in reqs)

    t0 = time.perf_counter()
    results, pack_stats = engine.serve(reqs, n_batches=args.batches)
    dt = time.perf_counter() - t0
    total_new = sum(len(v) for v in results.values())
    print(f"{args.arch} [{cfg.d_model}d reduced]: served {len(reqs)} requests "
          f"({total_prompt} prompt + {total_new} new tokens) in {dt:.1f}s")
    print(f"greedy-LPT packing efficiency: "
          f"{pack_stats['padding_efficiency']:.3f} over {args.batches} batches")
    for rid in sorted(results)[:3]:
        print(f"  req {rid}: {results[rid][:8].tolist()}...")


if __name__ == "__main__":
    main()
