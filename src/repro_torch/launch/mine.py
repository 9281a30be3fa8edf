"""Mining driver, single device:

    PYTHONPATH=src python -m repro_torch.launch.mine --dataset chess \
        --scale 1.0 --min-sup 0.7 --variant v4

Runs on the card unless ``--device cpu`` is given.  ``--mode
closed|maximal`` post-filters the mined lattice (DESIGN.md §9).  Prints the
same ``[mine] ...`` summary line as the reference package's driver.
"""
from __future__ import annotations

import argparse
import time

from ..core import EclatConfig, mine
from ..data import PAPER_DATASETS, generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="chess", choices=list(PAPER_DATASETS))
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--min-sup", type=float, default=0.8)
    ap.add_argument("--mode", default="all",
                    choices=["all", "closed", "maximal"],
                    help="workload mode: all frequent itemsets, or the "
                         "closed/maximal subset (lineage post-filter)")
    ap.add_argument("--variant", default="v4",
                    choices=["v1", "v2", "v3", "v4", "v5", "v6"])
    ap.add_argument("--p", type=int, default=10)
    ap.add_argument("--backend", default="fused", choices=["fused", "ref"],
                    help="engine backend: the CUDA kernels (fused) or the "
                         "plain torch path (ref)")
    ap.add_argument("--diffsets", action="store_true",
                    help="dEclat diffsets (variant v6 only)")
    ap.add_argument("--max-k", type=int, default=None,
                    help="deepest itemset length to mine")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain torch path on the host)")
    args = ap.parse_args(argv)

    txns, spec = generate(args.dataset, scale=args.scale, seed=1)
    cfg = EclatConfig(min_sup=args.min_sup, variant=args.variant, p=args.p,
                      tri_matrix=spec.tri_matrix or None,
                      use_diffsets=args.diffsets, backend=args.backend,
                      mode=args.mode, max_k=args.max_k)
    t0 = time.perf_counter()
    res = mine(txns, spec.n_items, cfg, device=args.device)
    dt = time.perf_counter() - t0
    mode_note = (f" {args.mode}={res.stats['mode_itemsets']}"
                 if args.mode != "all" else "")
    print(f"[mine] {spec.name} x{args.scale} min_sup={args.min_sup} "
          f"{args.variant}: {res.total} itemsets in {dt:.2f}s "
          f"levels={res.counts}{mode_note}")


if __name__ == "__main__":
    main()
