"""Quickstart: mine frequent itemsets with RDD-Eclat on a paper dataset.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--dataset chess]
        [--min-sup 0.8] [--variant v4] [--compare-apriori] [--rules]
        [--device cpu]

The reference's ``examples/quickstart.py`` on the port: the same flags and
lines, plus ``--device`` (default: the card).  ``--compare-apriori`` races
the Spark-Apriori baseline against the mine and requires the same itemsets.
"""
import argparse
import time

from ..core import EclatConfig, apriori_mine, generate_rules, mine
from ..data import PAPER_DATASETS, generate


def _synchronize(device) -> None:
    import torch
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="chess", choices=list(PAPER_DATASETS))
    ap.add_argument("--min-sup", type=float, default=0.8)
    ap.add_argument("--variant", default="v4",
                    choices=["v1", "v2", "v3", "v4", "v5", "v6"])
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--compare-apriori", action="store_true")
    ap.add_argument("--rules", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "torch paths on the host)")
    args = ap.parse_args(argv)

    txns, spec = generate(args.dataset, scale=args.scale, seed=1)
    print(f"dataset {spec.name}: {len(txns)} txns, {spec.n_items} items, "
          f"avg width {sum(map(len, txns))/len(txns):.1f}")

    cfg = EclatConfig(min_sup=args.min_sup, variant=args.variant, p=10,
                      tri_matrix=spec.tri_matrix or None)
    t0 = time.perf_counter()
    res = mine(txns, spec.n_items, cfg, device=args.device)
    _synchronize(args.device)
    dt = time.perf_counter() - t0
    print(f"RDD-Eclat[{args.variant}] min_sup={args.min_sup}: "
          f"{res.total} frequent itemsets in {dt:.2f}s "
          f"(per-level: {res.counts})")
    print(f"  intersections: {res.stats['n_intersections']}, "
          f"filter reduction: {res.stats.get('filter_reduction', 0):.1%}, "
          f"partition padding efficiency: "
          f"{res.stats.get('partition_balance', {}).get('padding_efficiency', 1):.3f}")

    top = sorted(res.itemsets(), key=lambda kv: (-len(kv[0]), -kv[1]))[:5]
    for iset, sup in top:
        print(f"  {iset} support={sup} ({sup/len(txns):.1%})")

    if args.compare_apriori:
        t0 = time.perf_counter()
        ap_res = apriori_mine(txns, spec.n_items, args.min_sup,
                              device=args.device)
        dt_ap = time.perf_counter() - t0
        if ap_res.support_map != res.support_map():
            raise SystemExit("Spark-Apriori baseline and RDD-Eclat disagree")
        print(f"Spark-Apriori baseline: {dt_ap:.2f}s "
              f"-> Eclat speedup {dt_ap/dt:.1f}x (results identical)")

    if args.rules:
        rules = generate_rules(res.support_map(), min_conf=0.9)
        print(f"{len(rules)} association rules at conf>=0.9; strongest:")
        for ante, cons, conf, sup in sorted(rules, key=lambda r: -r[2])[:5]:
            print(f"  {ante} => {cons}  conf={conf:.3f} sup={sup}")


if __name__ == "__main__":
    main()
