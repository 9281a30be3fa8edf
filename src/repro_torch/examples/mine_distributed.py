"""Distributed mining with fault tolerance: shard the equivalence classes
over a mesh of ranks, kill a partition, recover it from lineage.

    PYTHONPATH=src python -m repro_torch.examples.mine_distributed \
        [--ranks 4] [--dist-backend gloo] [--device cpu]

The reference's ``examples/mine_distributed.py`` on the port.  Where the
reference re-executes itself with ``XLA_FLAGS`` to see ``--devices`` host
devices, this starts ``--ranks`` processes (``launch.mesh.run_ranks``)
joined by ``--dist-backend``: ``nccl`` for ranks on distinct cards,
``gloo`` for ranks on the host or several ranks sharing one card.  Every
rank mines with the ``sharded`` backend; partition 3 is then recomputed
from lineage (``core.lineage.recover_partition``) on ``--device`` and held
bit for bit against the mined result.
"""
import argparse


def _mine_rank(device, args):
    """One rank: the ``sharded`` mine over a 1D mesh of every rank."""
    from ..core import EclatConfig, mine, support_checksum
    from ..data import generate
    from ..launch.mesh import make_data_mesh
    txns, spec = generate(args.dataset, scale=0.2, seed=1)
    cfg = EclatConfig(min_sup=args.min_sup, variant="v5",
                      p=2 * args.ranks, backend="sharded")
    res = mine(txns, spec.n_items, cfg, device=device, mesh=make_data_mesh())
    return {"support_map": res.support_map(), "total": res.total,
            "checksum": support_checksum(res.support_map()),
            "balance": res.stats["device_balance"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--dist-backend", default="gloo", choices=["nccl", "gloo"],
                    help="process-group backend: nccl (one card per rank) "
                         "or gloo (host ranks, or ranks sharing a card)")
    ap.add_argument("--dataset", default="mushroom")
    ap.add_argument("--min-sup", type=float, default=0.3)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: where the ranks and the "
                         "recovery run")
    args = ap.parse_args(argv)

    from ..core import (EclatConfig, assign_partitions, build_vertical,
                        recover_partition)
    from ..data import generate
    from ..launch.mesh import run_ranks

    per_rank = run_ranks(_mine_rank, args.ranks, backend=args.dist_backend,
                         device=args.device or "cuda", args=(args,))
    if len({r["checksum"] for r in per_rank}) != 1:
        raise SystemExit("the ranks mined different results")
    res = per_rank[0]
    print(f"mined {res['total']} itemsets on {args.ranks} ranks; "
          f"device balance: {res['balance']}")

    # --- simulate losing a partition and recover it from lineage ----------
    txns, spec = generate(args.dataset, scale=0.2, seed=1)
    cfg = EclatConfig(min_sup=args.min_sup, variant="v5", p=2 * args.ranks)
    abs_ms = cfg.resolve_min_sup(len(txns))
    db = build_vertical(txns, spec.n_items, abs_ms)
    table = assign_partitions(db.n_items - 1, "reverse_hash", 2 * args.ranks)
    lost = 3
    recovered = recover_partition(db, table, pid=lost, abs_min_sup=abs_ms,
                                  device=args.device)
    # verify against the full result
    rank_of = {int(it): r for r, it in enumerate(db.items)}
    expect = {k: v for k, v in res["support_map"].items()
              if len(k) >= 2 and table[min(rank_of[i] for i in k)] == lost}
    if recovered != expect:
        raise SystemExit(f"partition {lost}: the recovered itemsets differ "
                         f"from the mined ones")
    print(f"partition {lost} lost -> {len(recovered)} itemsets recovered "
          f"bit-exactly from lineage (vertical DB + partition table)")


if __name__ == "__main__":
    main()
