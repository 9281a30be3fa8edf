"""Live top-k frequent itemsets over a sliding window (Python API tour).

    PYTHONPATH=src python -m repro_torch.examples.stream_topk [--batches 8]
        [--device cpu]

The reference's ``examples/stream_topk.py`` on the port: feeds a T10-style
micro-batch stream into the incremental miner, queries the current window
through the serving layer, and cross-checks the last slide against batch
``mine()`` to show the windowed results are bit-exact.  Runs on the card
unless ``--device cpu`` is given.
"""
import argparse

from ..core import EclatConfig, mine
from ..data import stream_spec, transaction_stream
from ..serving import ItemsetQuery, StreamQueryService
from ..streaming import StreamConfig, StreamingMiner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="T10I4D100K")
    ap.add_argument("--min-sup", type=float, default=0.02)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--block-txns", type=int, default=256)
    ap.add_argument("--n-blocks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "torch paths on the host)")
    args = ap.parse_args(argv)

    spec = stream_spec(args.dataset)
    miner = StreamingMiner(
        spec.n_items,
        StreamConfig(min_sup=args.min_sup, n_blocks=args.n_blocks,
                     block_txns=args.block_txns), device=args.device)
    service = StreamQueryService(miner)

    for i, batch in enumerate(transaction_stream(
            args.dataset, args.block_txns, args.batches, seed=3)):
        res = service.ingest(batch)
        top = service.top_k_itemsets(k=3, min_len=2)
        print(f"slide {i}: {res.n_txn} txns in window, {res.total} frequent "
              f"itemsets, top pairs: {top}")

    # heterogeneous query batch, greedy-LPT packed across answer slots
    queries = [ItemsetQuery(qid=0, kind="topk", k=5, min_len=2),
               ItemsetQuery(qid=1, kind="rules", min_conf=0.9, k=5),
               ItemsetQuery(qid=2, kind="topk", k=3, min_len=3)]
    answers, stats = service.answer_batch(queries, n_batches=2)
    print(f"answered {len(answers)} queries "
          f"(packing efficiency {stats['padding_efficiency']:.2f})")
    print(f"  {len(answers[1])} rules at conf>=0.9; strongest: "
          f"{answers[1][0] if answers[1] else None}")

    # the windowed result is bit-exact with batch mining the same window
    batch_res = mine(miner.window_transactions(), spec.n_items,
                     EclatConfig(min_sup=args.min_sup), device=args.device)
    if res.support_map() != batch_res.support_map():
        raise SystemExit("the windowed result differs from batch mine()")
    print(f"parity: windowed == batch mine() over the window "
          f"({batch_res.total} itemsets)")


if __name__ == "__main__":
    main()
