"""Micro-batch transaction streams for the sliding-window miner.

A stream is the paper's Table-2 data arriving continuously: fixed-size
micro-batches drawn from the same generator family as the batch dataset.
``drift_every`` re-seeds the generator's pattern pool every N batches, so the
frequent-pattern population shifts mid-stream — the scenario where classes
enter and leave the active set and the incremental miner's crossing
bookkeeping (DESIGN.md §5) actually fires.

Deterministic in (name, batch_txns, seed, drift_every): batch ``i`` of a
stream is a pure function of those, and the generators are seed-identical to
the reference package's, so both packages replay the identical stream.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

from .synthetic import PAPER_DATASETS, DatasetSpec, materialize

__all__ = ["transaction_stream", "stream_spec"]


def stream_spec(name: str) -> DatasetSpec:
    """The dataset spec a stream draws from (item universe, density family)."""
    return PAPER_DATASETS[name]


def transaction_stream(
    name: str,
    batch_txns: int,
    n_batches: int,
    seed: int = 0,
    drift_every: Optional[int] = None,
) -> Iterator[List[List[int]]]:
    """Yield ``n_batches`` micro-batches of ``batch_txns`` transactions.

    Batches inside one drift segment are consecutive chunks of a single
    generator draw, so they share the same pattern pool (a stationary
    regime).  With ``drift_every=k`` the pool is re-seeded every k batches:
    quest patterns / attribute skews / click popularity all shift, changing
    which items are frequent.
    """
    spec = PAPER_DATASETS[name]
    seg_len = drift_every if drift_every else n_batches
    emitted = 0
    segment = 0
    while emitted < n_batches:
        take = min(seg_len, n_batches - emitted)
        txns = materialize(spec, take * batch_txns, seed=seed + 7919 * segment)
        for b in range(take):
            yield txns[b * batch_txns: (b + 1) * batch_txns]
        emitted += take
        segment += 1
