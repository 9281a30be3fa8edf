"""repro_torch.streaming — sliding-window incremental Eclat over micro-batches.

The window is a device-resident ring of packed word-blocks (``WindowRing``;
on a word-sharded mesh each rank holds its word slice and a push writes only
its own words, with no collective); ``StreamingMiner`` maintains per-item
supports and the co-occurrence count matrix incrementally (block deltas
through the ``trimatrix`` kernel) and re-expands only the active equivalence
classes through the ``core.engine`` backend interface.  Windowed results are
bit-exact with batch ``core.eclat.mine`` over the same window contents
(DESIGN.md §5).  The serializable state and its checkpointer wait for
ROADMAP item 9.
"""
from .miner import StreamConfig, StreamingMiner, WindowResult
from .window import WindowRing

__all__ = ["StreamConfig", "StreamingMiner", "WindowResult", "WindowRing"]
