"""repro_torch.streaming — sliding-window incremental Eclat over micro-batches.

The window is a device-resident ring of packed word-blocks (``WindowRing``;
on a word-sharded mesh each rank holds its word slice and a push writes only
its own words, with no collective); ``StreamingMiner`` maintains per-item
supports and the co-occurrence count matrix incrementally (block deltas
through the ``trimatrix`` kernel) and re-expands only the active equivalence
classes through the ``core.engine`` backend interface.  Windowed results are
bit-exact with batch ``core.eclat.mine`` over the same window contents
(DESIGN.md §5).  The miner's state serializes (``MinerState``,
``RingState``; DESIGN.md §10) and ``persist`` checkpoints it in the
reference's on-disk form and restores it under any mesh.
"""
from .miner import MinerState, StreamConfig, StreamingMiner, WindowResult
from .persist import StreamCheckpointer, peek_config, restore_miner
from .window import RingState, WindowRing

__all__ = ["StreamConfig", "StreamingMiner", "WindowResult", "MinerState",
           "WindowRing", "RingState", "StreamCheckpointer", "restore_miner",
           "peek_config"]
