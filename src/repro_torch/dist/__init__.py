"""repro_torch.dist — the reference's ``dist`` package on
``torch.distributed``.

sharding     word-axis sharding of a frontier, ``mesh_descriptor``, the
             mesh's lead rank; the model's placement rules (``param_spec``,
             ``spec_tree``, ``batch_spec``) and ``shard_tree`` /
             ``gather_tree``
collectives  the one place that calls ``torch.distributed``: all-reduce,
             all-gather, reduce-scatter, all-to-all and broadcast over a
             named mesh axis, with per-axis counters, and the
             autograd-aware operations of tensor and expert parallelism
"""
from .collectives import (all_gather, all_reduce, broadcast,
                          broadcast_from_lead, collective_counts,
                          reset_collective_counts)
from .sharding import (axis_index, axis_size, is_lead_rank, mesh_descriptor,
                       padded_word_count, shard_words)

__all__ = ["all_gather", "all_reduce", "broadcast", "broadcast_from_lead",
           "collective_counts", "reset_collective_counts", "axis_index",
           "axis_size", "is_lead_rank", "mesh_descriptor",
           "padded_word_count", "shard_words"]
