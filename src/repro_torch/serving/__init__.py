"""repro_torch.serving — the serving paths.

* ``ServingEngine`` (``engine``) — batched LM serving: prefill + decode with
  greedy-LPT request packing, instrumented by ``ServingMetrics``.
* ``StreamQueryService`` (``stream_query``) — synchronous queries (top-k
  itemsets, support, rules, greedy-LPT packed batches) over the
  sliding-window miner, on immutable version-stamped ``WindowSnapshot``s
  and the version-keyed ``VersionedCache``.

The reference's batched FIM admission front end and its load generator wait
for ROADMAP item 8.
"""
from .cache import VersionedCache
from .engine import Request, ServingEngine, pack_requests
from .metrics import ServingMetrics, percentiles
from .snapshot import (WindowSnapshot, answer_query, answer_rules,
                       answer_support, answer_topk)
from .stream_query import (ItemsetQuery, StreamQueryService, pack_queries,
                           query_work)

__all__ = ["Request", "ServingEngine", "pack_requests", "ServingMetrics",
           "percentiles", "ItemsetQuery", "StreamQueryService",
           "pack_queries", "query_work", "VersionedCache", "WindowSnapshot",
           "answer_query", "answer_rules", "answer_support", "answer_topk"]
