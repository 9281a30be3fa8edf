"""repro_torch.serving — the serving paths.

* ``ServingEngine`` (``engine``) — batched LM serving: prefill + decode with
  greedy-LPT request packing, instrumented by ``ServingMetrics``.
* ``StreamQueryService`` (``stream_query``) — synchronous queries (top-k
  itemsets, support, rules, greedy-LPT packed batches) over the
  sliding-window miner, on immutable version-stamped ``WindowSnapshot``s
  and the version-keyed ``VersionedCache``.
* ``ServingFrontend`` (``admission``) — asynchronous batched admission over
  the streaming miner: bounded queue with shed-or-block backpressure,
  deadline/size drain triggers, continuous greedy-LPT packing, answers
  bit-identical to the synchronous path at the same ``window_version``, a
  writer heartbeat, restore from a checkpoint.
* ``loadgen`` — seeded query storms and the answer-checksum verification
  oracle of the ``--serve`` drivers.
"""
from .admission import AdmissionConfig, QueryShed, ServingFrontend, Ticket
from .cache import VersionedCache
from .engine import Request, ServingEngine, pack_requests
from .loadgen import answer_checksum, query_mix, run_storm, verify_storm
from .metrics import ServingMetrics, percentiles
from .snapshot import (WindowSnapshot, answer_query, answer_rules,
                       answer_support, answer_topk)
from .stream_query import (ItemsetQuery, StreamQueryService, pack_queries,
                           query_work)

__all__ = ["Request", "ServingEngine", "pack_requests", "ServingMetrics",
           "percentiles", "ItemsetQuery", "StreamQueryService",
           "pack_queries", "query_work", "VersionedCache", "WindowSnapshot",
           "answer_query", "answer_rules", "answer_support", "answer_topk",
           "AdmissionConfig", "QueryShed", "ServingFrontend", "Ticket",
           "answer_checksum", "query_mix", "run_storm", "verify_storm"]
