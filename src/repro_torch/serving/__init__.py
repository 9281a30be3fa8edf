"""repro_torch.serving — batched LM serving (``ServingEngine``: prefill +
decode with greedy-LPT request packing) and its instrumentation
(``ServingMetrics``).  The reference's FIM query front end (admission,
snapshots, caches, load generator) waits for ROADMAP item 8."""
from .engine import Request, ServingEngine, pack_requests
from .metrics import ServingMetrics, percentiles

__all__ = ["Request", "ServingEngine", "pack_requests", "ServingMetrics",
           "percentiles"]
