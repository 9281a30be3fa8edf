"""repro_torch.data — the paper's Table-2 dataset generators (numpy) and the
micro-batch streams drawn from them."""
from .stream import stream_spec, transaction_stream
from .synthetic import (DatasetSpec, PAPER_DATASETS, attribute_table,
                        clickstream, generate, materialize, quest)

__all__ = ["DatasetSpec", "PAPER_DATASETS", "attribute_table", "clickstream",
           "generate", "materialize", "quest", "stream_spec",
           "transaction_stream"]
