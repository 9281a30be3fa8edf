"""repro_torch.data — the paper's Table-2 dataset generators (numpy), the
micro-batch streams drawn from them, and FIMI-format transaction files."""
from .fimi import fimi_universe, load_fimi, parse_fimi, write_fimi
from .stream import stream_spec, transaction_stream
from .synthetic import (DatasetSpec, PAPER_DATASETS, attribute_table,
                        clickstream, generate, materialize, quest)

__all__ = ["DatasetSpec", "PAPER_DATASETS", "attribute_table", "clickstream",
           "generate", "materialize", "quest", "stream_spec",
           "transaction_stream", "parse_fimi", "load_fimi", "write_fimi",
           "fimi_universe"]
