"""repro_torch.data — the paper's Table-2 dataset generators (numpy), the
micro-batch streams drawn from them, FIMI-format transaction files and the
LM token pipeline."""
from .fimi import fimi_universe, load_fimi, parse_fimi, write_fimi
from .lm_pipeline import TokenPipeline
from .stream import stream_spec, transaction_stream
from .synthetic import (DatasetSpec, PAPER_DATASETS, attribute_table,
                        clickstream, generate, materialize, quest)

__all__ = ["TokenPipeline", "DatasetSpec", "PAPER_DATASETS", "attribute_table", "clickstream",
           "generate", "materialize", "quest", "stream_spec",
           "transaction_stream", "parse_fimi", "load_fimi", "write_fimi",
           "fimi_universe"]
