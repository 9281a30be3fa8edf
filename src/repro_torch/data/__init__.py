"""repro_torch.data — the paper's Table-2 dataset generators (numpy)."""
from .synthetic import (DatasetSpec, PAPER_DATASETS, attribute_table,
                        clickstream, generate, materialize, quest)

__all__ = ["DatasetSpec", "PAPER_DATASETS", "attribute_table", "clickstream",
           "generate", "materialize", "quest"]
