"""repro_torch.core — RDD-Eclat on PyTorch, on one device or a mesh of ranks.

Public surface:
  mine / EclatConfig / EclatResult      level-wise RDD-Eclat, variants v1..v6
  apriori_mine / AprioriResult          the paper's Spark-Apriori baseline
  resume_mine, recover_partition        resume from per-level checkpoints;
                                        lineage replay of one partition
  make_engine / available_backends      the ``fused`` and ``ref`` executors and
                                        the mesh backends
  bruteforce_fim                        exact oracle for tests
  closed/maximal_itemsets, top_k_mine   workload modes (lineage post-filters)
  build_vertical / filter_transactions  vertical DB construction
  assign_partitions / partition_stats   equivalence-class partitioners
  generate_rules, support_checksum      ARM step 2; digest of a result
"""
from .accumulator import HostAccumulator, build_vertical_accumulated
from .apriori import AprioriResult, apriori_mine
from .eclat import (VARIANTS, EclatConfig, EclatResult, mine, resolve_min_sup,
                    resume_mine)
from .engine import Engine, LevelResult, available_backends, make_engine
from .itemsets import ItemsetStore, LevelRecord, generate_rules, support_checksum
from .lineage import (latest_mining_checkpoint, load_mining_checkpoint,
                      recover_partition, save_mining_checkpoint)
from .oracle import bruteforce_fim
from .partitioners import (PARTITIONERS, assign_partitions, partition_stats)
from .postfilter import (WORKLOAD_MODES, TopKResult, closed_itemsets,
                         filter_mode, frequent_from_closed, maximal_itemsets,
                         top_k_mine)
from .vertical import VerticalDB, build_vertical, filter_transactions

__all__ = [
    "HostAccumulator", "build_vertical_accumulated",
    "AprioriResult", "apriori_mine",
    "VARIANTS", "EclatConfig", "EclatResult", "mine", "resolve_min_sup",
    "resume_mine", "recover_partition", "save_mining_checkpoint",
    "load_mining_checkpoint", "latest_mining_checkpoint",
    "Engine", "LevelResult", "available_backends", "make_engine",
    "ItemsetStore", "LevelRecord", "generate_rules", "support_checksum",
    "bruteforce_fim",
    "PARTITIONERS", "assign_partitions", "partition_stats",
    "WORKLOAD_MODES", "TopKResult", "closed_itemsets", "filter_mode",
    "frequent_from_closed", "maximal_itemsets", "top_k_mine",
    "VerticalDB", "build_vertical", "filter_transactions",
]
