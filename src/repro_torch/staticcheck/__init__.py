"""The port's static and steady-state guard over the mining path (the
reference's ``repro/staticcheck``), in three layers and one gate
(``python -m repro_torch.staticcheck``):

  Layer 1  AST lint over the port's own Python (``astlint`` + ``rules``):
           RS001-RS004 as the reference has them, RS005 for torch's
           host<->device conversions in the registered hot functions;
           each RS005 suppression names the Layer-3 sync it is.
  Layer 2  counted collective contracts (``contracts``): one expansion of
           every backend, and the streaming ring's block write, run on
           gloo ranks; the collectives they make, read from
           ``dist.collective_counts``, are held to the declared set, byte
           budget and axis width.
  Layer 3  steady-state audit (``shapes``): a warm ``mine()`` level by
           level and >= 5 stream slides, every host sync counted by
           ``torch.cuda.set_sync_debug_mode("warn")`` and held to the
           declared ``SYNC_BUDGET``, no kernel build and no new allocator
           segment after warm-up, every padding on the bucket ladder.

Layer 1 imports neither torch nor numpy; layers 2 and 3 import torch.
"""
from .report import Finding, Report, SEVERITY_ERROR, SEVERITY_WARNING
from .rules import RULES, HOT_PATHS, rule_ids
from .astlint import (check_sync_markers, iter_python_files, lint_file,
                      lint_paths, sync_markers)

__all__ = [
    "Finding", "Report", "SEVERITY_ERROR", "SEVERITY_WARNING",
    "RULES", "HOT_PATHS", "rule_ids",
    "lint_file", "lint_paths", "iter_python_files", "sync_markers",
    "check_sync_markers",
]
