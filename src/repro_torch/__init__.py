"""repro_torch — RDD-Eclat on PyTorch, with hand-written CUDA kernels for
Hopper (H100, ``sm_90a``).

The port of the ``repro`` package, slice by slice.  This package imports
``torch`` and ``numpy`` only.

Ported so far: the single-device batch miner.

  core      packed vertical DB, Phase-2 co-occurrence counts, the level
            expansion engine (``fused`` / ``ref`` backends), the ``mine()``
            driver for variants v1..v6, closed/maximal/top-k post-filters
  kernels   ``fused_intersect`` (gather + AND/ANDNOT + popcount + threshold,
            with survivor compaction) and ``trimatrix`` (co-occurrence
            counts), each a CUDA C++ kernel under ``csrc/`` with a plain
            torch ``ref`` beside it
  data      the paper's Table-2 dataset generators (numpy, seed-identical to
            the reference package)
  launch    ``python -m repro_torch.launch.mine``

Entry points run on CUDA unless the caller passes ``device="cpu"``; see
:mod:`repro_torch.device`.
"""
__version__ = "0.1.0"
