"""repro_torch — RDD-Eclat on PyTorch, with hand-written CUDA kernels for
Hopper (H100, ``sm_90a``).

The port of the ``repro`` package, slice by slice.  This package imports
``torch`` and ``numpy`` only.

Ported so far: the batch miner, on one device and on a mesh of ranks
(``torch.distributed``), and batched LM serving of the dense decoders.

  core      packed vertical DB (with the v3 accumulator's mesh merge),
            Phase-2 co-occurrence counts, the level expansion engine
            (``fused`` / ``ref`` backends; ``sharded`` / ``tidsharded`` /
            ``grid`` on a mesh), the ``mine()`` driver for variants v1..v6,
            closed/maximal/top-k post-filters, greedy-LPT packing
  dist      word-axis sharding of a frontier, and the collectives over a
            named mesh axis, with their counters
  kernels   ``fused_intersect`` (gather + AND/ANDNOT + popcount + threshold,
            with survivor compaction, and the shard-local partial
            popcount), ``trimatrix`` (co-occurrence counts),
            ``popcount_support`` (AND + popcount of pre-gathered rows),
            ``flash_attention`` (prefill) and ``decode_attention``
            (one-token GQA over the KV cache), each a CUDA C++ kernel under
            ``csrc/`` with a plain torch ``ref`` beside it
  configs   gemma3-4b and gemma-2b (copies of the reference's), reduced
  models    dense decoder: layers, MLP, attention, prefill/decode, and the
            reference's weights carried over (``params_from_numpy``)
  serving   ``ServingEngine`` (prefill + decode, request packing), metrics
  data      the paper's Table-2 dataset generators (numpy, seed-identical to
            the reference package)
  launch    ``python -m repro_torch.launch.{mine,serve,serve_profile}``;
            ``launch.mesh`` builds the meshes and starts the ranks

Entry points run on CUDA unless the caller passes ``device="cpu"``; see
:mod:`repro_torch.device`.
"""
__version__ = "0.1.0"
