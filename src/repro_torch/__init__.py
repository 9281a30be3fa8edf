"""repro_torch — RDD-Eclat on PyTorch, with hand-written CUDA kernels for
Hopper (H100, ``sm_90a``).

The port of the ``repro`` package, slice by slice.  This package imports
``torch`` and ``numpy`` only.

Ported so far: the batch miner, on one device and on a mesh of ranks
(``torch.distributed``), the sliding-window miner, its query service and
its asynchronous admission front end, checkpoint/restore with re-meshing
(stream and batch), and batched LM serving of the dense decoders.

  core      packed vertical DB (with the v3 accumulator's mesh merge),
            Phase-2 co-occurrence counts, the level expansion engine
            (``fused`` / ``ref`` backends; ``sharded`` / ``tidsharded`` /
            ``grid`` on a mesh; its ``EngineState``), the ``mine()`` driver
            for variants v1..v6 with per-level checkpoints and
            ``resume_mine``, lineage recovery, closed/maximal/top-k
            post-filters, greedy-LPT packing
  dist      word-axis sharding of a frontier, and the collectives over a
            named mesh axis (all-reduce, all-gather, broadcast), with their
            counters
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
  streaming ``WindowRing`` (the window as a ring of packed word-blocks on
            the device, word-sharded on a mesh) and ``StreamingMiner``
            (incremental co-occurrence counts, re-expansion of the active
            classes through the engine); their serializable states and
            ``persist`` (checkpoint, ``restore_miner`` under any mesh)
  serving   ``ServingEngine`` (prefill + decode, request packing), metrics;
            ``StreamQueryService`` (top-k, rules, packed query batches over
            version-stamped window snapshots); ``ServingFrontend``
            (asynchronous admission, backpressure, a writer heartbeat) and
            ``loadgen`` (query storms, their verification)
  training  atomic asynchronous checkpoints (the reference's on-disk form)
            and the writer heartbeat
  data      the paper's Table-2 dataset generators and micro-batch streams
            (numpy, seed-identical to the reference package)
  faults    named kill points for fault injection
  launch    ``python -m repro_torch.launch.{mine,stream,serve,serve_profile}``;
            ``launch.mesh`` builds the meshes and starts the ranks

Entry points run on CUDA unless the caller passes ``device="cpu"``; see
:mod:`repro_torch.device`.
"""
__version__ = "0.1.0"
