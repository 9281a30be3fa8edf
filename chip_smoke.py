#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card:

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into the git-ignored
``build/``) and holds every kernel against its plain torch version on the
card at the shapes the main paths give it.  Then it drives both ported
paths end to end:

* the batch miner ``mine()`` on the paper's T10I4D100K and chess datasets
  at full scale, against the reference package's checksums;
* the paper's Spark-Apriori baseline (``apriori_mine``) on the same data
  and checksums, its containment product on the card and no kernel of the
  package launched, timed per level beside the fused Eclat mine (the
  paper's headline ratio on this card), and T10I4D100K through a FIMI file;
* the same mines on meshes of ranks through ``torch.distributed``: the
  ``tidsharded`` backend on one NCCL rank in this process, then
  ``tidsharded`` 1x4, ``sharded`` 4, ``grid`` 2x2 and a v3 mine through the
  mesh accumulator on 4 gloo ranks sharing the card, each rank held to the
  same checksums, with the partial-popcount kernel (K3; none for
  ``sharded``) and the survivor compaction (K2) launched once per expansion
  and the collectives per expansion checked;
* the sliding-window miner (``StreamingMiner``) over T10I4D100K and chess
  streams (a 16 x 8,192-transaction window for T10I4D100K, 8 x 512 for
  chess, the last batches drifting): on the ``fused`` and ``ref`` backends,
  every slide held to the port's batch ``mine()`` of the window, to the
  ``ref`` stream and to the reference's pinned checksums, with the
  co-occurrence kernel (K4) launched once per warming push and twice per
  evicting push and K2 once per expansion; then on 4 gloo ranks sharing
  the card (word-sharded ring: tidsharded 1x4 and grid 2x2; sharded 4),
  every rank held to the same checksums with no collective in a push, and
  K2/K3/K1 held on the level-2 pair lists over the ring (universe item ids
  in support order);
* the non-compacting engine (``compact=False``, ``run_no_compaction``):
  the three mines above with K1 writing each expansion's whole (Q, W)
  block, the mask on the host and a row gather, on the pinned checksums
  with K1 once an expansion and K2 never; the chess stream's first 3
  slides the same way, each equal to the compacting miner's slide;
* resilience and the FIM serving front end over the T10I4D100K stream
  (``run_resilience``): kill the checkpointing stream at a kill point,
  ``restore_miner`` and replay on the pinned checksums with the launch
  gates, on the card and re-meshed onto 4 gloo ranks (tidsharded 1x4, grid
  2x2, K3 per expansion), a 4-rank checkpoint restored on the card;
  ``resume_mine`` of T10I4D100K from its level-3 checkpoint on the card
  and on 4 ranks; ``ServingFrontend`` under a 200-query storm while a
  writer thread slides, every answer verified, and the front end restored
  from a checkpoint answering the same storm identically;
* tile selection and dispatch (``run_autotune``): every lanes candidate
  of the survivor compaction (K2), every word split of the co-occurrence
  kernel (K4) and every window plan of K1 and K3 (at their main-path
  classes and edge shapes, with and without their stores, the library's
  plan equal to the Python mirror's; refused plans raising before any
  launch) exactly against their plain versions; the ``launch.kerneltune``
  sweep (each shape class's candidates timed, K1's and K3's tuned plans
  against their rule and bound, the ref-vs-fused crossover table, tuned
  against default tiles); mines of T10I4D100K and chess with
  ``autotune=True``, each ``block_w`` candidate and ``backend="auto"``,
  the same mines with ``compact=False`` tuning K1 and with each
  ``block_w`` naming one of K1's chunks, the chess stream with
  ``autotune=True``, and a tidsharded chess mine and stream with
  ``autotune=True`` on 4 gloo ranks (K3 tuned at each rank's slice), on
  the pinned checksums with the launch gates (the tuner's own launches
  counted apart);
* the mining path's steady-state guard (``repro_torch.staticcheck``,
  ``run_staticcheck``): the port's lint (RS001-RS005, every RS005
  suppression a declared sync); a warm ``mine()`` level by level and 5
  warm stream slides on the fused backend, ``compact=True`` (K2, K4) and
  ``compact=False`` (K1, K4), every host sync counted by torch's
  sync-debug mode equal to its declared ``SYNC_BUDGET`` entry and what
  the card synchronised on (``torch.profiler``'s CUDA runtime calls) within
  the budget's total, no kernel build and no new allocator segment after
  warm-up, every padding on the bucket ladder; the shape fixture tripping
  SH001, SH002 and SH003, the card-sync fixture (a
  ``cudaEventSynchronize`` the sync-debug mode misses) SH002; the
  collective contracts of every backend and of the ring write on 4 gloo
  ranks sharing the card (K3 on the word-sharded ranks), each of the four
  contract fixtures rejected;
* LM serving of gemma3-4b at full width and depth (bf16, random weights
  from a seeded generator): ``ServingEngine.serve`` of 8 requests, twice,
  with the flash- and decode-attention kernels' launch counts and
  identical greedy outputs required, decode-matches-prefill over all 34
  layers, and the model through the kernels against the same model with
  their plain versions in their place, in float32 and in bf16;
* the same traffic served, the same way, by internlm2-20b at full width and
  depth (48 layers, G = 6, D = 128), command-r-35b at full width and depth
  (40 layers, a parallel block, layernorm, G = 8, D = 128, a tied
  vocabulary of 256,000; 60.6 GB of bf16 weights drawn a layer at a time,
  the peak memory printed), grok-1 at full width cut to 4 of its
  64 layers (a mixture of top-2 of 8 experts, attention soft-capped at 30
  in both kernels) and llama4-maverick at full width cut to 2 of its 48
  (one dense layer, one MoE of top-1 of 128 experts, greedy placement,
  G = 5), one model at a time: each MoE layer's dropped share and expert
  load, then on a copy of the first 2 layers at full width the kernel path
  against the plain path and decode-matches-prefill in float32 and bf16;
  the four new configs reduced, in float32, on the card against the CPU,
  also at their own group sizes (``check_reduced_models``); K7 is held at
  every group size from 1 to 8, and K6 and K7 with a soft-cap;
* the recurrent families served the same way at full width and depth:
  hymba-1.5b (32 layers, attention with a window of 2,048 beside a
  selective SSM in every layer; K6 and K7 at D = 64, G = 5) and xlstm-1.3b
  (48 layers, 42 mLSTM and 6 sLSTM blocks; no attention kernel, so its
  launch gates are 0), their decode steps making no host sync; hymba's
  first 2 layers and xlstm's first 8 (its first sLSTM among them) checked
  as above (xlstm, which launches no kernel, decode-matches-prefill only);
  both reduced, in float32, on the card against the CPU;
* phi-3-vision-4.2b served the same way at full width and depth (32
  layers, K6 and K7 at D = 96, G = 1), and whisper-base (6 encoder and 6
  decoder layers) transcribing 8 clips of 1,500 frame embeddings, 224
  greedy tokens each, twice (``run_whisper_serving``): K6 once per
  encoder layer and twice per decoder layer in the prefill (self, then
  cross-attention over the 1,500 encoder rows at Sk != S), K7 twice per
  decoder layer and step (self, then over the cross rows), identical
  outputs, no host sync in a decode step, decode-matches-prefill and the
  kernel path against the plain one over 64 tokens of a clip; K6 at
  Sk != S (S = 1, 4, 37, 228 over 1,500 rows) and at D = 96, K7 at D = 96
  and over the cross rows, against their plain versions
  (``check_slice_attention``);
* LM training: K6's forward ``lse`` and its hand-written backward (bf16:
  the delta, wgmma + TMA dK/dV, reduction and dQ kernels; float32: FMA
  kernels) against the plain textbook backward and, in bf16, against the
  emulation of its arithmetic at gemma-2b's and gemma3-4b's attention
  shapes and, soft-capped at 30, at grok's training layer, bit-equal on a
  second call (``check_flash_attention_bwd``); the
  float32 reduced gemma-2b and
  gemma3-4b trained 5 steps on the card and on the CPU from the same
  weights and batches, also with ``remat="full"`` (``run_training_reduced``);
  gemma-2b at full width and depth (18 layers, bf16, B = 4, S = 1,024)
  trained 6 steps, the first 3 through ``TrainingRunner.run`` with a
  checkpoint at step 3, a fresh runner restored from it giving steps 4-6
  bit for bit,
  18 K6 forward and 18 backward launches a step, the plain attention
  paths made to raise on the card, and step 1 again with the plain
  attention patched in (``run_training``); grok-1 at full width cut to 1
  of its 64 layers (B = 2, S = 1,024) the same way, 5 steps with a
  restore at 3, its MoE's dropped share each step, K6's capped forward
  and backward once a step (``run_training_grok``); phi-3-vision-4.2b at
  full width and depth (B = 4, S = 1,024, the first 256 positions image
  embeddings) 6 steps in memory, K6's forward and backward at D = 96 once
  a layer and step (``run_training_phi3``); whisper-base at full width and
  depth (6 + 6 layers, B = 16 clips of S = 448 tokens over 1,500 frame
  embeddings) 6 steps in memory, the loss's encoder branch, K6 forward and
  backward once per encoder layer and twice per decoder layer a step (the
  cross-attention's at Sk = 1,500 != S), counted by shape, step 1 against
  the plain attention (``run_training_whisper``); K6's backward at
  whisper's cross and encoder shapes against its plain versions
  (``check_flash_attention_bwd``) and timed at the cross shape beside
  SDPA's backward (``time_whisper_cross_bwd``); hymba-1.5b and xlstm-1.3b
  at full width and depth (B = 4, S = 1,024, ``remat="full"``) 3 steps in
  memory, hymba's K6 forward twice and backward once per layer a step
  (xlstm launches none), step 1 against the plain attention (xlstm:
  against itself run again) (``run_training_recurrent``); K6's backward at
  hymba's training layer (D = 64, G = 5) in both of its plans against its
  plain versions and timed beside SDPA's backward
  (``time_hymba_training_bwd``);
* LM training on the reference's tiny mesh, (data, model) = (2, 2), as 4
  gloo ranks sharing the card (``run_mesh_training``): the float32 reduced
  gemma-2b, gemma3-4b, grok-1 (experts ``tp2d``), llama4-maverick
  (``ep``, the all-to-all), xlstm-1.3b and hymba-1.5b (the mLSTM, sLSTM
  and SSM blocks tensor-parallel) against one CPU process, gemma-2b at
  full width with 4 of its 18 layers and xlstm-1.3b at full width with 8
  of its 48 in bf16 against one rank of the card, a TrainingRunner
  restored on the mesh replaying step 3 bit for bit, K6 forward and
  backward once per attention layer and step on every rank and the
  collectives a step equal to the count the config gives
  (``step_collectives``); whisper-base (encoder, cross-attention,
  vocabulary of 51,865 replicated), phi-3-vision-4.2b (its 256 image rows;
  4 of 32 layers) and hymba-1.5b (25 heads all on every rank, vocabulary of
  32,001 replicated; 8 of 32 layers, ``remat="full"``) at full width in
  bf16 against one rank of the card, with their reduced configs (and a
  vocabulary of 257, hymba with 5 heads) in float32 against one CPU
  process; K6 at the ranks' shapes against its plain versions and timed
  (``time_mesh_rank_attention``); the reduced float32 grok-1 (``tp2d``)
  and llama4-maverick (``ep``) with two microbatches on tiny, on (pod,
  data, model) = (2, 2, 1) and llama4 with both, against the same jobs on
  4 gloo ranks of the host (``MESH_MOE_JOBS``), and K6's float32 backward
  timed at the float32 forward row's shape and a reduced rank's
  (``time_f32_flash_attention_bwd``); ``seq_parallel`` (the residual's
  sequence split over ``model``), ``mlp_dp`` and layers the model axis does
  not split (run whole on every rank) in float32 reduced jobs against one
  CPU process (grok against the host's ranks), and gemma-2b at full width
  (4 of 18 layers) with ``seq_parallel`` and ``mlp_dp`` against the same
  model without them and against one rank, its step ms, peak GB a rank and
  collectives' calls and bytes by axis printed (``MESH_SP_JOBS``,
  ``_check_sequence_parallel_mesh``);

and times each kernel beside its bound, its plain version and, where one
exists, a PyTorch call that computes the same function (K4 also at the
streams' per-push shapes, with a sweep of its word split).  The pair kernels
(K1, K2, K3) are held and timed on random pair lists and on the pair lists
of the largest expansion of the fused mines of chess and T10I4D100K,
recorded on the card (class-ordered, as the miner makes them); the kernels
line reports K1 (with its (Q, W) store, as the non-compacting engine
launches it) and K3 on the latter.

Output, in order: the device lines (``nvidia-smi`` name and power limit,
torch and CUDA versions, build time), one line per kernel check, one line
per end-to-end run, one line per timing, then a JSON line
``{"kernels": [...]}`` and last ``{"ok": true, "device": {...}}``.  Any
mismatch or failure exits non-zero before the last line.  With no CUDA
device, or outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# support_checksum of the reference package's mine() on these inputs
# (data.generate(name, scale=1.0, seed=0)); tests/test_torch_eclat.py pins
# the T10I4D100K value on both packages
E2E_RUNS = [
    ("T10I4D100K", 0.01, "v4", False, "a38431aa361588e6"),
    ("chess", 0.7, "v4", False, "fc427bbc1d53e5f2"),
    ("chess", 0.7, "v6", True, "fc427bbc1d53e5f2"),
]

# support_checksum of the reference package's StreamingMiner (backend "jnp")
# on each slide of the streams run_streams drives
# (launch.stream_profile.STREAMS: data.transaction_stream(name, block_txns,
# batches, seed=0, drift_every)); tests/test_torch_streaming.py pins the same
# values on both packages
STREAM_CHECKSUMS = {
    "T10I4D100K": [
        "03305fb35202fa33", "2cff9a67305caa38", "330914aa9d78b1dc",
        "a49de3e2f76fbde4", "b03d61799cf80e13", "cde3eb63dd828774",
        "2b8bb8e40af4c4f1", "fd3beca102104c57", "48cb32f42b213481",
        "18485b8e49c2b140", "cdc38c87ef19d4c5", "a32c33d11163ec46",
        "a9d267c1349edbdd", "38c1f186f8d98dc1", "c3b72a197c457c90",
        "71c063f1323ea9dc", "359712b5284a0b6e", "490da9deab146303",
        "e62d757c708ee9f7", "c0975c23b8dde087"],
    "chess": [
        "8f740a07f28b2496", "ea61966d69f71a28", "2f0261fcda8c158d",
        "df3151933e5b96d3", "822ec7f19c6ee450", "941c228891adb46d",
        "d94f4366b1c78355", "19217ac50694306e", "6f3ec44c33026b8a",
        "1f2cdef8ca8ceb9a", "9dc0ded648efae63", "4e05527418f8d44c"],
}
# the mesh streams, on 4 gloo ranks sharing the card: (label, stream,
# backend, shard, grid)
MESH_STREAMS = [("tidsharded 1x4", "chess", "fused", "words", None),
                ("grid 2x2", "chess", "grid", "grid", "2x2"),
                ("sharded 4", "chess", "sharded", "pairs", None),
                ("tidsharded 1x4", "T10I4D100K", "fused", "words", None)]

# K3 shapes (P, Ws, Q) of the word-sharded mines at 4 word shards: chess
# level 5 (W = 100) and T10I4D100K level 3 (W = 3,125); these are timed
PARTIAL_SHAPES = [(60038, 25, 393216), (852, 782, 4096)]
# the same levels at the other slice widths the mesh mines launch K3 with:
# 1 word shard (the NCCL rank holds the whole rows) and 2 (grid 2x2)
PARTIAL_CHECKED = PARTIAL_SHAPES + [(60038, 100, 393216), (852, 3125, 4096),
                                    (60038, 50, 393216), (852, 1563, 4096)]
# K1's and K3's window plans (run_autotune): edge shapes beside the main
# path's classes (launch.kerneltune.K1_SHAPES, K3_SHAPES), each held at every
# plan of autotune.window_candidates: (label, P, W, Q, pairs), pairs
# "class" (class-ordered, a 10% pad tail) or "random"
WINDOW_EDGES = [("Q=1001 W=100 (no multiple of a tile)", 300, 100, 1001, "class"),
                ("Q=4097 W=3125", 64, 3125, 4097, "random"),
                ("W=131 (W % 4 != 0)", 300, 131, 1001, "class"),
                ("W=7 (W % 4 != 0)", 40, 7, 300, "random"),
                ("Q=1 W=100", 5, 100, 1, "random"),
                ("Q=0 W=100", 5, 100, 0, "random")]
# plans the check must refuse, at (W, plan): a tile that is no power of two,
# too small, too large; no window rows, too many; a chunk off its tile's
# bank skew, or none; stages or whole rows past the shared memory a block
# may take
WINDOW_REFUSED = [(100, (12, 24, 100)), (100, (4, 8, 100)), (100, (512, 256, 100)),
                  (100, (256, 0, 100)), (100, (256, 257, 100)),
                  (3125, (16, 32, 100)), (3125, (16, 32, 0)),
                  (3125, (8, 256, 1020)), (3125, (256, 256, 3125))]
# the compact=False mines run_autotune drives with tuned and named plans,
# by dataset: the K1 class whose chunk candidates name its block_w arms
WINDOW_MINE_CLASS = {"chess": (393216, 100), "T10I4D100K": (4096, 3125)}
# K5 shapes (M, W): the row pairs of T10I4D100K level 3 and of chess level
# 5, pre-gathered (no mining path calls K5)
PS_SHAPES = [(4096, 3125), (393216, 100)]

# Phase-2 shapes (N, W) that are checked: T10I4D100K, 1000 items, the
# tri-matrix item cap, chess (13 word ranges), and tile and word edges
TRI_SHAPES = [(187, 3125), (1000, 3125), (4096, 3125), (1, 1), (33, 7),
              (37, 100), (65, 7), (129, 3125)]


# the shape of each kernel's row in the "kernels" line: the largest call
# the main path makes (chess level 5, for K1 and K3 on the pair lists the
# port's own mine makes there; T10I4D100K Phase 2; a gemma3-4b global
# layer's prefill and its last decode step)
MINER_CHESS = "chess 0.7 v4 miner pairs: P=65536 W=100 Q=393216 valid=369616"
REPORT_SHAPE = {"fused_intersect": MINER_CHESS,
                "fused_intersect_compact": "P=60038 W=100 Q=393216",
                "fused_intersect_partial": f"{MINER_CHESS} Ws=25",
                "popcount_support": "M=4096 W=3125",
                "trimatrix": "N=187 W=3125",
                "flash_attention": "B=2 H=8 Hkv=4 S=2048 D=256 bf16 causal window=0",
                "flash_attention_f32": "B=2 H=8 Hkv=4 S=2048 D=256 f32 causal window=0",
                "decode_attention": "B=2 KV=4 G=2 D=256 S=2080 len=2079 bf16 window=0",
                "flash_attention_bwd": "B=4 H=8 Hkv=1 S=1024 D=256 bf16 causal window=0"}
MINING_KERNELS = ("fused_intersect", "fused_intersect_compact", "trimatrix")
# the mining kernels the compacting fused mines launch: K1's arithmetic
# runs inside K2's one pass, so such a mine launches K1 (fused_intersect)
# no time; the non-compacting engine (run_no_compaction) launches K1 and
# not K2
MAIN_PATH_MINING = ("fused_intersect_compact", "trimatrix")
# the kernels of one K2 call, as a profiler trace names them: one pass
# writes survivors and pad rows
COMPACT_KERNELS = ("compact_pairs_kernel",)

# largest |kernel - plain| seen by the checks, per kernel
MAX_ABS_ERR = {name: 0 for name in REPORT_SHAPE}

# the generated datasets, by name: (transactions, spec)
DATA = {}
# the streams' micro-batches run_streams generates, by name (run_resilience
# replays them)
STREAM_BATCHES = {}

# the resilience phase (run_resilience) on the T10I4D100K stream: a
# checkpoint every RESILIENCE_EVERY slides; kills during slide
# RESILIENCE_KILL (at miner:pre_deep_expand) and during the write of the
# step after it (checkpoint:pre_replace), both leaving step 8 as the newest
# durable one; the 4-rank replays checkpoint every 6 slides (steps 12 and
# 18), and the card restores their step 18 and replays the drift slides
RESILIENCE_STREAM = "T10I4D100K"
RESILIENCE_EVERY = 4
RESILIENCE_KILL = 10
RESILIENCE_MESH_EVERY = 6
RESILIENCE_MESHES = [("tidsharded 1x4", "tidsharded", "words", None),
                     ("grid 2x2", "grid", "grid", "2x2")]
# the batch resume: the fused mine of T10I4D100K 0.01 v4 checkpointed every
# level, resumed from level 3 (the deeper checkpoints dropped)
RESUME_LEVEL = 3
# the FIM serving run: batch 0 ingested, then a writer slides SERVE_SLIDES
# batches under a SERVE_QUERIES-query storm (query_mix seed 0) from
# SERVE_CLIENTS threads, policy block
SERVE_SLIDES = 8
SERVE_QUERIES = 200
SERVE_CLIENTS = 4
SERVE_PACE_S = 0.002

# attention kernels against their plain versions, which compute in float32
# and are run in float32 on the kernel's inputs.  float32 outputs: the sums
# are taken in another order (the kernels' online softmax over 32- or
# 64-row tiles, the plain versions' one softmax over the whole row) and
# agree to about 1e-6 on outputs of magnitude below 4: limit 1e-4.
# bfloat16 outputs: the kernel computes in float32 and rounds once to
# nearest, so it lies within half a unit in the last place of the float32
# value, |got - want| <= 2**-8 |want|, plus ATTN_BF16_ATOL for the float32
# order difference where |want| is near 0.  A truncating store, or any
# error of a unit in the last place, breaks it.
ATTN_TOL_F32 = 1e-4
ATTN_BF16_REL = 2.0 ** -8
ATTN_BF16_ATOL = 1e-5
# torch's scaled_dot_product_attention, the timing yardstick, need only
# compute the same function: its flash backend rounds the probabilities to
# bfloat16 before the PV product, a few units in the last place
SDPA_TOL = 2.0 ** -5
# decode-matches-prefill: the last-position logits of a 2,048-token prompt,
# prefilled whole and prefilled to 2,048 - K then decoded K tokens, compared
# by ||delta|| / ||logits||.  In float32 (the served weights, cast) the two
# paths differ only in the order of their sums, 1e-6 each through 34
# layers: bound 1e-3.  In bfloat16 every activation and the cache are
# rounded to 8 bits at places that differ between the two paths, so the
# bound is the bfloat16 error the prefill path itself has against float32
# on the same weights, measured in the same run: the decode path's error
# against float32 may be at most DECODE_BF16_FACTOR times it.
DECODE_K = 16
DECODE_TOL_F32 = 1e-3
DECODE_BF16_FACTOR = 2.0
# the served bf16 model through the kernels against the same model with
# the kernels' plain versions patched in, logits by ||delta|| / ||logits||.
# The two differ only where a float32 attention output rounds to another
# bf16 value, but the 34 random-weight layers grow any bf16-sized
# difference to the size of the model's own bf16 error: on an H100 it read
# 2.6e-2 (prefill) and 2.4e-2 (after the decode steps), the plain path's
# own bf16 error against float32 2.5e-2.  The limit is about twice that;
# it catches faults larger than rounding (layouts, masks, head maps), and
# the kernel checks above hold the rounding itself.
KERNELS_VS_PLAIN_BF16 = 5e-2
# soft-capped attention checks draw q this many times larger, so that the
# scaled scores (about N(0, 1) otherwise) reach grok's cap of 30 and tanh
# bends them
CAP = 30.0
CAP_Q_SCALE = 16.0
# the full-width serves of the models added after gemma3-4b (their depths:
# launch.serve_profile.SERVE_LAYERS); their kernel-vs-plain and
# decode-matches-prefill checks run on a depth-cut copy of DEPTH_CUT layers
# at full width (xlstm: CUT_LAYERS, so that the copy holds an sLSTM), over
# a prompt of CUT_PROMPT tokens (CUT_PROMPT - DECODE_K prefilled, then
# DECODE_K decode steps; the prefills span 8 of the mLSTM's 64-position
# chunks and 4 of the SSM's 128), an MoE at a capacity that drops nothing
# (capacity_factor = n_experts, as tests/test_decode_consistency.py sets
# it: prefill and decode drop other tokens at their own capacities, and a
# bf16 rounding that flips one router choice moves which tokens the
# capacity drops)
SERVED_ARCHS = ("internlm2-20b", "command-r-35b", "grok-1-314b",
                "llama4-maverick-400b-a17b", "hymba-1.5b", "xlstm-1.3b",
                "phi-3-vision-4.2b")
DEPTH_CUT = 2
CUT_LAYERS = {"xlstm-1.3b": 8}
CUT_PROMPT = 512
# the reduced configs of this slice on the card against the CPU, float32:
# logits within 1e-4 (sums in another order through a few layers)
REDUCED_LOGITS_TOL = 1e-4
# K6's backward against the plain textbook backward (attention_ref_bwd, run
# in float32 on the kernel's inputs and forward output): float32 gradients
# within 1e-4 absolute (sums in another order; they read up to 4e-5 on
# gradients of magnitude up to 30); bf16 gradients, rounded once to bf16
# (2^-9 relative), within 1e-2 in ||delta|| / ||ref|| each.  The forward's
# row log-sum-exp within LSE_TOL of the plain scores' logsumexp (float32
# rounding of values below 20).
BWD_TOL_F32 = 1e-4
BWD_REL_BF16 = 1e-2
LSE_TOL = 1e-4
# the bf16 backward against the emulation of its arithmetic
# (attention_bwd_bf16_ref: P and dS rounded once to bf16, the group summed
# in split order), both rounded to bf16: they round fp32 values that differ
# by sums in another order and exp2 against exp, so an element near a
# rounding boundary may round the other way; they read 1e-4 to 2.5e-4 on
# an H100, limit a tenth of the gate against the plain version
BWD_REL_EMU = 1e-3
# training: the float32 reduced configs on the card against the CPU, loss
# by relative difference per step (float32 sums in other orders); the bf16
# gemma-2b step with the plain attention patched in against the kernels,
# loss and global grad norm by relative difference (the attention output
# rounded to bf16 at other places moves both by about the model's own bf16
# error)
TRAIN_F32_REL = 1e-4
TRAIN_PLAIN_BF16_REL = 1e-2
# gemma-2b training at full width: B x S tokens a step, steps, checkpoint
# interval (the restore replays the steps after the first checkpoint)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_EVERY = 4, 1024, 6, 3
# mesh training (run_mesh_training) on the reference's tiny mesh, (data,
# model) = (2, 2), 4 gloo ranks sharing the card: gemma-2b at full width,
# bf16, MESH_LAYERS of its 18 layers (four ranks of all 18 need ~75 GB),
# B x S tokens a step, MESH_STEPS steps
MESH_B, MESH_S, MESH_STEPS, MESH_LAYERS = 4, 1024, 3, 4
# the full-width bf16 mesh against the same 4-layer model on one rank of
# the card, loss and global grad norm by relative difference per step,
# stated before the first run from TRAIN_PLAIN_BF16_REL: the mesh rounds to
# bf16 at other places (each rank's partial products of the row-parallel
# layers and its half of the batch's gradients, rounded before they are
# summed; K6 over 4 heads a rank, its backward split otherwise), which
# moves both by about the model's own bf16 error
TRAIN_MESH_BF16_REL = 1e-2
# grok-1 training at full width on one card (run_training_grok): 1 of its
# 64 layers (a second MoE layer is ~59 GB more with AdamW), bf16, B x S
# tokens a step, steps (in memory); its attention layer (B, H, Hkv, S, D),
# K6's capped backward's row in the kernels line
GROK_B, GROK_S, GROK_STEPS = 2, 1024, 5
# the reduced float32 configs trained on the tiny mesh against one CPU
# process (run_mesh_training (a)), by label; MESH_REDUCED_CFG gives a
# label's config and the fields it replaces: a vocabulary of 257, which the
# model axis does not divide (replicated), and hymba with 5 heads of 16
# (the axis cuts wq's 80 columns mid-head: every head on every rank)
MESH_REDUCED_ARCHS = ("gemma-2b", "gemma3-4b", "grok-1-314b",
                      "llama4-maverick-400b-a17b", "xlstm-1.3b", "hymba-1.5b",
                      "whisper-base", "whisper-base vocab 257", "phi-3-vision-4.2b",
                      "hymba-1.5b 5 heads")
MESH_REDUCED_CFG = {"whisper-base vocab 257": ("whisper-base", {"vocab_size": 257}),
                    "hymba-1.5b 5 heads": ("hymba-1.5b", {
                        "n_heads": 5, "n_kv_heads": 5, "d_head": 16, "vocab_size": 257})}
# (g): sequence parallelism (the residual's sequence split over model),
# mlp_dp (the dense FFN replicated, run on the rank's rows) and leaves the
# model axis does not split (replicated, their layers run whole on every
# rank), reduced float32 on the tiny mesh against one CPU process (grok
# against the same job on 4 gloo ranks of the host): label -> (arch, the
# fields it replaces); hymba under remat="full", as the card trains it
SP = {"seq_parallel": True}
MESH_SP_JOBS = {
    "gemma-2b seq_parallel": ("gemma-2b", SP),
    "gemma-2b seq_parallel mlp_dp": ("gemma-2b", dict(SP, mlp_dp=True)),
    "gemma-2b d_ff 129": ("gemma-2b", {"d_ff": 129}),
    "command-r-35b seq_parallel": ("command-r-35b", SP),
    "grok-1-314b seq_parallel": ("grok-1-314b", SP),
    "hymba-1.5b seq_parallel": ("hymba-1.5b", SP),
    "xlstm-1.3b d_model 66 seq_parallel": ("xlstm-1.3b", dict(SP, d_model=66)),
    "whisper-base seq_parallel": ("whisper-base", SP),
    "whisper-base 1 KV head": ("whisper-base", {"n_kv_heads": 1}),
    "whisper-base 5 heads": ("whisper-base", {"n_heads": 5, "n_kv_heads": 5})}
MESH_REDUCED_ARCHS += tuple(MESH_SP_JOBS)
MESH_REDUCED_CFG.update(MESH_SP_JOBS)
MESH_REDUCED_REMAT = {"hymba-1.5b seq_parallel": "full"}
# the reduced float32 mixtures of experts with microbatches and on a mesh of
# two data axes (run_mesh_training (f)), each against the same job on 4
# gloo ranks of the host, at their own capacity factor: label -> (arch,
# global batch, microbatches, mesh: a name or (shape, axes))
POD_MESH = ((2, 2, 1), ("pod", "data", "model"))
MESH_MOE_JOBS = {
    "grok-1-314b microbatches 2": ("grok-1-314b", 4, 2, "tiny"),
    "llama4-maverick-400b-a17b microbatches 2": ("llama4-maverick-400b-a17b", 4, 2,
                                                 "tiny"),
    "grok-1-314b pod data": ("grok-1-314b", 4, 1, POD_MESH),
    "llama4-maverick-400b-a17b pod data": ("llama4-maverick-400b-a17b", 4, 1, POD_MESH),
    "llama4-maverick-400b-a17b pod data microbatches 2": (
        "llama4-maverick-400b-a17b", 8, 2, POD_MESH)}
# the full-width bf16 jobs on the tiny mesh beside gemma-2b's and xlstm's
# (run_mesh_training (e)), each against one rank of the card: whisper-base
# at full width and depth over its 1,500 frames; phi-3-vision-4.2b with its
# 256 image rows, 4 of its 32 layers (at full depth its ~45.9 GB of
# weights, gradients and moments, halved over model, come to ~92 GB over
# the 4 ranks on one 80 GB card); hymba-1.5b, 8 of its 32 layers under
# remat="full" (its one-card step is 5.7 s at 32 layers, and the check
# runs the job on one rank too), its 25 heads all on every rank and its
# vocabulary of 32,001 replicated: arch -> (layers or None for all, B, S,
# remat)
MESH_FULL = {"whisper-base": (None, 16, 448, "none"),
             "phi-3-vision-4.2b": (4, 4, 1024, "none"),
             "hymba-1.5b": (8, 4, 1024, "full")}
# K6 at a rank's shapes in the full-width mesh jobs, forward and backward
# against their plain versions, timed beside SDPA and its backward: label
# -> (B, H, Hkv, S, Sk, D, causal, window, the mask its launches are
# counted under, the job).  B over 2 data ranks; gemma-2b's 8 heads over 2
# model ranks, its one KV head gathered whole; whisper's and phi3's heads
# over 2 model ranks; hymba's 25 all on every rank
MESH_RANKS = {
    "gemma-2b": (2, 4, 1, 1024, 1024, 256, True, 0, "causal", "gemma-2b"),
    "whisper-base encoder": (8, 4, 4, 1500, 1500, 64, False, 0, "full", "whisper-base"),
    "whisper-base decoder": (8, 4, 4, 448, 448, 64, True, 0, "causal", "whisper-base"),
    "whisper-base cross": (8, 4, 4, 448, 1500, 64, False, 0, "cross", "whisper-base"),
    "phi-3-vision-4.2b": (2, 16, 16, 1024, 1024, 96, True, 0, "causal",
                          "phi-3-vision-4.2b"),
    "hymba-1.5b, every head": (2, 25, 5, 1024, 1024, 64, True, 2048, "causal",
                               "hymba-1.5b")}
GROK_LAYER = (2, 48, 8, 1024, 128)
GROK_LAYER_SHAPE = "B=2 H=48 Hkv=8 S=1024 D=128 bf16 causal window=0 softcap=30"
# phi-3-vision-4.2b (served above, SERVED_ARCHS) trained at full width and
# depth (run_training_phi3): B x S positions a step, the first
# frontend_len = 256 of them the image prefix (embeddings drawn from a
# generator seeded with the step), the rest text; PHI3_STEPS steps in
# memory, no checkpoint (run_training holds the checkpoint and restore;
# phi3's 38.3 GB of weights and AdamW moments would more than double the
# run's disk writes); no remat: its peak fits the card (60.49 GB on an
# NVIDIA H100 80GB HBM3, 700 W)
PHI3_B, PHI3_S, PHI3_STEPS = 4, 1024, 6
# phi3's training layer (B, H, Hkv, S, D): K6 and its backward at D = 96
PHI3_LAYER = (4, 32, 32, 1024, 96)
# whisper-base served (run_whisper_serving; launch.serve_profile's CLIPS
# and TRANSCRIBE_*): its decode-matches-prefill and kernel-vs-plain checks
# run over the first WHISPER_CHECK tokens of clip 0's transcript (the
# prompt and the first tokens the serve generated)
WHISPER_CHECK = 64
# whisper-base trained at full width and depth (run_training_whisper): B
# clips a step, each S = 448 decoder tokens (whisper's text context) over
# the 1,500 encoder frames (embeddings drawn from a generator seeded with
# the step, x 0.05, as the serve's clip_embeds), WHISPER_STEPS steps in
# memory, remat="none"; its cross-attention in training (B, H, Hkv, S, Sk,
# D): K6's backward row in the kernels line
WHISPER_B, WHISPER_S, WHISPER_STEPS = 16, 448, 6
WHISPER_CROSS = (WHISPER_B, 8, 8, WHISPER_S, 1500, 64)
WHISPER_CROSS_SHAPE = (f"B={WHISPER_B} H=8 Hkv=8 S={WHISPER_S} Sk=1500 D=64 bf16 "
                       "non-causal window=0 (whisper-base training cross)")
# xlstm-1.3b and hymba-1.5b trained at full width and depth
# (run_training_recurrent): bf16, B x S tokens a step, RECURRENT_STEPS steps
# in memory (3, for the script's time limit),
# remat="full" (the reference's TrainConfig.remat): without it
# xlstm's 42 mLSTM layers keep their 16 chunks' (B, H, 1,024, 1,024)
# float32 states each and hymba's 32 SSM scans their (B, 128, 3,200, 16)
# log steps, far beyond the card
RECURRENT_B, RECURRENT_S, RECURRENT_STEPS = 4, 1024, 3
# hymba's training layer (B, H, Hkv, S, D, window): K6's backward row in the
# kernels line; the window of 2,048 keeps every causal pair at S = 1,024
HYMBA_TRAIN = (RECURRENT_B, 25, 5, RECURRENT_S, 64, 2048)
HYMBA_TRAIN_SHAPE = (f"B={RECURRENT_B} H=25 Hkv=5 S={RECURRENT_S} D=64 bf16 causal "
                     "window=2048 (hymba-1.5b training layer)")
# the collectives over ``model`` of the parts of a layer on the tiny mesh,
# each a (forward, backward) pair of op lists (step_collectives): a
# tensor-parallel part enters by a copy (its gradient all-reduced) or, under
# sequence parallelism, a gather of the sequence (all-gather, its gradient
# reduce-scattered), and leaves by an all-reduce or a reduce-scatter (its
# gradient all-gathered); inside it a gather of columns (q, k, v, or MQA's
# one KV head, when the axis does not give each rank its own heads; the
# recurrent blocks' column-split projections) is an all-gather and its
# gradient a reduce-scatter, and the SSM's three replicated leaves (conv,
# bc_proj, a_log) have their gradients summed; a part run whole on every
# rank gathers its split weights (all-gather, no backward) and, under
# sequence parallelism, the sequence (all-gather), and cuts its output back
# to the rank's rows (its gradient all-gathered)
TP_ENTER = {False: ([], ["all_reduce"]), True: (["all_gather"], ["reduce_scatter"])}
TP_LEAVE = {False: (["all_reduce"], []), True: (["reduce_scatter"], ["all_gather"])}
COL_GATHER = (["all_gather"], ["reduce_scatter"])
GRAD_SUM = ([], ["all_reduce"])
UNSPLIT = (["all_gather"], [])
SPLIT = ([], ["all_gather"])
# the non-compacting engine (run_no_compaction): the E2E_RUNS mines with
# compact=False, and the chess stream's first NO_COMPACT_SLIDES slides with
# compact=False beside the compacting miner
NO_COMPACT_SLIDES = 3
# K6 over keys that are not the queries: whisper's cross-attention, the
# decoder's rows (one decode row, the 4-token prompt, a ragged 37, the
# whole 228-row text context) over the 1,500 encoder rows
CROSS_ROWS = (1, 4, 37, 228)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def compare(name, got, want, what):
    """Exact equality of a kernel output with its plain version; records
    the largest absolute difference."""
    import torch
    got, want = got.reshape(-1).long(), want.reshape(-1).long()
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got - want).abs().max()) if got.numel() else 0
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR[name], err)
    require(torch.equal(got, want), f"{what} differs from ref (max abs err {err})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def check_pair_kernels():
    import torch
    from repro_torch.kernels.fused_intersect import (
        fused_intersect, fused_intersect_compact, fused_intersect_compact_ref,
        fused_intersect_ref, fused_support_pairs)
    from repro_torch.launch.kernel_timing import (PAIR_SHAPES, class_pair_inputs,
                                                  pair_inputs)

    cases = []
    for p, w, q, nv in PAIR_SHAPES:
        cases.append((f"P={p} W={w} Q={q} n_valid={nv}", p, w, q, nv, None, "random"))
        # the same shape with class-ordered pairs and a (0, 0) pad tail, as
        # the miner gives them: K1 stages its windows
        cases.append((f"class-ordered P={p} W={w} Q={q} n_valid={nv}", p, w, q, nv,
                      None, "class"))
    # one class of 600 rows: its pairs overflow K1's 256-row window, so
    # the staged and the gathered rows meet in one launch
    cases.append(("one class of 600 rows W=100", 600, 100, 179700, 179700, None, "wide"))
    cases += [
        ("Q=1", 5, 9, 1, 1, None, "random"),
        ("W=1", 40, 1, 300, 300, None, "random"),
        ("W=7 (not a multiple of 4)", 40, 7, 300, 250, None, "random"),
        ("W=3125 Q=0", 8, 3125, 0, 0, None, "random"),
        ("no survivors", 64, 50, 500, 500, 10**9, "random"),
        ("all survivors", 64, 50, 500, 500, 0, "random"),
        ("n_valid < Q", 64, 50, 500, 123, None, "random"),
        ("n_valid=0", 12, 33, 300, 0, None, "random"),
        ("Q=12289 n_valid=8200 (many tiles)", 100, 33, 12289, 8200, None, "random"),
        ("Q=129 W=100 (one past a tile of 128 pairs)", 30, 100, 129, 129, None, "random"),
        ("Q=9 W=3125 (one past a tile of 8 pairs)", 10, 3125, 9, 9, None, "random"),
    ]
    for label, p, w, q, nv, ms_override, family in cases:
        for mode in (0, 1, 2):
            seed = p * 7 + w + q + mode
            if family == "random":
                bm, l, r, s, ms = pair_inputs(p, w, q, seed=seed)
            else:
                bm, l, r, s, ms = class_pair_inputs(p, w, q, nv, seed,
                                                    sizes=[p] if family == "wide" else None)
            if ms_override is not None:
                ms = ms_override
            got = fused_intersect(bm, l, r, s, ms, mode=mode)
            want = fused_intersect_ref(bm, l, r, s, ms, mode=mode)
            torch.cuda.synchronize()
            for g, e, what in zip(got, want, ("inter", "sup", "mask")):
                compare("fused_intersect", g, e, f"fused_intersect {label} mode {mode}: {what}")
            got = fused_support_pairs(bm, l, r, s, ms, mode=mode)
            torch.cuda.synchronize()
            for g, e, what in zip(got, want[1:], ("sup", "mask")):
                compare("fused_intersect", g, e,
                        f"fused_intersect without store {label} mode {mode}: {what}")
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = fused_intersect_compact(bm, l, r, s, ms, nv, mode=mode)
                again = fused_intersect_compact(bm, l, r, s, ms, nv, mode=mode)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = fused_intersect_compact_ref(bm, l, r, s, ms, nv, mode=mode)
            torch.cuda.synchronize()
            for g, a, e, what in zip(got, again, want, ("compact", "sup", "mask", "n_surv")):
                compare("fused_intersect_compact", g, e,
                        f"fused_intersect_compact {label} mode {mode}: {what}")
                require(torch.equal(g, a),
                        f"fused_intersect_compact {label} mode {mode}: two calls differ ({what})")
            n_surv = int(got[3])
            print(f"check fused_intersect (with and without store) + "
                  f"fused_intersect_compact {label} mode {mode}: "
                  f"equal to ref (exact), survivors {n_surv}/{q}, two calls "
                  f"equal, compact calls clean under set_sync_debug_mode('error')")
    check_compact_launches()


def check_compact_launches():
    """One K2 call launches exactly its one pass (a profiler trace of a
    warm call at chess's level-5 shape)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.fused_intersect import fused_intersect_compact
    from repro_torch.launch.kernel_timing import PAIR_SHAPES, pair_inputs
    p, w, q, nv = PAIR_SHAPES[1]
    bm, l, r, s, ms = pair_inputs(p, w, q, seed=3)
    fused_intersect_compact(bm, l, r, s, ms, nv, mode=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_intersect_compact(bm, l, r, s, ms, nv, mode=0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    require(len(names) == len(COMPACT_KERNELS) and
            all(any(k in n for n in names) for k in COMPACT_KERNELS),
            f"one fused_intersect_compact call launched {names}")
    print(f"check fused_intersect_compact P={p} W={w} Q={q}: one call runs "
          f"{len(names)} kernels ({', '.join(COMPACT_KERNELS)})")


def check_trimatrix():
    import torch
    from repro_torch.kernels.trimatrix import cooccurrence, trimatrix_ref
    from repro_torch.launch.kernel_timing import tri_inputs
    for n, w in TRI_SHAPES:
        bm = tri_inputs(n, w, seed=n + w)
        got = cooccurrence(bm)
        want = trimatrix_ref(bm)
        torch.cuda.synchronize()
        compare("trimatrix", got, want, f"trimatrix ({n}, {w})")
        print(f"check trimatrix N={n} W={w}: equal to ref (exact)")
    empty = cooccurrence(tri_inputs(0, 5, seed=0))
    require(tuple(empty.shape) == (0, 0), "trimatrix N=0 shape")
    print("check trimatrix N=0: empty (0, 0) result, no launch")


def run_end_to_end():
    import torch
    from repro_torch import kernels
    from repro_torch.core import EclatConfig, mine, support_checksum
    from repro_torch.data import generate

    launches = {name: 0 for name in MINING_KERNELS}
    for name, min_sup, variant, diffsets, expect in E2E_RUNS:
        if name not in DATA:
            t0 = time.perf_counter()
            DATA[name] = generate(name, scale=1.0, seed=0)
            print(f"e2e generate {name} scale=1.0 seed=0: "
                  f"{len(DATA[name][0])} txns in {time.perf_counter() - t0:.2f}s (host)")
        txns, spec = DATA[name]
        sums = {}
        for backend in ("fused", "ref"):
            cfg = EclatConfig(min_sup=min_sup, variant=variant,
                              use_diffsets=diffsets, backend=backend)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mine(txns, spec.n_items, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            sums[backend] = support_checksum(res.support_map())
            phases = {k: round(v, 4) for k, v in res.stats["phase_s"].items()}
            print(f"e2e mine {name} min_sup={min_sup} {variant}"
                  f"{' diffsets' if diffsets else ''} backend={backend} "
                  f"device={res.stats['device']}: levels={res.counts} "
                  f"total={res.total} checksum={sums[backend]} wall_s={wall:.4f} "
                  f"phase_s={phases} launches={counts}")
            if backend == "fused":
                require(res.stats["backend"] == "fused", "fused backend not used")
                for k in MAIN_PATH_MINING:
                    require(counts[k] > 0, f"{name} {variant}: kernel {k} was not launched")
                require(counts["fused_intersect"] == 0,
                        f"{name} {variant}: K1 launched on its own "
                        f"({counts['fused_intersect']} times); it runs inside K2's pass")
                for k in MINING_KERNELS:
                    launches[k] += counts[k]
                require(counts["flash_attention"] == counts["decode_attention"] == 0,
                        "the miner launched an attention kernel")
            else:
                require(all(v == 0 for v in counts.values()),
                        "the ref backend launched a CUDA kernel")
        require(sums["fused"] == expect,
                f"{name} {variant}: fused checksum {sums['fused']} != reference {expect}")
        require(sums["ref"] == expect,
                f"{name} {variant}: ref checksum {sums['ref']} != reference {expect}")
        print(f"e2e {name} {variant}: fused == ref == reference checksum {expect}")
    return launches


# the Apriori baseline (run_apriori): the E2E_RUNS datasets it races, by
# name, at the same thresholds; their pinned checksums are E2E_RUNS'
APRIORI_RUNS = ("T10I4D100K", "chess")


def _mine_launch_gates(what, res, counts):
    """The launches of one fused mine: K2 once per expansion, K4 once (the
    Phase-2 counts, when the tri-matrix ran), K1 never on its own, no
    other kernel."""
    n_exp = len(res.stats.get("pair_padding", {}).get("per_level", []))
    want_k4 = 1 if res.stats.get("tri_matrix") else 0
    require(counts["fused_intersect_compact"] == n_exp > 0,
            f"{what}: K2 launched {counts['fused_intersect_compact']} times for "
            f"{n_exp} expansions")
    require(counts["trimatrix"] == want_k4,
            f"{what}: K4 launched {counts['trimatrix']} times, expected {want_k4}")
    others = {k: v for k, v in counts.items()
              if v and k not in ("fused_intersect_compact", "trimatrix")}
    require(not others, f"{what}: launched {others}")


def run_apriori(launches):
    """The paper's Spark-Apriori baseline on the card: ``apriori_mine`` of
    T10I4D100K 0.01 and chess 0.7 at full scale on the pinned checksums,
    its horizontal database on the card and no kernel of the package
    launched (its containment product is ``torch.matmul``), timed per
    level beside the fused Eclat mine of the same data in this process: the
    paper's headline ratio on this card.  Then T10I4D100K through a FIMI
    file (``write_fimi``, ``load_fimi``) mined by both on the same
    checksum."""
    import shutil
    import tempfile
    import torch
    from repro_torch import kernels
    from repro_torch.core import (EclatConfig, apriori_mine, mine,
                                  support_checksum)
    from repro_torch.data import load_fimi, write_fimi

    pinned = {name: (min_sup, variant, expect)
              for name, min_sup, variant, diffsets, expect in E2E_RUNS
              if not diffsets}
    # cuBLAS's first call is set-up, not Apriori's work
    warm = torch.ones((64, 64), device="cuda")
    (warm @ warm).sum().item()
    for name in APRIORI_RUNS:
        min_sup, variant, expect = pinned[name]
        txns, spec = DATA[name]
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = apriori_mine(txns, spec.n_items, min_sup)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        csum = support_checksum(res.support_map)
        require(res.stats["device"].startswith("cuda"),
                f"apriori {name}: the horizontal database is on "
                f"{res.stats['device']}, not the card")
        require(not any(counts.values()),
                f"apriori {name}: launched a kernel of the package {counts}")
        require(csum == expect, f"apriori {name}: checksum {csum} != reference {expect}")
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ecl = mine(txns, spec.n_items, EclatConfig(min_sup=min_sup, variant=variant))
        torch.cuda.synchronize()
        ewall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        _mine_launch_gates(f"eclat {name}", ecl, counts)
        for k in MINING_KERNELS:
            launches[k] += counts[k]
        require(support_checksum(ecl.support_map()) == expect,
                f"eclat {name}: checksum differs from the reference")
        levels = [round(x, 4) for x in res.stats["level_s"]]
        print(f"e2e apriori {name} min_sup={min_sup} device={res.stats['device']}: "
              f"levels={res.counts} total={res.total} checksum={csum} "
              f"wall_s={wall:.4f} level_s={levels} launches=0; fused Eclat "
              f"{variant} wall_s={ewall:.4f} phase_s="
              f"{ {k: round(v, 4) for k, v in ecl.stats['phase_s'].items()} }; "
              f"Apriori / Eclat = {wall / ewall:.1f}x")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fimi-")
    try:
        min_sup, variant, expect = pinned["T10I4D100K"]
        path = os.path.join(tmp, "T10I4D100K.dat")
        t0 = time.perf_counter()
        write_fimi(path, DATA["T10I4D100K"][0])
        txns, n_items = load_fimi(path)
        io_s = time.perf_counter() - t0
        sums = {"apriori": support_checksum(apriori_mine(txns, n_items, min_sup).support_map),
                "eclat": support_checksum(mine(txns, n_items, EclatConfig(
                    min_sup=min_sup, variant=variant)).support_map())}
        require(sums == {"apriori": expect, "eclat": expect},
                f"FIMI round trip of T10I4D100K: {sums} != {expect}")
        print(f"e2e fimi T10I4D100K: write_fimi + load_fimi of {len(txns)} txns "
              f"({os.path.getsize(path)} bytes, n_items={n_items}) in {io_s:.2f}s "
              f"(host); apriori and fused Eclat of the file on {expect}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_window_plans(kind):
    """K1's and K3's window plans on the card: at each main-path class
    (``kerneltune.K1_SHAPES``, ``K3_SHAPES``) and edge shape
    (``WINDOW_EDGES``; K3 also on the 26-word slices of a 101-word frontier
    cut over 4 shards) every plan of ``autotune.window_candidates``, the
    library's report of it (``window_plan_check``) equal to the Python
    mirror's, and K1 (with and without its (Q, W) store) or K3 (with and
    without its (Q, Ws) store) under it exactly equal to the plain version
    in every mode; then each plan of ``WINDOW_REFUSED`` refused by the
    mirror and by the library with the same text, and by a launch of
    either kernel, which launches nothing.  Returns the kernel calls
    checked."""
    import torch
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels.fused_intersect import (
        fused_intersect_pairs, fused_intersect_partial_pairs,
        fused_intersect_partial_ref, fused_intersect_ref, fused_support_pairs)
    from repro_torch.kernels.fused_intersect.fused_intersect import (
        cuda_window_plan, window_plan)
    from repro_torch.launch import kerneltune
    from repro_torch.launch.kernel_timing import class_pair_inputs, pair_inputs

    def inputs(p, w, q, family, seed):
        if family == "class":
            sizes = [p] if p <= 75 else None   # a ring's level 2: one class
            return class_pair_inputs(p, w, q, q - q // 10, seed, sizes=sizes)
        return pair_inputs(p, w, q, seed=seed)

    cases = ([("K1", label, p, w, q, "class") for label, p, w, q in kerneltune.K1_SHAPES]
             + [("K3", label, p, w, q, "class") for label, p, w, q in kerneltune.K3_SHAPES]
             + [(k, label, p, w, q, fam) for label, p, w, q, fam in WINDOW_EDGES
                for k in ("K1", "K3")])
    n_checks = 0
    for kernel, label, p, w, q, family in cases:
        bm, l, r, s, ms = inputs(p, w, q, family, seed=p + w + q)
        plans = at.window_candidates(q, w, kind)
        for plan in plans:
            lib = cuda_window_plan(q, w, plan[:3])
            require(lib == window_plan(q, w, plan[:3]) == plan,
                    f"{kernel} {label}: plan {tuple(plan)}: the library reports {lib}")
        for mode in (0, 1, 2):
            if kernel == "K1":
                want = fused_intersect_ref(bm, l, r, s, ms, mode=mode)
            else:
                want = fused_intersect_partial_ref(bm, l, r, mode=mode)
            for plan in plans:
                what = f"{kernel} {label} plan {tuple(plan[:3])} mode {mode}"
                if kernel == "K1":
                    got = fused_intersect_pairs(bm, l, r, s, ms, mode=mode, plan=plan[:3])
                    free = fused_support_pairs(bm, l, r, s, ms, mode=mode, plan=plan[:3])
                    torch.cuda.synchronize()
                    for g, e, part in zip((*got, *free), (*want, *want[1:]),
                                          ("inter", "sup", "mask", "sup (no store)",
                                           "mask (no store)")):
                        compare("fused_intersect", g, e, f"{what}: {part}")
                else:
                    got = fused_intersect_partial_pairs(bm, l, r, mode=mode, plan=plan[:3])
                    _, pop = fused_intersect_partial_pairs(bm, l, r, mode=mode,
                                                           store=False, plan=plan[:3])
                    torch.cuda.synchronize()
                    for g, e, part in zip((*got, pop), (*want, want[1]),
                                          ("inter", "pop", "pop (no store)")):
                        compare("fused_intersect_partial", g, e, f"{what}: {part}")
                n_checks += 2
        print(f"check {kernel} plans {[tuple(p[:3]) for p in plans]} at {label} "
              f"P={p} W={w} Q={q} ({family} pairs): library plan == mirror, with and "
              f"without store, modes 0-2, equal to ref (exact)")
    # K3 on the slices of a frontier whose width the shards do not divide
    p, w, q, n = 300, 101, 1001, 4
    full, l, r, _, _ = class_pair_inputs(p, w, q, q - q // 10, seed=5)
    ws = -(-w // n)
    padded = torch.nn.functional.pad(full, (0, ws * n - w))
    for i in (0, n - 1):
        part = padded[:, i * ws:(i + 1) * ws].contiguous()
        plans = at.window_candidates(q, ws, kind)
        for mode in (0, 1, 2):
            want = fused_intersect_partial_ref(part, l, r, mode=mode)
            for plan in plans:
                got = fused_intersect_partial_pairs(part, l, r, mode=mode, plan=plan[:3])
                torch.cuda.synchronize()
                for g, e, what in zip(got, want, ("inter", "pop")):
                    compare("fused_intersect_partial", g, e,
                            f"K3 W={w} slice {i}/{n} plan {tuple(plan[:3])} mode {mode}: {what}")
                n_checks += 1
        print(f"check K3 plans {[tuple(p[:3]) for p in plans]} on slice {i} of "
              f"{n} (Ws={ws} of W={w}): equal to ref (exact)")
    # refused plans: a ValueError from the mirror, the library and a launch
    bm, l, r, s, ms = pair_inputs(40, 100, 50, seed=1)
    for w, plan in WINDOW_REFUSED:
        msgs = {}
        for where, fn in (("mirror", lambda: window_plan(50, w, plan)),
                          ("library", lambda: cuda_window_plan(50, w, plan))):
            try:
                fn()
            except ValueError as e:
                msgs[where] = msg = str(e)
            else:
                raise SmokeFailure(f"plan {plan} at W={w}: the {where} took it")
        require(msgs["mirror"] == msgs["library"],
                f"plan {plan} at W={w}: the mirror says {msgs['mirror']!r}, the "
                f"library {msgs['library']!r}")
        wide = bm if w == 100 else pair_inputs(40, w, 50, seed=2)[0]
        before = (fused_intersect_pairs.launches, fused_intersect_partial_pairs.launches)
        for name, fn in (("K1", lambda: fused_intersect_pairs(wide, l, r, s, ms, mode=0,
                                                              plan=plan)),
                         ("K3", lambda: fused_intersect_partial_pairs(wide, l, r, mode=0,
                                                                      plan=plan))):
            try:
                fn()
            except ValueError:
                pass
            else:
                raise SmokeFailure(f"plan {plan} at W={w}: {name} launched it")
        require(before == (fused_intersect_pairs.launches,
                           fused_intersect_partial_pairs.launches),
                f"plan {plan} at W={w}: a refused launch was counted")
        print(f"check refused plan {plan} at W={w}: mirror, library, K1 and K3 "
              f"raise ValueError ({msg.split(': ', 1)[-1]})")
    return n_checks


def run_autotune(launches, empty_cache):
    """Tile selection and dispatch on the card, in a temporary directory:
    (a) every K2 lanes candidate (8, 16, 32: 128-, 64- and 8-pair tiles)
    exactly against the plain version at the main path's K2 shapes and at
    edge shapes (pad tails, Q not a multiple of a tile, W % 4 != 0), both
    front ends, all modes; every K4 split candidate exactly against the
    plain version at the main path's K4 shapes; every K1 and K3 window
    plan (``check_window_plans``);
    (b) ``launch.kerneltune.sweep``: ``tune_shape`` at each shape class
    (device ms of every candidate, the pick, the default's ms), the
    ref-vs-fused crossover table and the mines with tuned against default
    tiles;
    (c) mines of T10I4D100K and chess with ``autotune=True`` (tuning the
    misses, then again with the table warm), with each ``block_w``
    candidate and with ``backend="auto"`` reading the sweep's table, all on
    the pinned checksums with the launch gates (the tuner's own launches
    counted apart, in ``autotune.launches``);
    (d) the chess stream with ``StreamConfig(autotune=True)``, every slide
    on ``STREAM_CHECKSUMS`` with the stream's launch gates; then the
    ``compact=False`` mines (``_window_mines``) and the mesh runs with
    ``autotune=True`` (``_window_mesh_runs``).  The sweep prints a timing
    line per K1 and K3 class: the tuned plan's device ms against the
    rule's and the bound.  Then the process's table is ``empty_cache``
    again."""
    import shutil
    import tempfile
    import torch
    from repro_torch import kernels
    from repro_torch.core import EclatConfig, mine, support_checksum
    from repro_torch.data import stream_spec
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels.fused_intersect import (
        COMPACT_LANES, compact_survivors_pairs,
        compact_survivors_ref, fused_intersect_compact_pairs,
        fused_intersect_compact_ref)
    from repro_torch.kernels.fused_intersect.fused_intersect import (
        compact_shape, cuda_compact_shape)
    from repro_torch.kernels.trimatrix import (plan_for, split_plan, trimatrix,
                                               trimatrix_ref)
    from repro_torch.launch import kerneltune
    from repro_torch.launch.kerneltune import use_tables
    from repro_torch.launch.kernel_timing import (class_pair_inputs,
                                                  pair_inputs, tri_inputs)
    from repro_torch.launch.stream_profile import STREAMS
    from repro_torch.streaming import StreamConfig, StreamingMiner

    kind = at.device_kind("cuda")
    # K2's geometry: the library's Shape<G> against the binding's copy, which
    # the cost model reads
    for g in COMPACT_LANES:
        for w in (100, 7):
            lib_shape = cuda_compact_shape(g, w)
            require(lib_shape[:5] == compact_shape(g),
                    f"K2 at {g} lanes: the library's geometry {lib_shape[:5]}, "
                    f"the binding's {compact_shape(g)}")
        print(f"check K2 geometry at {g} lanes (lanes, tile pairs, pairs a "
              f"group, in flight, blocks/SM fused, given): {lib_shape}")
    # (a) K2: the main path's shapes with a 10% pad tail, class-ordered
    # where the miner's are; edge shapes with random pairs
    cases = [(f"{label}: P={p} W={w} Q={q} n_valid={q - q // 10}", p, w, q,
              q - q // 10, "class" if "level 5" in label else "random")
             for label, p, w, q in kerneltune.K2_SHAPES]
    cases += [("W=7 (V=1) Q=300 n_valid=250", 40, 7, 300, 250, "random"),
              ("Q=129 W=100 (one past a 128-pair tile)", 30, 100, 129, 129, "random"),
              ("Q=65 W=100 (one past a 64-pair tile)", 30, 100, 65, 61, "random"),
              ("Q=9 W=3125 (one past an 8-pair tile)", 10, 3125, 9, 9, "random"),
              ("Q=12289 W=33 n_valid=8200 (many tiles)", 100, 33, 12289, 8200, "random"),
              ("Q=1 W=9", 5, 9, 1, 1, "random")]
    n_checks = 0
    for label, p, w, q, nv, family in cases:
        for mode in (0, 1, 2):
            seed = p + w + q + mode
            if family == "class":
                bm, l, r, s, ms = class_pair_inputs(p, w, q, nv, seed)
            else:
                bm, l, r, s, ms = pair_inputs(p, w, q, seed=seed)
            want = fused_intersect_compact_ref(bm, l, r, s, ms, nv, mode=mode)
            mask = want[2].clone()
            mask[nv:] = 1   # pad pairs flagged: the front end must clear them
            want_given = compact_survivors_ref(bm, l, r, mask, nv, mode=mode)
            for g in COMPACT_LANES:
                got = fused_intersect_compact_pairs(bm, l, r, s, ms, nv, mode=mode,
                                                    lanes=g)
                given = compact_survivors_pairs(bm, l, r, mask.clone(), nv,
                                                mode=mode, lanes=g)
                torch.cuda.synchronize()
                for a, e, what in zip(got, want, ("compact", "sup", "mask", "n_surv")):
                    compare("fused_intersect_compact", a, e,
                            f"K2 lanes={g} {label} mode {mode}: {what}")
                for a, e, what in zip(given, want_given, ("compact", "mask", "n_surv")):
                    compare("fused_intersect_compact", a, e,
                            f"K2 given mask lanes={g} {label} mode {mode}: {what}")
                n_checks += 2
        print(f"check K2 lanes {list(COMPACT_LANES)} {label}: both front ends, "
              f"modes 0-2, equal to ref (exact)")
    # K4: every split candidate at the main path's shapes
    for label, n, w in kerneltune.K4_SHAPES:
        bm = tri_inputs(n, w, seed=n * 3 + w)
        want = trimatrix_ref(bm)
        splits = at.split_candidates(n, w, kind)
        for sp in splits:
            got = trimatrix(bm, plan=plan_for(w, sp))
            torch.cuda.synchronize()
            compare("trimatrix", got, want, f"K4 {label} ({n}, {w}) split {sp}")
            n_checks += 1
        print(f"check K4 {label} N={n} W={w}: splits {splits} (split_plan "
              f"{split_plan(n, w)}) equal to ref (exact)")
    t_plans = time.perf_counter()
    n_checks += check_window_plans(kind)
    print(f"check autotune candidates: {n_checks} kernel calls equal to their "
          f"plain versions; K1/K3 plans {time.perf_counter() - t_plans:.1f}s")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune-")
    cache = os.path.join(tmp, "autotune.json")
    table = os.path.join(tmp, "BENCH_torch_kerneltune.json")
    try:
        # (b) the sweep
        use_tables(cache)
        t0 = time.perf_counter()
        tuner_before = at.launches
        report = kerneltune.sweep(DATA, cache, reps=20, repeats=2)
        with open(table, "w") as f:
            json.dump(report, f)
        for rec in report["shapes"]:
            cands = {c: round(v, 4) for c, v in rec["candidates"].items()}
            print(f"tune {rec['kernel']} {rec['label']} q={rec['q']} w={rec['w']} "
                  f"rows={rec['rows']}: device ms {cands}; pick {rec['tuned']} "
                  f"{rec['ms']:.4f} ms, default {rec['default']} "
                  f"{rec['default_ms']:.4f} ms, model's pick {rec['model_pick']}")
            if rec["kernel"] in at.WINDOW_KERNELS:
                # (d) the tuned plan against the rule and the bound: each of
                # the class's rows read once, the pair indices, the outputs
                p, q, w = rec["rows"], rec["q"], rec["w"]
                out = (q * w * 4 if rec["store"] else 0) + (2 if rec["kernel"] == "pairs" else 1) * q * 4
                bms, by = bound(p * w * 4 + 2 * q * 4 + out, q * w * 32)
                k = "K1" if rec["kernel"] == "pairs" else "K3"
                print(f"timing {k} plan {rec['label']} P={p} W={w} Q={q} "
                      f"{'with' if rec['store'] else 'without'} store, class-ordered "
                      f"pairs: tuned {tuple(rec['tuned'])} {rec['ms']:.5f} ms, rule "
                      f"{tuple(rec['default'])} {rec['default_ms']:.5f} ms, bound "
                      f"{bms:.5f} ms ({by}); tuned/rule {rec['ms'] / rec['default_ms']:.3f}")
            entry = at.load_table().entries.get(rec["key"], {})
            require(at.KernelConfig.from_dict(entry) == at.KernelConfig.from_dict(rec["config"])
                    and entry.get("measured_ms") == rec["ms"]
                    and entry.get("clock") == "cuda_events",
                    f"tune {rec['key']}: the table holds {entry}, the sweep "
                    f"picked {rec['config']} in {rec['ms']} ms")
        for cell in report["crossover"]:
            print(f"crossover q={cell['q']} w={cell['w']}: expand ms "
                  f"{ {k: round(v, 4) for k, v in cell['steady_ms'].items()} } "
                  f"best_single={cell['best_single']} best_mesh={cell['best_mesh']}")
        for row in report["tuned_vs_default"]:
            print(f"tuned vs default mine {row['dataset']} {row['min_sup']} "
                  f"{row['variant']}: wall_s default {row['default_wall_s']:.4f} "
                  f"tuned {row['tuned_wall_s']:.4f}; bottom_up default "
                  f"{row['default_phase_s'].get('bottom_up', 0):.4f} tuned "
                  f"{row['tuned_phase_s'].get('bottom_up', 0):.4f}; tri_matrix "
                  f"default {row['default_phase_s'].get('tri_matrix', 0):.4f} "
                  f"tuned {row['tuned_phase_s'].get('tri_matrix', 0):.4f}; "
                  f"checksum {row['checksum']} on both")
        print(f"e2e kerneltune sweep on {report['nvidia_smi']}: "
              f"{len(report['shapes'])} shape classes, "
              f"{len(report['crossover'])} crossover cells in "
              f"{time.perf_counter() - t0:.1f}s, {at.launches - tuner_before} "
              f"tuner launches")

        # (c) the mines
        use_tables(cache, table)
        pinned = {name: (min_sup, variant, expect)
                  for name, min_sup, variant, diffsets, expect in E2E_RUNS
                  if not diffsets}
        for name in APRIORI_RUNS:
            min_sup, variant, expect = pinned[name]
            txns, spec = DATA[name]
            base = EclatConfig(min_sup=min_sup, variant=variant)
            w = mine(txns, spec.n_items, base).stats["n_words"]
            arms = [("autotune=True (tuning the misses)", dict(autotune=True), False),
                    ("autotune=True, table warm", dict(autotune=True), True)]
            arms += [(f"block_w={bw}", dict(block_w=bw), True)
                     for bw in at.kernel_block_ws(w)]
            arms += [("backend=auto", dict(backend="auto"), True)]
            for label, kw, gated in arms:
                cfg = dataclasses.replace(base, **kw)
                tuner_before = at.launches
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = mine(txns, spec.n_items, cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = kernels.launch_counts()
                csum = support_checksum(res.support_map())
                tuned = at.launches - tuner_before
                require(csum == expect, f"{name} {label}: checksum {csum} != {expect}")
                if gated:
                    require(tuned == 0, f"{name} {label}: tuned with a warm table")
                # every arm runs the kernels: on the card auto never picks ref
                require(res.stats["backend"] == "fused",
                        f"{name} {label}: backend {res.stats['backend']}, not fused")
                _mine_launch_gates(f"{name} {label}", res, counts)
                for k in MINING_KERNELS:
                    launches[k] += counts[k]
                if kw.get("backend") == "auto":
                    require(res.stats["dispatch"]["policy"] == table,
                            f"{name} {label}: dispatch {res.stats['dispatch']}")
                print(f"e2e mine {name} min_sup={min_sup} {variant} {label}: "
                      f"backend={res.stats['backend']} checksum={csum} "
                      f"wall_s={wall:.4f} launches="
                      f"{ {k: v for k, v in counts.items() if v} } tuner launches "
                      f"{tuned}")

        # (d) the autotuned chess stream
        name, n_blocks, block_txns, min_sup, n_batches, drift = next(
            st for st in STREAMS if st[0] == "chess")
        miner = StreamingMiner(stream_spec(name).n_items,
                               StreamConfig(min_sup=min_sup, n_blocks=n_blocks,
                                            block_txns=block_txns, autotune=True))
        tuner_before = at.launches
        slides = []
        for i, batch in enumerate(STREAM_BATCHES[name]):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            miner.push(batch)
            torch.cuda.synchronize()
            push_s = time.perf_counter() - t0
            push_l = kernels.launch_counts()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = miner.mine_window()
            torch.cuda.synchronize()
            slide_s = push_s + time.perf_counter() - t0
            mine_l = kernels.launch_counts()
            n_exp = len(res.stats.get("pair_padding", {}).get("per_level", []))
            level2 = res.counts[1] if len(res.counts) > 1 else 0
            _stream_slide_checks(f"autotuned stream {name}", i, n_blocks, push_l,
                                 mine_l, n_exp, level2)
            for k in launches:
                launches[k] += push_l[k] + mine_l[k]
            csum = support_checksum(res.support_map())
            require(csum == STREAM_CHECKSUMS[name][i],
                    f"autotuned stream {name} slide {i}: checksum {csum} != "
                    f"reference {STREAM_CHECKSUMS[name][i]}")
            slides.append(slide_s)
        entry = at.load_table().get(at.shape_class("trimatrix", 75, 16, 0, kind))
        print(f"e2e stream {name} autotune=True: {len(slides)} slides on the "
              f"pinned checksums with the launch gates; slide_s first "
              f"{slides[0]:.4f} (tuning), median of the rest "
              f"{sorted(slides[1:])[len(slides[1:]) // 2]:.4f}; "
              f"{at.launches - tuner_before} tuner launches; K4 (75, 16) split "
              f"{entry.split if entry else None}")
        t0 = time.perf_counter()
        _window_mines(launches, pinned, kind)
        print(f"phase run_autotune compact=False mines: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        _window_mesh_runs(launches)
        print(f"phase run_autotune mesh autotune runs: {time.perf_counter() - t0:.1f}s")
    finally:
        use_tables(empty_cache)
        shutil.rmtree(tmp, ignore_errors=True)


def _window_mines(launches, pinned, kind):
    """(b) of run_autotune: ``compact=False`` mines of T10I4D100K and chess
    with ``autotune=True`` (tuning the misses, then with the table warm) and
    with each ``block_w`` that names a chunk candidate of the dataset's K1
    class (``WINDOW_MINE_CLASS``), on the pinned checksums: K1 once an
    expansion, K2 never, K4 once, the tuner's launches counted apart (none
    with the table warm or a ``block_w``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import EclatConfig, mine, support_checksum
    from repro_torch.kernels import autotune as at
    for name in APRIORI_RUNS:
        min_sup, variant, expect = pinned[name]
        txns, spec = DATA[name]
        base = EclatConfig(min_sup=min_sup, variant=variant, compact=False)
        q, w = WINDOW_MINE_CLASS[name]
        arms = [("compact=False autotune=True (tuning the misses)", dict(autotune=True), False),
                ("compact=False autotune=True, table warm", dict(autotune=True), True)]
        arms += [(f"compact=False block_w={bw}", dict(block_w=bw), True)
                 for bw in at.window_chunk_candidates(q, w, kind)]
        for label, kw, gated in arms:
            cfg = dataclasses.replace(base, **kw)
            tuner_before = at.launches
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mine(txns, spec.n_items, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            csum = support_checksum(res.support_map())
            tuned = at.launches - tuner_before
            n_exp = len(res.stats["pair_padding"]["per_level"])
            require(csum == expect, f"{name} {label}: checksum {csum} != {expect}")
            if gated:
                require(tuned == 0, f"{name} {label}: tuned {tuned} launches with a "
                                    f"warm table or a named plan")
            require(counts["fused_intersect"] == n_exp > 0 and
                    counts["fused_intersect_compact"] == 0,
                    f"{name} {label}: K1 {counts['fused_intersect']}, K2 "
                    f"{counts['fused_intersect_compact']} launches for {n_exp} expansions")
            want_k4 = 1 if res.stats.get("tri_matrix") else 0
            others = {k: v for k, v in counts.items()
                      if v and k not in ("fused_intersect", "trimatrix")}
            require(counts["trimatrix"] == want_k4 and not others,
                    f"{name} {label}: launched {counts}")
            for k in MINING_KERNELS:
                launches[k] += counts[k]
            print(f"e2e mine {name} min_sup={min_sup} {variant} {label}: "
                  f"checksum={csum} wall_s={wall:.4f} launches="
                  f"{ {k: v for k, v in counts.items() if v} } tuner launches {tuned}")
    plans = {k: v.get("plan") for k, v in at.load_table().entries.items()
             if k.startswith("pairs_")}
    require(plans, "the compact=False mines tuned no K1 class")
    print(f"e2e compact=False tuned K1 classes: {plans}")


def _window_mesh_runs(launches):
    """(c) of run_autotune: a tidsharded 1x4 chess mine and the chess stream
    (tidsharded 1x4) with ``autotune=True`` on 4 gloo ranks sharing the card,
    each rank tuning K3 and K2 at its own slice with no collective: the
    pinned checksums, the launch gates of ``_check_mesh_run`` and
    ``_check_mesh_stream``, the tuner's launches counted apart."""
    from repro_torch.data import stream_spec
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.mesh_runs import run_jobs
    from repro_torch.launch.stream_profile import STREAMS
    name, min_sup, variant, diffsets, expect = E2E_RUNS[1]
    txns, spec = DATA[name]
    mine_job = dict(kind="mine", txns=txns, n_items=spec.n_items, grid=None,
                    label="tidsharded 1x4 autotune=True", expect=expect,
                    run=f"{name} min_sup={min_sup} {variant}",
                    config=dict(min_sup=min_sup, variant=variant, backend="fused",
                                shard="words", autotune=True))
    _, n_blocks, block_txns, s_min_sup, _, _ = next(st for st in STREAMS
                                                    if st[0] == "chess")
    stream_job = dict(kind="stream", batches=STREAM_BATCHES["chess"],
                      n_items=stream_spec("chess").n_items, grid=None,
                      label="tidsharded 1x4 autotune=True", name="chess",
                      n_blocks=n_blocks,
                      config=dict(min_sup=s_min_sup, n_blocks=n_blocks,
                                  block_txns=block_txns, backend="fused",
                                  shard="words", autotune=True))
    per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cuda",
                         args=([mine_job, stream_job],), timeout=600)
    _check_mesh_run(mine_job, [r[0] for r in per_rank], 4,
                    "gloo, 4 ranks sharing the card")
    _check_mesh_stream(stream_job, [r[1] for r in per_rank], {})
    tuners = [(r[0].get("tuner_launches"), r[1].get("tuner_launches")) for r in per_rank]
    require(all(m > 0 and st >= 0 for m, st in tuners),
            f"mesh autotune runs: tuner launches by rank (mine, stream) {tuners}")
    for k in MINING_KERNELS + ("fused_intersect_partial",):
        if k in launches:
            launches[k] += per_rank[0][0]["launches"][k]
    print(f"e2e mesh autotune=True on 4 gloo ranks: chess tidsharded mine and "
          f"chess stream on the pinned checksums with the launch gates; tuner "
          f"launches by rank (mine, stream) {tuners}, none counted as the "
          f"kernels' own")


def check_partial_kernel():
    """K3 against its plain version, exact: the shapes the word-sharded
    mines give it at 1, 2 and 4 word shards, a frontier whose W is no multiple of the shard count cut
    into its slices, Q = 0 and Q = 1; every mode, with and without the
    (Q, Ws) store.  Then the survivor compaction from a mask computed
    outside (the word-sharded backends' path) against its plain version."""
    import torch
    from repro_torch.kernels.fused_intersect import (
        compact_survivors, compact_survivors_ref, fused_intersect_partial,
        fused_intersect_partial_ref)
    from repro_torch.launch.kernel_timing import class_pair_inputs, pair_inputs

    def check(label, bm, l, r):
        pops = {}
        for mode in (0, 1, 2):
            want_inter, want_pop = fused_intersect_partial_ref(bm, l, r, mode=mode)
            pops[mode] = want_pop
            inter, pop = fused_intersect_partial(bm, l, r, mode=mode)
            none, pop2 = fused_intersect_partial(bm, l, r, mode=mode, store=False)
            torch.cuda.synchronize()
            require(none is None, f"{label}: store=False returned intersections")
            compare("fused_intersect_partial", inter, want_inter,
                    f"fused_intersect_partial {label} mode {mode}: inter")
            compare("fused_intersect_partial", pop, want_pop,
                    f"fused_intersect_partial {label} mode {mode}: pop")
            compare("fused_intersect_partial", pop2, want_pop,
                    f"fused_intersect_partial without store {label} mode {mode}: pop")
        return pops

    for p, ws, q in PARTIAL_CHECKED:
        # class-ordered pairs with a (0, 0) pad tail, as the miner gives them
        nv = q - q // 16
        bm, l, r, _, _ = class_pair_inputs(p, ws, q, nv, seed=p + ws)
        check(f"class-ordered P={p} Ws={ws} Q={q} n_valid={nv}", bm, l, r)
        bm, l, r, _, _ = pair_inputs(p, ws, q, seed=p + ws + q)
        check(f"P={p} Ws={ws} Q={q}", bm, l, r)
        # the compaction after the reduce: threshold at the median count
        _, pop = fused_intersect_partial_ref(bm, l, r, mode=0)
        mask = (pop >= pop.float().median()).to(torch.int32)
        nv = q - q // 10
        got = compact_survivors(bm, l, r, mask.clone(), nv, mode=1)
        want = compact_survivors_ref(bm, l, r, mask.clone(), nv, mode=1)
        torch.cuda.synchronize()
        for g, e, what in zip(got, want, ("compact", "mask", "n_surv")):
            compare("fused_intersect_compact", g, e,
                    f"compact_survivors P={p} Ws={ws} Q={q}: {what}")
        print(f"check fused_intersect_partial P={p} Ws={ws} Q={q} modes 0-2, "
              f"with and without store, class-ordered with a pad tail and "
              f"random: equal to ref (exact); compact_survivors "
              f"from the reduced mask: equal to ref, {int(got[2])} survivors")
    # W = 101 over 4 shards: slices of 26 words, the last ending in 3 pad words
    p, w, q, n = 300, 101, 5000, 4
    full, l, r, _, _ = pair_inputs(p, w, q, seed=7)
    ws = -(-w // n)
    padded = torch.nn.functional.pad(full, (0, ws * n - w))
    slices = [check(f"W={w} slice {i}/{n} (Ws={ws})",
                    padded[:, i * ws:(i + 1) * ws].contiguous(), l, r)
              for i in range(n)]
    for mode in (0, 1, 2):
        _, whole = fused_intersect_partial_ref(full, l, r, mode=mode)
        require(torch.equal(sum(s[mode] for s in slices), whole),
                f"W={w}: slice counts do not sum to the whole rows' (mode {mode})")
    print(f"check fused_intersect_partial W={w} cut into {n} slices of {ws} "
          f"words: every slice equal to ref, slice counts sum to the whole rows'")
    for q in (0, 1):
        bm, l, r, _, _ = pair_inputs(40, 25, q, seed=q)
        check(f"Q={q}", bm, l, r)
        print(f"check fused_intersect_partial Q={q}: equal to ref (exact)")
    # one class of 600 rows at every chess slice width: wider than K3's
    # window, staged and gathered rows in one launch
    for ws in (25, 50, 100):
        bm, l, r, _, _ = class_pair_inputs(600, ws, 179700, 179700, seed=ws, sizes=[600])
        check(f"one class of 600 rows Ws={ws}", bm, l, r)
        print(f"check fused_intersect_partial one class of 600 rows Ws={ws} modes 0-2, "
              f"with and without store: equal to ref (exact)")


def check_miner_pairs():
    """K1 and K3 against their plain versions, exact, on the pair lists of
    the largest expansion of the port's fused mines of chess and
    T10I4D100K (class-ordered, with the pad tail of their rung), every mode,
    with and without the store; K3 on rank 0's word slice at 4 shards.
    Returns the recordings, which the timing phase times."""
    import torch
    from repro_torch.kernels.fused_intersect import (
        fused_intersect, fused_intersect_partial, fused_intersect_partial_ref,
        fused_intersect_ref, fused_support_pairs)
    from repro_torch.kernels.fused_intersect.fused_intersect import window_plan
    from repro_torch.launch.kernel_timing import (rank0_slice, recorded_miner_inputs,
                                                  window_rows)
    miner = recorded_miner_inputs(DATA)
    require(any(rec["label"] == MINER_CHESS for rec in miner),
            f"the chess mine's largest expansion is not {MINER_CHESS!r}: "
            f"{[rec['label'] for rec in miner]}")
    for rec in miner:
        bm, l, r, s, ms = (rec[k] for k in ("bitmaps", "left", "right", "sup_left", "min_sup"))
        part = rank0_slice(bm)
        for mode in (0, 1, 2):
            want = fused_intersect_ref(bm, l, r, s, ms, mode=mode)
            got = fused_intersect(bm, l, r, s, ms, mode=mode)
            free = fused_support_pairs(bm, l, r, s, ms, mode=mode)
            want_p = fused_intersect_partial_ref(part, l, r, mode=mode)
            got_p = fused_intersect_partial(part, l, r, mode=mode)
            _, pop = fused_intersect_partial(part, l, r, mode=mode, store=False)
            torch.cuda.synchronize()
            for g, e, what in zip(got, want, ("inter", "sup", "mask")):
                compare("fused_intersect", g, e, f"fused_intersect {rec['label']} mode {mode}: {what}")
            for g, e, what in zip(free, want[1:], ("sup", "mask")):
                compare("fused_intersect", g, e,
                        f"fused_intersect without store {rec['label']} mode {mode}: {what}")
            for g, e, what in zip((*got_p, pop), (*want_p, want_p[1]), ("inter", "pop", "pop")):
                compare("fused_intersect_partial", g, e,
                        f"fused_intersect_partial {rec['label']} Ws={part.shape[1]} mode {mode}: {what}")
        print(f"check fused_intersect and fused_intersect_partial (Ws={part.shape[1]}) on "
              f"{rec['label']} (min_sup {ms}) modes 0-2, with and without store: "
              f"equal to ref (exact)")
        # the rows the windows stage for the valid pairs, at K1/K3's plan and
        # at 256-pair tiles (the tiles a staged K2 would take)
        nv = rec["n_valid"]
        plan = window_plan(l.shape[0], bm.shape[1])
        for tile, rows in sorted({(plan.tile, plan.rows), (256, 256)}):
            staged, largest, outside = window_rows(l[:nv].cpu().numpy(),
                                                   r[:nv].cpu().numpy(), tile, rows)
            print(f"windows of {rec['label']} at {tile}-pair tiles and {rows}-row "
                  f"windows: {staged} rows staged, largest window {largest} rows, "
                  f"{outside} operands read outside a window; gathered row by row: "
                  f"{2 * nv} rows")
    return miner


def check_popcount_support():
    import numpy as np
    import torch
    from repro_torch.device import words_from_numpy
    from repro_torch.kernels.popcount_support import (intersect_support,
                                                      popcount_support_ref)
    for m, w in PS_SHAPES + [(1, 1), (0, 5), (7, 33), (1000, 101)]:
        rng = np.random.default_rng(m + w)
        a = words_from_numpy(rng.integers(0, 2**32, (m, w), dtype=np.uint32), "cuda")
        b = words_from_numpy(rng.integers(0, 2**32, (m, w), dtype=np.uint32), "cuda")
        got = intersect_support(a, b)
        want = popcount_support_ref(a, b)
        torch.cuda.synchronize()
        for g, e, what in zip(got, want, ("inter", "support")):
            compare("popcount_support", g, e, f"popcount_support M={m} W={w}: {what}")
        print(f"check popcount_support M={m} W={w}: equal to ref (exact)")


def _mesh_jobs(runs, data):
    """mine jobs of the E2E datasets under each (label, backend, shard,
    grid) of ``runs``."""
    jobs = []
    for label, backend, shard, grid in runs:
        for name, min_sup, variant, diffsets, expect in E2E_RUNS:
            txns, spec = data[name]
            jobs.append(dict(kind="mine", txns=txns, n_items=spec.n_items,
                             grid=grid, label=label, expect=expect,
                             run=f"{name} min_sup={min_sup} {variant}"
                                 f"{' diffsets' if diffsets else ''}",
                             config=dict(min_sup=min_sup, variant=variant,
                                         use_diffsets=diffsets,
                                         backend=backend, shard=shard)))
    return jobs


def _check_mesh_run(job, per_rank, n_data, topology):
    """Every rank's result of one mesh mine: the pinned checksum, K3 (none
    for sharded) and K2 once per expand, K1 never on its own, this rank's
    frontier slice, the collectives per expand.  Prints one line per
    rank."""
    import math
    what = f"mesh mine {job['run']} {job['label']} ({topology})"
    for rank, res in enumerate(per_rank):
        require("error" not in res, f"{what}: rank {rank} refused: {res.get('error')}")
        st = res["stats"]
        backend = st["backend"]
        n_exp = res["n_expands"]
        lev = st["collectives"]["levels"]
        per_exp = {axis: {op: {k: v / max(n_exp, 1) for k, v in c.items()}
                          for op, c in ops.items()} for axis, ops in lev.items()}
        k = "fused_intersect_partial"
        launches = res["launches"]
        print(f"e2e {what} rank {rank}: backend={backend} checksum={res['checksum']} "
              f"levels={res['counts']} expands={n_exp} {k}_launches={launches[k]} "
              f"compact_launches={launches['fused_intersect_compact']} "
              f"fused_intersect_launches={launches['fused_intersect']} "
              f"frontier_words={st.get('frontier_words')} (W={st['n_words']}) "
              f"collectives_per_expand={per_exp} vertical={st['collectives']['vertical']} "
              f"wall_s={res['wall_s'][-1]:.4f} "
              f"phase_s={ {p: round(v, 4) for p, v in st['phase_s'].items()} }")
        require(res["checksum"] == job["expect"],
                f"{what} rank {rank}: checksum {res['checksum']} != {job['expect']}")
        want_k3 = 0 if backend == "sharded" else n_exp
        require(n_exp > 0 and launches[k] == want_k3,
                f"{what} rank {rank}: {k} launched {launches[k]} times for {n_exp} expands")
        require(launches["fused_intersect"] == 0,
                f"{what} rank {rank}: K1 launched on its own; it runs inside K2's pass")
        require(launches["fused_intersect_compact"] == n_exp,
                f"{what} rank {rank}: survivor compaction launched "
                f"{launches['fused_intersect_compact']} times for {n_exp} expands")
        require(launches["trimatrix"] > 0, f"{what} rank {rank}: Phase 2 not on K4")
        if backend in ("tidsharded", "grid"):
            require(st["frontier_words"] == math.ceil(st["n_words"] / n_data),
                    f"{what} rank {rank}: frontier slice of {st['frontier_words']} words")
            red = lev.get("data", {}).get("all_reduce", {}).get("calls")
            require(red == n_exp, f"{what} rank {rank}: {red} all-reduces over "
                                  f"data for {n_exp} expands")
        if backend == "tidsharded":
            require(set(lev) == {"data"} and set(lev["data"]) == {"all_reduce"},
                    f"{what} rank {rank}: collectives beyond the one all-reduce: {lev}")
        if backend == "sharded":
            require(all("all_reduce" not in ops for ops in lev.values()),
                    f"{what} rank {rank}: the sharded backend all-reduced: {lev}")
    require(len({r["checksum"] for r in per_rank}) == 1, f"{what}: ranks disagree")


def run_mesh_mines(data):
    """The mesh mines: (a) tidsharded on one NCCL rank in this process,
    each mine run twice and the second reported; (b) tidsharded 1x4,
    sharded 4 and grid 2x2 on 4 gloo ranks sharing the card; (c) a v3 mine
    through the mesh accumulator on the same 4 ranks.  Returns the K3
    launches of rank 0 of the tidsharded 1x4 mines (counts reset before
    each mine), whose slices of 25 and 782 words are the timed shapes."""
    import tempfile
    from repro_torch.launch.mesh import process_group, run_ranks
    from repro_torch.launch.mesh_runs import run_jobs

    jobs = _mesh_jobs([("tidsharded 1 rank", "fused", "words", None)], data)
    for job in jobs:
        job["reps"] = 2     # the first run of the process starts NCCL
    with tempfile.TemporaryDirectory() as tmp:
        with process_group("nccl", 1, 0, f"file://{tmp}/rendezvous",
                           device="cuda") as dev:
            t0 = time.perf_counter()
            results = run_jobs(dev, jobs)
            print(f"e2e mesh nccl 1 rank: {len(jobs)} mines in "
                  f"{time.perf_counter() - t0:.2f}s")
    for job, res in zip(jobs, results):
        _check_mesh_run(job, [res], 1, "nccl, 1 rank on the card")
    jobs = _mesh_jobs([("tidsharded 1x4", "fused", "words", None),
                       ("sharded 4", "sharded", "pairs", None),
                       ("grid 2x2", "grid", "grid", "2x2")], data)
    txns, spec = data["T10I4D100K"]
    jobs.append(dict(kind="mine", txns=txns, n_items=spec.n_items, grid=None,
                     label="tidsharded 1x4 v3 (mesh accumulator)",
                     expect=E2E_RUNS[0][4], run="T10I4D100K min_sup=0.01 v3",
                     config=dict(min_sup=0.01, variant="v3", backend="fused",
                                 shard="words")))
    t0 = time.perf_counter()
    per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cuda",
                         args=(jobs,), timeout=600)
    print(f"e2e mesh gloo 4 ranks on one card: {len(jobs)} mines in "
          f"{time.perf_counter() - t0:.2f}s with spawn (a correctness "
          f"topology: 4 processes share one card and exchange through host "
          f"copies; its times are no measure of a 4-card mesh)")
    for j, job in enumerate(jobs):
        n_data = 2 if job["label"].startswith("grid") else 4
        _check_mesh_run(job, [r[j] for r in per_rank], n_data,
                        "gloo, 4 ranks sharing the card")
    k3 = sum(per_rank[0][j]["launches"]["fused_intersect_partial"]
             for j, job in enumerate(jobs) if job["label"] == "tidsharded 1x4")
    acc = per_rank[0][-1]["stats"]["collectives"]["vertical"]
    w = per_rank[0][-1]["stats"]["n_words"]
    print(f"e2e mesh v3 accumulator: vertical-build collectives {acc} "
          f"(one all-reduce of the {spec.n_items} x {-(-len(txns) // 32)} "
          f"word partial per rank; filtered W={w})")
    require(acc.get("data", {}).get("all_reduce", {}).get("calls") == 1,
            "the v3 mesh mine did not merge through one all-reduce")
    return k3


def _stream_slide_checks(what, i, n_blocks, push_l, mine_l, n_expands, level2):
    """The launches of one slide of a fused stream: K4 once per push while
    the window warms up and twice once it evicts, K2 once per expansion (at
    least once when the window has a frequent pair), K1 never alone."""
    want_k4 = 1 if i < n_blocks else 2
    require(push_l["trimatrix"] == want_k4,
            f"{what} slide {i}: K4 launched {push_l['trimatrix']} times in the "
            f"push, expected {want_k4}")
    require(sum(push_l.values()) == push_l["trimatrix"],
            f"{what} slide {i}: the push launched {push_l}")
    require(mine_l["trimatrix"] == 0, f"{what} slide {i}: the mine launched K4")
    require(mine_l["fused_intersect_compact"] == n_expands and
            (n_expands > 0 or not level2),
            f"{what} slide {i}: K2 launched {mine_l['fused_intersect_compact']} "
            f"times for {n_expands} expansions (level 2: {level2} pairs)")
    require(mine_l["fused_intersect"] == 0,
            f"{what} slide {i}: K1 launched on its own; it runs inside K2's pass")


def run_streams(launches):
    """The sliding-window miner on the card: T10I4D100K and chess streams on
    the ``fused`` and ``ref`` backends, each slide held to the port's batch
    ``mine()`` of the window (run once a slide, in the fused pass: both
    backends slide the same batches through windows of the same size, so
    their windows are the same), to the ``ref`` stream and to the
    reference's pinned checksum, with the kernels' launches per push and per mine; then
    the same streams on 4 gloo ranks sharing the card (tidsharded 1x4, grid
    2x2 and sharded 4 for chess, tidsharded 1x4 for T10I4D100K), every rank
    held to the pinned checksums, zero collectives per push and one
    all-reduce and one K3 per expansion.  Adds the fused streams' launches
    to ``launches``; returns the largest level-2 expansion of each fused
    stream (its pair lists over the ring, recorded through a spy on
    ``FusedEngine._intersect_compact``) and the per-slide times."""
    import statistics
    import torch
    from repro_torch import kernels
    from repro_torch.core import EclatConfig, mine, support_checksum
    from repro_torch.core.engine import FusedEngine
    from repro_torch.data import stream_spec, transaction_stream
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.mesh_runs import run_jobs
    from repro_torch.launch.stream_profile import STREAMS
    from repro_torch.streaming import StreamConfig, StreamingMiner

    batches, recorded, times = {}, {}, {}
    for name, n_blocks, block_txns, min_sup, n_batches, drift in STREAMS:
        t0 = time.perf_counter()
        batches[name] = list(transaction_stream(name, block_txns, n_batches,
                                                seed=0, drift_every=drift))
        STREAM_BATCHES[name] = batches[name]
        print(f"e2e stream generate {name}: {n_batches} batches of {block_txns} "
              f"txns in {time.perf_counter() - t0:.2f}s (host)")
    original = FusedEngine._intersect_compact
    for name, n_blocks, block_txns, min_sup, n_batches, drift in STREAMS:
        n_items = stream_spec(name).n_items
        pinned = STREAM_CHECKSUMS[name]
        sums, batch_sums = {}, []
        for backend in ("fused", "ref"):
            what = f"stream {name} {backend}"
            cfg = StreamConfig(min_sup=min_sup, n_blocks=n_blocks,
                               block_txns=block_txns, backend=backend)
            miner = StreamingMiner(n_items, cfg)
            ring = miner.ring.device
            seen = {}

            def spy(bitmaps, left, right, sup_left, min_sup_, n_valid, *, mode,
                    **tile):
                # the level-2 expansion runs over the ring itself
                if (bitmaps.data_ptr() == ring.data_ptr() and
                        (not seen or left.shape[0] > seen["left"].shape[0])):
                    seen.update(bitmaps=bitmaps.clone(), left=left.clone(),
                                right=right.clone(), sup_left=sup_left.clone(),
                                min_sup=int(min_sup_), n_valid=int(n_valid))
                return original(bitmaps, left, right, sup_left, min_sup_,
                                n_valid, mode=mode, **tile)

            FusedEngine._intersect_compact = staticmethod(spy)
            try:
                rows = []
                for i, batch in enumerate(batches[name]):
                    kernels.reset_launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    push = miner.push(batch)
                    torch.cuda.synchronize()
                    push_s = time.perf_counter() - t0
                    push_l = kernels.launch_counts()
                    kernels.reset_launch_counts()
                    t0 = time.perf_counter()
                    res = miner.mine_window()
                    torch.cuda.synchronize()
                    mine_s = time.perf_counter() - t0
                    mine_l = kernels.launch_counts()
                    st = res.stats
                    csum = support_checksum(res.support_map())
                    n_exp = len(st.get("pair_padding", {}).get("per_level", []))
                    level2 = res.counts[1] if len(res.counts) > 1 else 0
                    if backend == "fused":
                        _stream_slide_checks(what, i, n_blocks, push_l, mine_l,
                                             n_exp, level2)
                        for k in launches:
                            launches[k] += push_l[k] + mine_l[k]
                    else:
                        require(not any(push_l.values()) and not any(mine_l.values()),
                                f"{what} slide {i}: the ref backend launched "
                                f"{push_l} {mine_l}")
                    batch_s = None
                    if backend == "fused":
                        kernels.reset_launch_counts()
                        t0 = time.perf_counter()
                        whole = mine(miner.window_transactions(), n_items,
                                     EclatConfig(min_sup=min_sup))
                        batch_s = time.perf_counter() - t0
                        batch_sums.append(support_checksum(whole.support_map()))
                    batch_sum = batch_sums[i]
                    phase = st["phase_s"]
                    row = dict(push_s=push_s, level2=phase.get("level2", 0.0),
                               bottom_up=phase.get("bottom_up", 0.0),
                               slide_s=push_s + mine_s)
                    rows.append(row)
                    print(f"e2e stream {name} backend={backend} slide {i}: "
                          f"n_txn={res.n_txn} evicted={push['n_evicted']} "
                          f"itemsets={res.total} levels={res.counts} "
                          f"classes={st['classes']} checksum={csum} "
                          f"push_s={push_s:.4f} level2={row['level2']:.4f} "
                          f"bottom_up={row['bottom_up']:.4f} "
                          f"slide_s={row['slide_s']:.4f} "
                          f"batch_mine_s="
                          f"{'(the fused pass)' if batch_s is None else f'{batch_s:.4f}'} "
                          f"launches push={ {k: v for k, v in push_l.items() if v} } "
                          f"mine={ {k: v for k, v in mine_l.items() if v} }")
                    require(csum == batch_sum,
                            f"{what} slide {i}: checksum {csum} != batch mine() "
                            f"of the window {batch_sum}")
                    require(csum == pinned[i],
                            f"{what} slide {i}: checksum {csum} != reference {pinned[i]}")
                    sums.setdefault(backend, []).append(csum)
            finally:
                FusedEngine._intersect_compact = staticmethod(original)
            miner.ring.validate()
            times[(name, backend)] = rows
            if backend == "fused":
                require(seen, f"{what}: no level-2 expansion over the ring")
                p, w = seen["bitmaps"].shape
                seen["label"] = (f"{name} stream level 2 over the ring: P={p} "
                                 f"W={w} Q={seen['left'].shape[0]} "
                                 f"valid={seen['n_valid']}")
                recorded[name] = seen
            full = rows[n_blocks:]
            med = {k: statistics.median(r[k] for r in full) for k in rows[0]}
            print(f"e2e stream {name} backend={backend}: {len(rows)} slides, "
                  f"window {n_blocks} x {block_txns} txns, ring "
                  f"{tuple(miner.ring.device.shape)} int32 words; median over "
                  f"the {len(full)} evicting slides: push_s={med['push_s']:.4f} "
                  f"level2={med['level2']:.4f} bottom_up={med['bottom_up']:.4f} "
                  f"slide_s={med['slide_s']:.4f}; ring validated")
        require(sums["fused"] == sums["ref"], f"stream {name}: fused != ref")
        print(f"e2e stream {name}: fused == ref == batch mine() == reference "
              f"checksum on all {len(sums['fused'])} slides")

    jobs = []
    for label, name, backend, shard, grid in MESH_STREAMS:
        _, n_blocks, block_txns, min_sup, _, _ = next(
            st for st in STREAMS if st[0] == name)
        # the batches made above, pickled to each rank: generating
        # T10I4D100K's again on every rank costs more than its slides
        jobs.append(dict(kind="stream", batches=batches[name],
                         n_items=stream_spec(name).n_items, grid=grid,
                         label=label, name=name, n_blocks=n_blocks,
                         config=dict(min_sup=min_sup, n_blocks=n_blocks,
                                     block_txns=block_txns, backend=backend,
                                     shard=shard)))
    t0 = time.perf_counter()
    per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cuda",
                         args=(jobs,), timeout=600)
    print(f"e2e stream mesh gloo 4 ranks on one card: {len(jobs)} streams in "
          f"{time.perf_counter() - t0:.2f}s with spawn, the batches sent to each "
          f"rank (a correctness topology: its times are no measure of "
          f"a 4-card mesh)")
    for j, job in enumerate(jobs):
        _check_mesh_stream(job, [r[j] for r in per_rank], times)
    return recorded, times


def run_no_compaction(launches):
    """The non-compacting engine (``compact=False``, the reference's two
    steps: K1 writes the whole (Q, W) block, the mask comes to the host, a
    row gather of the survivors follows) on the card: the E2E_RUNS mines
    on the ``fused`` backend against their pinned checksums, K1 launched
    once an expansion and K2 never, K4 once; then the chess stream's first
    NO_COMPACT_SLIDES slides with ``compact=False`` beside the compacting
    fused miner, each slide's itemsets and supports equal and on the
    pinned checksum, K1 once an expansion and K2 never.  Adds K1's
    launches to ``launches``."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import EclatConfig, mine, support_checksum
    from repro_torch.data import stream_spec
    from repro_torch.launch.stream_profile import STREAMS
    from repro_torch.streaming import StreamConfig, StreamingMiner

    for name, min_sup, variant, diffsets, expect in E2E_RUNS:
        txns, spec = DATA[name]
        cfg = EclatConfig(min_sup=min_sup, variant=variant, use_diffsets=diffsets,
                          compact=False)
        what = f"no-compaction mine {name} min_sup={min_sup} {variant}" + (
            " diffsets" if diffsets else "")
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mine(txns, spec.n_items, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        csum = support_checksum(res.support_map())
        n_exp = len(res.stats.get("pair_padding", {}).get("per_level", []))
        want_k4 = 1 if res.stats.get("tri_matrix") else 0
        print(f"e2e {what} backend=fused compact=False: levels={res.counts} "
              f"total={res.total} checksum={csum} wall_s={wall:.4f} "
              f"phase_s={ {k: round(v, 4) for k, v in res.stats['phase_s'].items()} } "
              f"expansions={n_exp} launches={ {k: v for k, v in counts.items() if v} }")
        require(res.stats["backend"] == "fused" and csum == expect,
                f"{what}: {res.stats['backend']} checksum {csum} != reference {expect}")
        require(counts["fused_intersect"] == n_exp > 0 and
                counts["fused_intersect_compact"] == 0 and counts["trimatrix"] == want_k4,
                f"{what}: K1 {counts['fused_intersect']}, K2 "
                f"{counts['fused_intersect_compact']} and K4 {counts['trimatrix']} "
                f"launches for {n_exp} expansions")
        others = {k: v for k, v in counts.items()
                  if v and k not in ("fused_intersect", "trimatrix")}
        require(not others, f"{what}: launched {others}")
        launches["fused_intersect"] += counts["fused_intersect"]

    name = "chess"
    _, n_blocks, block_txns, min_sup, _, _ = next(st for st in STREAMS if st[0] == name)
    n_items = stream_spec(name).n_items
    miners = {compact: StreamingMiner(n_items, StreamConfig(
        min_sup=min_sup, n_blocks=n_blocks, block_txns=block_txns, compact=compact))
        for compact in (False, True)}
    require(not miners[False].engine.compact and miners[True].engine.compact,
            "the stream's engines do not carry compact")
    for i, batch in enumerate(STREAM_BATCHES[name][:NO_COMPACT_SLIDES]):
        res, slide_l = {}, {}
        for compact, miner in miners.items():
            kernels.reset_launch_counts()
            miner.push(batch)
            push_l = kernels.launch_counts()
            kernels.reset_launch_counts()
            res[compact] = miner.mine_window()
            torch.cuda.synchronize()
            slide_l[compact] = (push_l, kernels.launch_counts())
        got, want = res[False], res[True]
        csum = support_checksum(got.support_map())
        n_exp = len(got.stats.get("pair_padding", {}).get("per_level", []))
        push_l, mine_l = slide_l[False]
        print(f"e2e stream {name} compact=False slide {i}: itemsets={got.total} "
              f"levels={got.counts} checksum={csum} expansions={n_exp} launches "
              f"push={ {k: v for k, v in push_l.items() if v} } "
              f"mine={ {k: v for k, v in mine_l.items() if v} }")
        require(got.support_map() == want.support_map() and got.counts == want.counts,
                f"stream {name} compact=False slide {i}: differs from the compacting "
                f"miner's")
        require(csum == STREAM_CHECKSUMS[name][i],
                f"stream {name} compact=False slide {i}: checksum {csum}")
        require(mine_l["fused_intersect"] == n_exp and
                mine_l["fused_intersect_compact"] == 0 and
                push_l["trimatrix"] == 1 and sum(push_l.values()) == 1,
                f"stream {name} compact=False slide {i}: launches push {push_l} "
                f"mine {mine_l} for {n_exp} expansions")
        launches["fused_intersect"] += mine_l["fused_intersect"]
    print(f"e2e stream {name} compact=False: {NO_COMPACT_SLIDES} slides equal the "
          f"compacting miner's and the pinned checksums; K1 once an expansion, K2 none")


def _replay_slides(what, miner, batches, start, n_blocks, pinned, launches):
    """Slide ``batches[start:]`` through ``miner`` on the card, each slide
    held to the pinned checksum and to the launch gates of a fused stream
    (K4 once per warming and twice per evicting push, K2 once per
    expansion); adds the launches to ``launches``.  Returns the slides'
    ``slide_s``."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import support_checksum
    slide_s = []
    for i in range(start, len(batches)):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miner.push(batches[i])
        torch.cuda.synchronize()
        push_s = time.perf_counter() - t0
        push_l = kernels.launch_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = miner.mine_window()
        torch.cuda.synchronize()
        slide_s.append(push_s + time.perf_counter() - t0)
        mine_l = kernels.launch_counts()
        csum = support_checksum(res.support_map())
        require(csum == pinned[i], f"{what} slide {i}: checksum {csum} != "
                                   f"the uninterrupted run's {pinned[i]}")
        n_exp = len(res.stats.get("pair_padding", {}).get("per_level", []))
        level2 = res.counts[1] if len(res.counts) > 1 else 0
        _stream_slide_checks(what, i, n_blocks, push_l, mine_l, n_exp, level2)
        for k in launches:
            launches[k] += push_l[k] + mine_l[k]
    return slide_s


def _killed_stream(directory, point, kill_from, n_items, cfg, batches):
    """A fused stream checkpointing every RESILIENCE_EVERY slides (waiting
    for each write before the next slide) that dies at the first ``point``
    hit from slide ``kill_from`` on.  Returns one record per checkpoint:
    the slide's own seconds, the seconds of the save call on the stream
    thread (the snapshot, then the writer thread's start) and of the
    snapshot alone, and the write behind it; and the ``slide_s`` of the
    slides that saved nothing."""
    import torch
    from repro_torch.faults import InjectedFault, clear_kill_hook, set_kill_hook
    from repro_torch.streaming import StreamCheckpointer, StreamingMiner
    miner = StreamingMiner(n_items, cfg)
    ck = StreamCheckpointer(directory, every=RESILIENCE_EVERY, keep=3)
    saves, plain = [], []

    def hook(name):
        if name == point:
            raise InjectedFault(point)
    fired = False
    try:
        for i, batch in enumerate(batches):
            if i == kill_from:
                set_kill_hook(hook)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            miner.advance(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            saved = ck.maybe_save(miner, i + 1)
            t2 = time.perf_counter()
            if not saved:
                plain.append(t1 - t0)
                continue
            ck.wait()
            saves.append(dict(ck.last_save, slide_s=t1 - t0, save_call_s=t2 - t1))
    except InjectedFault:
        fired = True
    finally:
        clear_kill_hook()
    require(fired, f"resilience: the fault at {point} never fired")
    return saves, plain


def run_resilience(launches):
    """Checkpoint, kill and restore on the card, re-meshing onto 4 gloo
    ranks, the batch resume and the FIM serving front end, over the
    T10I4D100K stream (16 x 8,192) that run_streams slid:

    (a) the fused stream checkpointing every 4 slides, killed at
        miner:pre_deep_expand in slide 10 and, in a second run, at
        checkpoint:pre_replace in the write of step 12; each time
        ``restore_miner`` brings back step 8 and the replay of slides 8-19
        (across the drift slide 18) carries the pinned checksums of the
        uninterrupted stream, with the fused stream's launch gates;
    (b) the same checkpoint restored on 4 gloo ranks sharing the card as
        tidsharded 1x4 and grid 2x2 (one K3 per expansion, one broadcast per
        mesh axis at restore, no collective in a push, every rank on the
        pinned checksums), the tidsharded ranks checkpointing as they
        replay; the card restores their step 18 and replays slides 18-19;
    (c) the fused mine of T10I4D100K 0.01 v4 checkpointed every level,
        resumed from level 3 with ``resume_mine`` on the card and on 4 gloo
        ranks (tidsharded 1x4), both on the pinned checksum;
    (d) ``ServingFrontend`` over the window: a writer thread slides 8
        batches under a 200-query storm from 4 clients (policy block),
        ``verify_storm`` holds every answer; then the front end restored
        with ``from_checkpoint`` answers the same storm identically.

    Adds the phase's launches to ``launches``."""
    import shutil
    import statistics
    import tempfile
    import threading
    import torch
    from repro_torch import kernels
    from repro_torch.core import EclatConfig, mine, resume_mine, support_checksum
    from repro_torch.data import stream_spec
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.mesh_runs import run_jobs
    from repro_torch.launch.stream_profile import STREAMS
    from repro_torch.serving import (AdmissionConfig, ServingFrontend,
                                     answer_checksum, answer_query, query_mix,
                                     run_storm, verify_storm)
    from repro_torch.streaming import (StreamCheckpointer, StreamConfig,
                                       StreamingMiner, restore_miner)
    from repro_torch.training import valid_steps

    name = RESILIENCE_STREAM
    _, n_blocks, block_txns, min_sup, n_batches, drift = next(
        st for st in STREAMS if st[0] == name)
    batches = STREAM_BATCHES[name]
    pinned = STREAM_CHECKSUMS[name]
    n_items = stream_spec(name).n_items
    cfg = StreamConfig(min_sup=min_sup, n_blocks=n_blocks, block_txns=block_txns)
    root = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    numbers = {}
    try:
        # ---- (a) kill and restore on one card -------------------------------
        kill_dir = os.path.join(root, "killed")
        saves, plain = _killed_stream(
            kill_dir, "miner:pre_deep_expand", RESILIENCE_KILL, n_items, cfg,
            batches)
        steps = valid_steps(kill_dir)
        require(steps and steps[-1] == 8, f"resilience (a): durable steps {steps}")
        for sv in saves:
            print(f"e2e resilience checkpoint {name} step {sv['step']}: slide_s="
                  f"{sv['slide_s']:.4f}, then on the stream thread save_call_s="
                  f"{sv['save_call_s']:.4f} (of it snapshot_s="
                  f"{sv['snapshot_s']:.4f}); write_s={sv['write_s']:.4f} "
                  f"(writer thread, behind)")
        print(f"e2e resilience slides {name}: median slide_s of the "
              f"{len(plain)} slides without a checkpoint "
              f"{statistics.median(plain):.4f}")
        for key in ("snapshot_s", "save_call_s", "write_s"):
            numbers[key] = [sv[key] for sv in saves]
        for point, kill_from, d in (
                ("miner:pre_deep_expand", None, kill_dir),
                ("checkpoint:pre_replace", 11, os.path.join(root, "torn"))):
            if kill_from is not None:
                _killed_stream(d, point, kill_from, n_items, cfg, batches)
                steps = valid_steps(d)
                require(steps and steps[-1] == 8,
                        f"resilience (a) {point}: durable steps {steps}")
                require(any(x.startswith(".tmp_ckpt_") for x in os.listdir(d)),
                        f"resilience (a) {point}: no torn write left behind")
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            miner, start = restore_miner(d)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            require(sum(kernels.launch_counts().values()) == 0,
                    "resilience (a): the restore launched a kernel")
            miner.ring.validate()
            require(start == 8 and miner.window_version == 8,
                    f"resilience (a): restored step {start}, version "
                    f"{miner.window_version}")
            slide_s = _replay_slides(f"resilience (a) {point} replay", miner,
                                     batches, start, n_blocks, pinned, launches)
            miner.ring.validate()
            numbers.setdefault("restore_s", []).append(restore_s)
            numbers.setdefault("replay_slide_s", []).extend(slide_s)
            print(f"e2e resilience (a) {name} killed at {point}: restored "
                  f"step {start} on one card in {restore_s:.4f}s (validated), "
                  f"replayed slides {start}-{len(batches) - 1} on the pinned "
                  f"checksums (drift slide 18 included); replay median "
                  f"slide_s={statistics.median(slide_s):.4f}")

        # ---- (c) the batch mine checkpointed every level ---------------------
        txns, spec = DATA[name]
        mine_dir = os.path.join(root, "mine")
        mcfg = dict(min_sup=0.01, variant="v4")
        kernels.reset_launch_counts()
        res = mine(txns, spec.n_items, EclatConfig(
            **mcfg, checkpoint_dir=mine_dir, checkpoint_every_level=True))
        counts = kernels.launch_counts()
        for k in MINING_KERNELS:
            launches[k] += counts[k]
        expect = next(e[4] for e in E2E_RUNS if e[0] == name)
        require(support_checksum(res.support_map()) == expect,
                "resilience (c): the checkpointing mine's checksum")
        ckpts = sorted(os.listdir(mine_dir))
        for f in ckpts:
            if int(f[len("mining_ckpt_k"):-len(".npz")]) > RESUME_LEVEL:
                os.remove(os.path.join(mine_dir, f))
        require(os.listdir(mine_dir) == [f"mining_ckpt_k{RESUME_LEVEL}.npz"],
                f"resilience (c): checkpoints {ckpts}")
        print(f"e2e resilience (c) mine {name} 0.01 v4 checkpointed every "
              f"level: levels={res.counts} files={ckpts}; kept level "
              f"{RESUME_LEVEL} only")

        # ---- (b) + (c) on 4 gloo ranks sharing the card ----------------------
        mesh_ckpt = os.path.join(root, "mesh")
        jobs = []
        for label, backend, shard, grid in RESILIENCE_MESHES:
            jobs.append(dict(kind="stream_restore", directory=kill_dir,
                             batches=batches, grid=grid, backend=backend,
                             shard=shard, label=label,
                             config=dict(backend=backend, shard=shard),
                             checkpoint=((mesh_ckpt, RESILIENCE_MESH_EVERY)
                                         if backend == "tidsharded" else None)))
        jobs.append(dict(kind="resume", label="tidsharded 1x4",
                         config=dict(mcfg, backend="tidsharded", shard="words",
                                     checkpoint_dir=mine_dir)))
        t0 = time.perf_counter()
        per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cuda",
                             args=(jobs,), timeout=600)
        print(f"e2e resilience mesh gloo 4 ranks on one card: {len(jobs)} "
              f"jobs in {time.perf_counter() - t0:.2f}s with spawn")
        for j, job in enumerate(jobs[:len(RESILIENCE_MESHES)]):
            what = f"resilience (b) restore {name} as {job['label']}"
            n_axes = 2 if job["grid"] else 1
            for rank, r in enumerate(per_rank):
                r = r[j]
                require("error" not in r, f"{what} rank {rank}: {r.get('error')}")
                require(r["start"] == 8 and r["validate"] == "ok",
                        f"{what} rank {rank}: step {r['start']}, {r['validate']}")
                bc = r["restore_stats"]["collectives"]
                require(sum(ops.get("broadcast", {}).get("calls", 0)
                            for ops in bc.values()) == n_axes and
                        all(set(ops) == {"broadcast"} for ops in bc.values()),
                        f"{what} rank {rank}: restore collectives {bc}")
                require(sum(r["restore_launches"].values()) == 0,
                        f"{what} rank {rank}: the restore launched a kernel")
                for i, sl in enumerate(r["slides"], start=r["start"]):
                    require(sl["checksum"] == pinned[i],
                            f"{what} rank {rank} slide {i}: checksum "
                            f"{sl['checksum']} != {pinned[i]}")
                    require(sl["push_collectives"] == {},
                            f"{what} rank {rank} slide {i}: push collectives")
                    n_exp = sl["n_expands"]
                    level2 = sl["counts"][1] if len(sl["counts"]) > 1 else 0
                    _stream_slide_checks(f"{what} rank {rank}", i, n_blocks,
                                         sl["push_launches"], sl["mine_launches"],
                                         n_exp, level2)
                    require(sl["mine_launches"]["fused_intersect_partial"] == n_exp,
                            f"{what} rank {rank} slide {i}: K3 "
                            f"{sl['mine_launches']['fused_intersect_partial']} for "
                            f"{n_exp} expansions")
                    if rank == 0:
                        launches["fused_intersect_partial"] += n_exp
            r0 = per_rank[0][j]
            slide_s = [sl["slide_s"] for sl in r0["slides"]]
            numbers.setdefault("mesh_restore_s", []).append(
                r0["restore_stats"]["restore_s"])
            print(f"e2e {what}: every rank restored step {r0['start']} in "
                  f"{r0['restore_stats']['restore_s']:.4f}s (rank 0; "
                  f"collectives {r0['restore_stats']['collectives']}), "
                  f"replayed slides {r0['start']}-{len(batches) - 1} on the "
                  f"pinned checksums, one K3 per expansion; rank 0 replay "
                  f"median slide_s={statistics.median(slide_s):.4f}")
        steps = valid_steps(mesh_ckpt)
        require(steps and steps[-1] == 18, f"resilience (b): 4-rank steps {steps}")
        miner, start = restore_miner(mesh_ckpt)
        require(start == 18, f"resilience (b): restored step {start}")
        _replay_slides("resilience (b) 4-rank checkpoint on one card", miner,
                       batches, start, n_blocks, pinned, launches)
        miner.ring.validate()
        print(f"e2e resilience (b) the 4-rank checkpoint (steps {steps}, rank 0 "
              f"wrote) restored on one card at step {start}: slides 18-19 on "
              f"the pinned checksums")

        rz = [r[-1] for r in per_rank]
        for rank, r in enumerate(rz):
            require("error" not in r, f"resilience (c) rank {rank}: {r.get('error')}")
            require(r["checksum"] == expect and r["resume_k"] == RESUME_LEVEL,
                    f"resilience (c) rank {rank}: checksum {r['checksum']} at "
                    f"level {r['resume_k']}")
            require(r["launches"]["fused_intersect_partial"] == r["n_expands"],
                    f"resilience (c) rank {rank}: K3 {r['launches']} for "
                    f"{r['n_expands']} expansions")
        launches["fused_intersect_partial"] += rz[0]["launches"]["fused_intersect_partial"]
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = resume_mine(EclatConfig(**mcfg, checkpoint_dir=mine_dir))
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        n_exp = len(resumed.stats.get("pair_padding", {}).get("per_level", []))
        require(support_checksum(resumed.support_map()) == expect,
                "resilience (c): the card's resume_mine checksum")
        require(counts["fused_intersect_compact"] == n_exp and
                counts["trimatrix"] == 0 and counts["fused_intersect"] == 0,
                f"resilience (c): resume launches {counts} for {n_exp} expansions")
        for k in MINING_KERNELS:
            launches[k] += counts[k]
        numbers["resume_wall_s"] = resume_wall
        print(f"e2e resilience (c) resume_mine {name} from level {RESUME_LEVEL}: "
              f"card wall_s={resume_wall:.4f} levels={resumed.counts} checksum "
              f"{expect}; tidsharded 1x4 gloo rank 0 wall_s="
              f"{rz[0]['wall_s']:.4f} (restore collectives "
              f"{rz[0]['collectives'].get('restore')}); both on the pinned checksum")

        # ---- (d) the FIM serving front end -----------------------------------
        acfg = AdmissionConfig(policy="block", keep_versions=SERVE_SLIDES + 4,
                               stall_timeout_s=30.0)
        kernels.reset_launch_counts()
        frontend = ServingFrontend(
            StreamingMiner(n_items, cfg, keep_transactions=False), acfg)
        writer_rows, writer_error = [], []
        try:
            frontend.ingest(batches[0])

            def writer():
                try:
                    for i in range(1, SERVE_SLIDES + 1):
                        res = frontend.ingest(batches[i])
                        writer_rows.append((i, support_checksum(res.support_map()),
                                            res.stats["slide_s"], res.version))
                except BaseException as e:   # reported below, never lost
                    writer_error.append(e)
            queries = query_mix(SERVE_QUERIES, seed=0)
            wt = threading.Thread(target=writer, name="miner-writer", daemon=True)
            wt.start()
            # clients pace their queries so the storm overlaps the slides
            outcome = run_storm(frontend, queries, n_clients=SERVE_CLIENTS,
                                pace_s=SERVE_PACE_S)
            wt.join(timeout=600)
            require(not wt.is_alive() and not writer_error,
                    f"resilience (d): writer {writer_error or 'hung'}")
            served = kernels.launch_counts()
            ver = verify_storm(frontend, queries, outcome)
            require(not outcome["errors"] and not outcome["shed"] and
                    ver["verified"] == SERVE_QUERIES,
                    f"resilience (d): {len(outcome['errors'])} errors, "
                    f"{len(outcome['shed'])} shed, {ver['verified']} verified")
            for i, csum, _, version in writer_rows:
                require(csum == pinned[i] and version == i + 1,
                        f"resilience (d) slide {i}: checksum {csum} version {version}")
            require(served["trimatrix"] == SERVE_SLIDES + 1 and
                    served["fused_intersect_compact"] > 0 and
                    served["fused_intersect"] == 0,
                    f"resilience (d): writer launches {served}")
            for k in MINING_KERNELS:
                launches[k] += served[k]
            m = frontend.metrics.summary()
            c = frontend.cache.stats()
            versions = sorted({v for _, v in outcome["answers"].values()})
            load_slide = [row[2] for row in writer_rows]
            numbers["serve"] = dict(p50=m["latency_ms"]["p50"],
                                    p99=m["latency_ms"]["p99"], qps=m["qps"],
                                    hit_rate=c["hit_rate"],
                                    slide_s=statistics.median(load_slide))
            print(f"e2e resilience (d) serve {name}: {SERVE_SLIDES} slides under a "
                  f"{SERVE_QUERIES}-query storm ({SERVE_CLIENTS} clients, block): "
                  f"answered {m['n_answered']}, verified {ver['verified']} at "
                  f"versions {versions} (checksum {ver['checksum']}); latency "
                  f"p50 {m['latency_ms']['p50']:.3f}ms p99 "
                  f"{m['latency_ms']['p99']:.3f}ms; {m['qps']:.1f} qps; cache "
                  f"hit rate {c['hit_rate']:.3f}; writer slide_s under load "
                  f"median {statistics.median(load_slide):.4f} max "
                  f"{max(load_slide):.4f}; writer launches "
                  f"{ {k: v for k, v in served.items() if v} }")
            serve_dir = os.path.join(root, "serve")
            ck = StreamCheckpointer(serve_dir)
            ck.save(frontend.miner, SERVE_SLIDES + 1)
            ck.wait()
            final = frontend.snapshot_at(SERVE_SLIDES + 1)
        finally:
            frontend.stop()
        t0 = time.perf_counter()
        restored, completed = ServingFrontend.from_checkpoint(serve_dir, config=acfg)
        restore_s = time.perf_counter() - t0
        try:
            require(completed == SERVE_SLIDES + 1 and
                    restored.window_version == SERVE_SLIDES + 1,
                    f"resilience (d): restored at {completed}, version "
                    f"{restored.window_version}")
            again = run_storm(restored, queries, n_clients=SERVE_CLIENTS)
            ver2 = verify_storm(restored, queries, again)
            require(not again["errors"] and ver2["verified"] == SERVE_QUERIES,
                    f"resilience (d) restored: {again['errors']}")
            for q in queries:
                ans, version = again["answers"][q.qid]
                direct, _ = answer_query(final, q, cache=None)
                require(version == SERVE_SLIDES + 1 and
                        answer_checksum(ans) == answer_checksum(direct),
                        f"resilience (d) restored: qid {q.qid} differs from the "
                        f"live front end's window {SERVE_SLIDES + 1}")
            m2 = restored.metrics.summary()
        finally:
            restored.stop()
        numbers["serve_restore_s"] = restore_s
        print(f"e2e resilience (d) from_checkpoint: restored window version "
              f"{completed} in {restore_s:.4f}s (re-mine included); the same "
              f"storm answered identically to the live front end at that "
              f"version ({ver2['verified']} verified; p50 "
              f"{m2['latency_ms']['p50']:.3f}ms p99 {m2['latency_ms']['p99']:.3f}ms; "
              f"{m2['qps']:.1f} qps)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"e2e resilience summary: {json.dumps(numbers)}")


def _check_mesh_stream(job, per_rank, times):
    """Every rank's slides of one mesh stream: the pinned checksums, zero
    collectives and only K4 in a push, K2 (and K3 but for sharded) once per
    expansion with one all-reduce over data each, K1 never alone, the ring
    slice validated.  Prints rank 0's slides and one line per stream."""
    import statistics
    what = f"mesh stream {job['name']} {job['label']}"
    name, n_blocks = job["name"], job["n_blocks"]
    for rank, res in enumerate(per_rank):
        require("error" not in res, f"{what}: rank {rank} refused: {res.get('error')}")
        backend = res["engine"]
        require(res["validate"] == "ok", f"{what} rank {rank}: {res['validate']}")
        for i, sl in enumerate(res["slides"]):
            n_exp = sl["n_expands"]
            push_l, mine_l = sl["push_launches"], sl["mine_launches"]
            if rank == 0:
                print(f"e2e {what} rank 0 slide {i}: backend={backend} "
                      f"checksum={sl['checksum']} levels={sl['counts']} "
                      f"push_s={sl['push_s']:.4f} "
                      f"level2={sl['stats']['phase_s'].get('level2', 0.0):.4f} "
                      f"bottom_up={sl['stats']['phase_s'].get('bottom_up', 0.0):.4f} "
                      f"slide_s={sl['slide_s']:.4f} expands={n_exp} "
                      f"push_collectives={sl['push_collectives']} "
                      f"mine_collectives={sl['mine_collectives']} "
                      f"launches push={ {k: v for k, v in push_l.items() if v} } "
                      f"mine={ {k: v for k, v in mine_l.items() if v} }")
            require(sl["checksum"] == STREAM_CHECKSUMS[name][i],
                    f"{what} rank {rank} slide {i}: checksum {sl['checksum']} != "
                    f"reference {STREAM_CHECKSUMS[name][i]}")
            require(sl["push_collectives"] == {},
                    f"{what} rank {rank} slide {i}: the push made collectives "
                    f"{sl['push_collectives']}")
            level2 = sl["counts"][1] if len(sl["counts"]) > 1 else 0
            _stream_slide_checks(f"{what} rank {rank}", i, n_blocks, push_l, mine_l,
                                 n_exp, level2)
            want_k3 = 0 if backend == "sharded" else n_exp
            require(mine_l["fused_intersect_partial"] == want_k3,
                    f"{what} rank {rank} slide {i}: K3 launched "
                    f"{mine_l['fused_intersect_partial']} times for {n_exp} expansions")
            red = sl["mine_collectives"].get("data", {}).get("all_reduce", {}).get("calls", 0)
            require(red == want_k3,
                    f"{what} rank {rank} slide {i}: {red} all-reduces over data "
                    f"for {n_exp} expansions")
    sums = [[sl["checksum"] for sl in res["slides"]] for res in per_rank]
    require(all(x == sums[0] for x in sums), f"{what}: ranks disagree")
    slides = per_rank[0]["slides"][n_blocks:]
    med = {k: statistics.median(sl[k] for sl in slides) for k in ("push_s", "slide_s")}
    times[(name, f"mesh {job['label']}")] = [
        dict(push_s=sl["push_s"], slide_s=sl["slide_s"],
             level2=sl["stats"]["phase_s"].get("level2", 0.0),
             bottom_up=sl["stats"]["phase_s"].get("bottom_up", 0.0))
        for sl in per_rank[0]["slides"]]
    print(f"e2e {what}: every rank equal to the reference checksums on all "
          f"{len(sums[0])} slides; ring slice {per_rank[0]['ring_geometry']} "
          f"validated; no collective in a push; rank 0 median over the "
          f"evicting slides push_s={med['push_s']:.4f} slide_s={med['slide_s']:.4f}")


def check_stream_pairs(recorded):
    """K2, K3 and K1 against their plain versions, exact, on the pair lists
    of the largest level-2 expansion of each fused stream: universe item ids
    in support order over the whole ring (not class-ordered rows), every
    mode; K3 on rank 0's 4-shard slice of the ring, with and without its
    store.  Prints how many operands K1/K3's windows leave outside."""
    import torch
    from repro_torch.kernels.fused_intersect import (
        fused_intersect, fused_intersect_compact, fused_intersect_compact_ref,
        fused_intersect_partial, fused_intersect_partial_ref,
        fused_intersect_ref)
    from repro_torch.kernels.fused_intersect.fused_intersect import window_plan
    from repro_torch.launch.kernel_timing import rank0_slice, window_rows
    for name, rec in recorded.items():
        bm, l, r, s, ms, nv = (rec[k] for k in ("bitmaps", "left", "right",
                                                "sup_left", "min_sup", "n_valid"))
        part = rank0_slice(bm)
        for mode in (0, 1, 2):
            got = fused_intersect_compact(bm, l, r, s, ms, nv, mode=mode)
            want = fused_intersect_compact_ref(bm, l, r, s, ms, nv, mode=mode)
            got1 = fused_intersect(bm, l, r, s, ms, mode=mode)
            want1 = fused_intersect_ref(bm, l, r, s, ms, mode=mode)
            got_p = fused_intersect_partial(part, l, r, mode=mode)
            _, pop = fused_intersect_partial(part, l, r, mode=mode, store=False)
            want_p = fused_intersect_partial_ref(part, l, r, mode=mode)
            torch.cuda.synchronize()
            for g, e, what in zip(got, want, ("compact", "sup", "mask", "n_surv")):
                compare("fused_intersect_compact", g, e,
                        f"fused_intersect_compact {rec['label']} mode {mode}: {what}")
            for g, e, what in zip(got1, want1, ("inter", "sup", "mask")):
                compare("fused_intersect", g, e,
                        f"fused_intersect {rec['label']} mode {mode}: {what}")
            for g, e, what in zip((*got_p, pop), (*want_p, want_p[1]), ("inter", "pop", "pop")):
                compare("fused_intersect_partial", g, e,
                        f"fused_intersect_partial {rec['label']} Ws={part.shape[1]} "
                        f"mode {mode}: {what}")
        plan = window_plan(l.shape[0], bm.shape[1])
        staged, largest, outside = window_rows(l[:nv].cpu().numpy(),
                                               r[:nv].cpu().numpy(), plan.tile, plan.rows)
        plan_p = window_plan(l.shape[0], part.shape[1])
        staged_p, _, outside_p = window_rows(l[:nv].cpu().numpy(), r[:nv].cpu().numpy(),
                                             plan_p.tile, plan_p.rows)
        print(f"check fused_intersect_compact, fused_intersect and "
              f"fused_intersect_partial (Ws={part.shape[1]}) on {rec['label']} "
              f"(min_sup {ms}; universe-id pairs in support order) modes 0-2: "
              f"equal to ref (exact); windows: K1 {plan.tile}-pair tiles stage "
              f"{staged} rows (largest {largest}), {outside} of {2 * nv} "
              f"operands outside; K3 at Ws={part.shape[1]} stages {staged_p} "
              f"rows, {outside_p} operands outside")


def run_staticcheck():
    """The mining path's guard on the card: the gate of
    ``repro_torch.staticcheck`` (its ``full_gate``), which prints each
    layer's lines (the audits' declared and counted host syncs per level
    and per slide, and the profiler's count of what the card synchronised
    on) and returns 1 on any finding or rotted fixture (the card-sync
    fixture among them).  Layer 1:
    the port's lint and its fixtures.  Layer 3: a warm ``mine()`` and 5
    warm stream slides on the fused backend, with and without compaction,
    every host sync at its declared budget, no new allocator segment, no
    build, the paddings on the ladder; the shape fixture giving SH001,
    SH002 and SH003.  Layer 2: the collective contracts of every backend
    and the ring write on 4 gloo ranks sharing the card, and the four
    contract fixtures.  The audited runs must have launched K2, K1 (without
    compaction) and K4 in this process."""
    from repro_torch import kernels
    from repro_torch.staticcheck.__main__ import full_gate
    kernels.reset_launch_counts()
    report = os.path.join(tempfile.mkdtemp(prefix="chip_smoke-static-"), "findings.json")
    require(full_gate(report, "cuda") == 0,
            "the staticcheck gate found violations (the static: lines above)")
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    require(all(counts[k] > 0 for k in ("fused_intersect_compact", "fused_intersect",
                                        "trimatrix")),
            f"the staticcheck audits did not run the mining kernels: {counts}")
    print(f"staticcheck: gate clean on the card; the audits launched "
          f"fused_intersect_compact={counts['fused_intersect_compact']} "
          f"fused_intersect={counts['fused_intersect']} "
          f"trimatrix={counts['trimatrix']}")


def bound(nbytes, products):
    """Least time in ms for work that moves ``nbytes`` and holds ``products``
    one-bit multiply-adds, and which of the two bounds it.  The fastest
    route the card has for bit products is the dense int8 tensor-core
    product of the 0/1 indicator; the packed kernels use the popcount pipe,
    which is slower, so this bound is below what they can reach.  Rates:
    ``repro_torch.analysis.roofline`` (H100 SXM data sheet, dense, 700 W)."""
    from repro_torch.analysis import roofline as rl
    t_b = nbytes / rl.HBM_BYTES_PER_S * 1e3
    t_o = 2 * products / rl.INT8_TENSOR_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_kernels(launches, miner, stream_rec):
    """Each mining kernel at the main path's shapes, on random pairs and on
    ``miner``, the recorded pair lists of the mines' largest expansions:
    ``ms`` is its device time per call (``kernel_timing.device_ms``: calls
    run back to back behind a sleep of the card, as the attention rows),
    ``call_ms`` CUDA events around each call (the host's launch work
    included); the same for the plain version."""
    import torch
    from repro_torch.kernels.fused_intersect import (
        compact_survivors, compact_survivors_ref, fused_intersect,
        fused_intersect_compact, fused_intersect_compact_ref,
        fused_intersect_partial, fused_intersect_partial_ref,
        fused_intersect_ref, fused_support_pairs)
    from repro_torch.kernels.popcount_support import (intersect_support,
                                                      popcount_support_ref)
    from repro_torch.kernels.trimatrix import (cooccurrence, split_plan,
                                               trimatrix_ref)
    from repro_torch.launch.kernel_timing import (
        PAIR_SHAPES, SLIDE_SHAPES, TRI_TIMED_SHAPES, device_ms, median_ms,
        pair_inputs, rank0_slice, split_sweep, tri_inputs, unpacked_indicator)

    from repro_torch.analysis import roofline as rl
    print(f"timing peaks (H100 SXM data sheet, dense, 700 W): HBM "
          f"{rl.HBM_BYTES_PER_S:.3e} B/s; int8 tensor cores "
          f"{rl.INT8_TENSOR_OPS_PER_S:.3e} op/s, two per one-bit product")

    def timed(fn, ref, lib=None, plain_reps=20, plain_warmup=3):
        # library_ms stays what earlier runs reported: CUDA events around
        # each call
        out = dict(ms=device_ms(fn), call_ms=median_ms(fn),
                   plain_ms=device_ms(ref, reps=plain_reps, warmup=plain_warmup),
                   plain_call_ms=median_ms(ref, reps=plain_reps, warmup=plain_warmup),
                   library_ms=median_ms(lib) if lib is not None else None)
        return out

    rows = []
    pair_src = "src/repro_torch/csrc/fused_intersect.cu"
    tpu_src = "src/repro/kernels/fused_intersect/fused_intersect.py"
    # the pair inputs: random pairs at the main path's shapes (the rows
    # PERF.md has kept since the first slice) and the pair lists of the
    # largest expansion of the port's own fused mines (class-ordered), on
    # which the kernels line reports K1 and K3
    pair_sets = [("random", f"P={p} W={w} Q={q}", *pair_inputs(p, w, q, seed=11), nv)
                 for p, w, q, nv in PAIR_SHAPES]
    pair_sets += [("miner", rec["label"], rec["bitmaps"], rec["left"], rec["right"],
                   rec["sup_left"], rec["min_sup"], rec["n_valid"]) for rec in miner]
    # and the level-2 pair lists of the fused streams over their rings
    pair_sets += [("stream", rec["label"], rec["bitmaps"], rec["left"], rec["right"],
                   rec["sup_left"], rec["min_sup"], rec["n_valid"])
                  for rec in stream_rec.values()]
    for inputs, shape, bm, l, r, s, ms, nv in pair_sets:
        q, w = l.shape[0], bm.shape[1]
        # frontier rows the pairs touch, each read once, plus left/right/sup_left
        rows_read = int(torch.unique(torch.cat((l, r))).numel())
        in_bytes = rows_read * w * 4 + 3 * q * 4
        products = q * w * 32
        flags = fused_intersect_ref(bm, l, r, s, ms, mode=0)[2]
        # (name, function, plain version, TPU call site, bytes in and out,
        # in the kernels line): K1 with its (Q, W) store (the op the
        # reference package exports, and the call the non-compacting
        # engine makes each expansion), K1 store-free (fused_support_pairs,
        # the row PERF.md kept before a main path launched K1), K2, and
        # K2's given-mask front end (the word-sharded backends' compaction
        # after their all-reduce: it reads the mask, not sup_left, and
        # writes no supports)
        for name, fn, ref, replaces, nbytes, listed in (
                ("fused_intersect",
                 lambda: fused_intersect(bm, l, r, s, ms, mode=0),
                 lambda: fused_intersect_ref(bm, l, r, s, ms, mode=0),
                 f"{tpu_src}:244", in_bytes + q * w * 4 + 2 * q * 4, True),
                ("fused_intersect store-free",
                 lambda: fused_support_pairs(bm, l, r, s, ms, mode=0),
                 lambda: fused_intersect_ref(bm, l, r, s, ms, mode=0)[1:],
                 f"{tpu_src}:244", in_bytes + 2 * q * 4, False),
                ("fused_intersect_compact",
                 lambda: fused_intersect_compact(bm, l, r, s, ms, nv, mode=0),
                 lambda: fused_intersect_compact_ref(bm, l, r, s, ms, nv, mode=0),
                 f"{tpu_src}:314", in_bytes + q * w * 4 + 2 * q * 4 + 4, True),
                ("compact_survivors (given mask)",
                 lambda: compact_survivors(bm, l, r, flags, nv, mode=0),
                 lambda: compact_survivors_ref(bm, l, r, flags, nv, mode=0),
                 f"{tpu_src}:314", in_bytes + q * w * 4 + q * 4 + 4, False)):
            bms, by = bound(nbytes, products)
            rows.append(dict(name=name, listed=listed, route="cuda", inputs=inputs,
                             source=pair_src, replaces=replaces, shape=shape,
                             **timed(fn, ref), bound_ms=bms, bound_by=by))
    part_sets = [("random", f"P={p} Ws={ws} Q={q}", *pair_inputs(p, ws, q, seed=13)[:3])
                 for p, ws, q in PARTIAL_SHAPES]
    for inputs, recs in (("miner", miner), ("stream", list(stream_rec.values()))):
        for rec in recs:
            part = rank0_slice(rec["bitmaps"])
            part_sets.append((inputs, f"{rec['label']} Ws={part.shape[1]}", part,
                              rec["left"], rec["right"]))
    for inputs, shape, bm, l, r in part_sets:
        q, ws = l.shape[0], bm.shape[1]
        rows_read = int(torch.unique(torch.cat((l, r))).numel())
        in_bytes = rows_read * ws * 4 + 2 * q * 4
        # K3 as the word-sharded backends launch it (no (Q, Ws) store: the
        # survivor rows are computed by K2's given-mask front end after the
        # reduce), and with its store
        for name, fn, ref, out_bytes, listed in (
                ("fused_intersect_partial",
                 lambda: fused_intersect_partial(bm, l, r, mode=0, store=False),
                 lambda: fused_intersect_partial_ref(bm, l, r, mode=0)[1],
                 q * 4, True),
                ("fused_intersect_partial with (Q, Ws) store",
                 lambda: fused_intersect_partial(bm, l, r, mode=0),
                 lambda: fused_intersect_partial_ref(bm, l, r, mode=0),
                 q * ws * 4 + q * 4, False)):
            bms, by = bound(in_bytes + out_bytes, q * ws * 32)
            rows.append(dict(name=name, listed=listed, route="cuda", inputs=inputs,
                             source=pair_src, replaces=f"{tpu_src}:196",
                             shape=shape, **timed(fn, ref),
                             bound_ms=bms, bound_by=by))
    for m, w in PS_SHAPES:
        a = tri_inputs(m, w, seed=m)
        b = tri_inputs(m, w, seed=w)
        bms, by = bound((3 * m * w + m) * 4, m * w * 32)
        rows.append(dict(name="popcount_support", listed=True, route="cuda", inputs="random",
                         source="src/repro_torch/csrc/popcount_support.cu",
                         replaces="src/repro/kernels/popcount_support/popcount_support.py:72",
                         shape=f"M={m} W={w}",
                         **timed(lambda: intersect_support(a, b),
                                 lambda: popcount_support_ref(a, b)),
                         bound_ms=bms, bound_by=by))
    for n, w in TRI_TIMED_SHAPES + SLIDE_SHAPES:
        bm = tri_inputs(n, w, seed=5)
        slide = (n, w) in SLIDE_SHAPES
        unpack = unpacked_indicator(bm)
        dense = unpack()
        lib = lambda: torch._int_mm(dense, dense.t())
        got = lib()[:n, :n]
        require(torch.equal(got, cooccurrence(bm)),
                f"torch._int_mm yardstick disagrees with trimatrix at ({n}, {w})")
        bms, by = bound(n * w * 4 + n * n * 4, n * (n + 1) // 2 * w * 32)
        rows.append(dict(name="trimatrix", listed=True, route="cuda", inputs="random",
                         source="src/repro_torch/csrc/trimatrix.cu",
                         replaces="src/repro/kernels/trimatrix/trimatrix.py:71",
                         shape=f"N={n} W={w}" + (" (stream push)" if slide else ""),
                         **timed(lambda: cooccurrence(bm), lambda: trimatrix_ref(bm),
                                 lib, plain_reps=3, plain_warmup=1),
                         library_unpack_ms=device_ms(unpack),
                         split_plan=split_plan(n, w),
                         sweep=split_sweep(bm) if slide else None,
                         bound_ms=bms, bound_by=by))
        del dense
    for row in rows:
        row["launches"] = launches[row["name"]] if row["listed"] else 0
        lib = (f"{row['library_ms']:.5f} (CUDA events per call)"
               if row["library_ms"] is not None else "None")
        extra = ""
        if "library_unpack_ms" in row:
            extra = (f"; the unpack feeding torch._int_mm "
                     f"{row['library_unpack_ms']:.5f} ms device (not in library_ms); "
                     f"split plan (splits, words per split) {row['split_plan']}")
        if row.get("sweep"):
            best = min(row["sweep"], key=row["sweep"].get)
            extra += ("; device ms per call by forced split (splits, words per "
                      "split): " + ", ".join(f"{k} {v:.5f}" for k, v in row["sweep"].items())
                      + f"; fastest {best}, split_plan picks {row['split_plan']}")
        print(f"timing {row['name']} ({row['inputs']} pairs) {row['shape']}: "
              f"ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}) library_ms={lib} "
              f"launches_on_main_path={row['launches']}; per call with the "
              f"host's launch work: call_ms={row['call_ms']:.5f} "
              f"plain_call_ms={row['plain_call_ms']:.5f}{extra}")
        # a bound is a floor: nothing that computes the function may beat it
        for key in ("ms", "plain_ms", "library_ms"):
            if row[key] is not None:
                require(row["bound_ms"] <= row[key],
                        f"{row['name']} {row['shape']}: bound_ms "
                        f"{row['bound_ms']:.5f} exceeds {key} {row[key]:.5f}")
    print("timing note: ms and plain_ms of the mining rows are device "
          "time per call (calls run back to back behind a sleep of the "
          "card; K4's zero fill included where it splits the words), "
          "call_ms CUDA events around each call; fused_intersect is timed "
          "with its (Q, W) store, as the non-compacting engine launches it "
          "(its launches are run_no_compaction's; the compacting path runs "
          "its arithmetic inside fused_intersect_compact's pass), and "
          "store-free beside it; fused_intersect_partial is timed "
          "store-free, as the word-sharded backends use it; "
          "fused_intersect_partial "
          "launches are rank 0's of the tidsharded 1x4 mines; miner pairs "
          "are the pair lists of the largest expansion of the fused mines "
          "of chess and T10I4D100K (fused_intersect_partial: rank 0's word "
          "slice at 4 shards), on which the kernels line reports "
          "fused_intersect and fused_intersect_partial; "
          "popcount_support is on no path (0 launches); trimatrix "
          "library_ms is torch._int_mm over the unpacked 0/1 int8 "
          "indicator, rows padded to a multiple of 8, timed with CUDA "
          "events as in earlier runs, the unpack timed apart (device); "
          "trimatrix launches are the fused mines' and the fused streams' "
          "(one per warming push, two per evicting push); stream pairs are "
          "the largest level-2 expansion of each fused stream over its ring "
          "(universe item ids in support order), timed but not in the "
          "kernels line")
    return rows


# ---------------------------------------------------------------------------
# LM serving phases (gemma3-4b)
# ---------------------------------------------------------------------------

def compare_attention(name, got, want, what):
    """A kernel's output ``got`` against its plain version's float32 output
    ``want`` on the same inputs, within ATTN_TOL_F32 (float32) or half a
    bf16 unit in the last place (bfloat16), both finite.  Records the
    largest absolute difference from the plain version's output in the
    kernel's dtype; returns it and the largest |got - want| / limit."""
    import torch
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(want.dtype == torch.float32, f"{what}: plain version not run in float32")
    g = got.float()
    require(bool(torch.isfinite(g).all()), f"{what}: non-finite kernel output")
    if got.dtype == torch.float32:
        limit = torch.full_like(want, ATTN_TOL_F32)
    else:
        limit = ATTN_BF16_REL * want.abs() + ATTN_BF16_ATOL
    err = float((g - want.to(got.dtype).float()).abs().max()) if g.numel() else 0.0
    ratio = float(((g - want).abs() / limit).max()) if g.numel() else 0.0
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR[name], err)
    require(ratio <= 1.0, f"{what}: error {ratio:.3f} x its limit (max abs err "
                          f"{err:.3e} from the plain output in {got.dtype})")
    return err, ratio


LIMIT_TEXT = {"float32": f"{ATTN_TOL_F32:.0e} abs",
              "bfloat16": f"2^-8 |want| + {ATTN_BF16_ATOL:.0e}"}


def attn_inputs(b, h, hkv, s, d, dtype, seed, model_layout=False):
    """Seeded normal q, k, v on the card as (B, H, S, D) tensors; with
    ``model_layout`` they are (B, H, S, D) views of (B, S, H, D) tensors,
    as the model passes them."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def draw(n):
        if model_layout:
            return torch.randn((b, s, n, d), generator=g, device="cuda",
                               dtype=torch.float32).to(dtype).transpose(1, 2)
        return torch.randn((b, n, s, d), generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)
    return draw(h), draw(hkv), draw(hkv)


def check_flash_attention():
    """K6 against its plain version: bfloat16 through the wgmma kernel (and
    against the emulation of its split-P arithmetic), float32 through the
    FMA kernel; each case launches only its dtype's variant, and two calls
    give the same bits."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     attention_split_p_ref,
                                                     flash_attention,
                                                     multi_head_attention)
    # (label, B, H, Hkv, S, D, causal, window, model layout, soft-cap)
    cases = [
        ("gemma3-4b global", 2, 8, 4, 2048, 256, True, 0, True, 0.0),
        ("gemma3-4b local", 2, 8, 4, 2048, 256, True, 1024, True, 0.0),
        ("ragged S=1000 local", 2, 8, 4, 1000, 256, True, 1024, False, 0.0),
        ("ragged S=37 window 8", 1, 8, 4, 37, 256, True, 8, False, 0.0),
        ("G=1", 1, 8, 8, 300, 256, True, 0, False, 0.0),
        ("G=8 (gemma-2b MQA)", 1, 8, 1, 2048, 256, True, 0, True, 0.0),
        ("non-causal window 100", 1, 4, 2, 333, 128, False, 100, False, 0.0),
        ("D=16 (reduced configs)", 2, 4, 1, 50, 16, True, 8, True, 0.0),
        ("internlm2/grok layer G=6", 2, 48, 8, 2048, 128, True, 0, True, 0.0),
        ("grok layer G=6 soft-cap", 2, 48, 8, 2048, 128, True, 0, True, CAP),
        ("llama4 layer G=5", 2, 40, 8, 2048, 128, True, 0, True, 0.0),
        ("soft-cap ragged window 100", 1, 12, 2, 333, 128, True, 100, False, CAP),
        ("hymba layer G=5", 2, 25, 5, 2048, 64, True, 2048, True, 0.0),
        ("hymba layer S=1536", 2, 25, 5, 1536, 64, True, 2048, True, 0.0),
        ("hymba heads window 1000", 2, 25, 5, 2048, 64, True, 1000, True, 0.0),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        limit = LIMIT_TEXT[str(dtype).split(".")[1]]
        name, variant = (("flash_attention", "wgmma_bf16") if dtype == torch.bfloat16
                         else ("flash_attention_f32", "fma_f32"))
        for label, b, h, hkv, s, d, causal, window, layout, cap in cases:
            q, k, v = attn_inputs(b, h, hkv, s, d, dtype, seed=s + h + d, model_layout=layout)
            if cap:
                q = (q.float() * CAP_Q_SCALE).to(dtype)
            kernels.reset_launch_counts()
            got = multi_head_attention(q, k, v, causal=causal, window=window, softcap=cap)
            again = multi_head_attention(q, k, v, causal=causal, window=window, softcap=cap)
            counts = kernels.variant_counts()
            want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                 window=window or None, softcap=cap)
            torch.cuda.synchronize()
            require(counts == {**{f"flash_attention.{x}": 2 if x == variant else 0
                                  for x in ("wgmma_bf16", "fma_f32")},
                               "flash_attention_bwd.wgmma_bf16": 0,
                               "flash_attention_bwd.fma_f32": 0},
                    f"flash_attention {label} {dtype}: variant launches {counts}")
            require(torch.equal(got, again),
                    f"flash_attention {label} {dtype}: two calls differ")
            err, ratio = compare_attention(name, got, want,
                                           f"flash_attention {label} {dtype}")
            split = ""
            if dtype == torch.bfloat16:
                # the kernel against the plain emulation of its arithmetic
                # (split P), run in float32, under the same bf16 limit
                emu = attention_split_p_ref(q.float(), k.float(), v.float(), causal=causal,
                                            window=window or None, softcap=cap)
                _, emu_ratio = compare_attention(name, got, emu,
                                                 f"flash_attention {label} {dtype} vs split-P")
                split = f"; vs the split-P emulation at {emu_ratio:.3f} x the limit"
            print(f"check flash_attention {label} B={b} H={h} Hkv={hkv} S={s} "
                  f"D={d} causal={causal} window={window} softcap={cap} {dtype} "
                  f"({variant}): max "
                  f"abs err {err:.3e} from the plain output; error vs float32 at "
                  f"{ratio:.3f} x its limit ({limit}){split}; two calls equal")
        # window 0 and None both mean none; the kernel's 0 is the same
        q, k, v = attn_inputs(1, 8, 4, 129, 256, dtype, seed=5)
        a = multi_head_attention(q, k, v, causal=True, window=0)
        b_ = multi_head_attention(q, k, v, causal=True, window=None)
        c = flash_attention(q, k, v, causal=True, window=0)
        require(torch.equal(a, b_) and torch.equal(a, c),
                f"window 0 and None differ on the card ({dtype})")
        print(f"check flash_attention window=0 == window=None == kernel "
              f"window 0 ({dtype}): equal")


def check_decode_attention():
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      grouped_decode_attention)
    # (B, KV, G, D, lengths, soft-cap[, windows]), windows 0 and 1,024
    # where a case names none
    # lengths at the kernel's 64-row chunk edges (64, 65, 2,047, 2,080) with
    # every group size from 1 to 8; windows of 1,024 start inside a chunk;
    # the decode shapes of internlm2/grok (KV = 8, G = 6, D = 128) and
    # llama4 (G = 5), with and without grok's soft-cap; hymba's (KV = 5,
    # G = 5, D = 64) at the lengths of its last decode steps, where its
    # window of 2,048 drops the first rows
    cases = [(2, 4, 2, 256, [1, 2080], 0.0), (2, 4, 2, 256, [2079, 1537], 0.0),
             (4, 1, 8, 256, [1, 777, 2079, 2080], 0.0), (3, 2, 4, 16, [5, 64, 65], 0.0),
             (2, 4, 1, 128, [1000, 3], 0.0), (2, 4, 2, 256, [64, 2047], 0.0),
             (4, 4, 1, 256, [64, 65, 2047, 2080], 0.0),
             (4, 2, 4, 256, [65, 64, 2080, 2047], 0.0),
             (4, 1, 8, 256, [2047, 65, 64, 2080], 0.0),
             (2, 8, 6, 128, [2079, 1537], 0.0), (2, 8, 6, 128, [2079, 1537], CAP),
             (2, 8, 5, 128, [1, 2080], 0.0), (2, 8, 5, 128, [64, 2047], CAP),
             (3, 2, 3, 128, [64, 65, 2047], 0.0), (3, 2, 3, 128, [1, 65, 2080], CAP),
             (4, 1, 7, 256, [1, 777, 2079, 2080], 0.0),
             (4, 1, 7, 128, [65, 64, 2080, 2047], CAP),
             (2, 4, 2, 256, [2079, 1537], CAP), (4, 1, 8, 128, [1, 777, 2079, 2080], CAP),
             (2, 5, 5, 64, [2049, 2079], 0.0, (0, 2048)),
             (4, 5, 5, 64, [1537, 2064, 2050, 2080], 0.0, (0, 2048))]
    s = 2080
    for dtype in (torch.bfloat16, torch.float32):
        limit = LIMIT_TEXT[str(dtype).split(".")[1]]
        for b, kv, g, d, lens, cap, *windows in cases:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(b * 100 + g + d)
            q = torch.randn((b, kv, g, d), generator=gen, device="cuda")
            q = (q * CAP_Q_SCALE if cap else q).to(dtype)
            # the layer slice of a stacked per-stage cache, as the model has it
            cache = torch.randn((2, 2, b, s, kv, d), generator=gen,
                                device="cuda").to(dtype)
            k, v = cache[0, 1], cache[1, 1]
            length = torch.tensor(lens, dtype=torch.int32, device="cuda")
            for window in (windows[0] if windows else (0, 1024)):
                got = grouped_decode_attention(q, k, v, length, window=window, softcap=cap)
                again = grouped_decode_attention(q, k, v, length, window=window, softcap=cap)
                want = decode_attention_ref(q.float(), k.float(), v.float(),
                                            length, window=window, softcap=cap)
                torch.cuda.synchronize()
                require(torch.equal(got, again),
                        f"decode_attention B={b} KV={kv} G={g} len={lens} "
                        f"window={window} softcap={cap} {dtype}: two calls differ")
                err, ratio = compare_attention(
                    "decode_attention", got, want,
                    f"decode_attention B={b} KV={kv} G={g} D={d} "
                    f"len={lens} window={window} softcap={cap} {dtype}")
                print(f"check decode_attention B={b} KV={kv} G={g} D={d} S={s} "
                      f"lengths={lens} window={window} softcap={cap} {dtype}: max abs err "
                      f"{err:.3e} from the plain output; error vs float32 at "
                      f"{ratio:.3f} x its limit ({limit}); two calls equal")


def check_slice_attention():
    """The attention kernels at this slice's new shapes, against their
    plain versions, each in its dtype's variant only and the same bits on
    a second call: K6 over keys that are not the queries (whisper's
    cross-attention, S in CROSS_ROWS over Sk = 1,500 encoder rows, D = 64,
    G = 1, non-causal; the cross K/V a layer's slice of ``cross_kv``'s
    stacked (L, B, Sk, KV, D) tensor) and K6 at phi-3-vision's prefill
    layer (D = 96, G = 1, causal), bf16 (also against the split-P
    emulation) and float32; K7 at phi3's decode step (D = 96, G = 1) and
    over whisper's 1,500 cross rows (length 1,500 for every sequence)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      grouped_decode_attention)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     attention_split_p_ref,
                                                     multi_head_attention)
    # (label, B, H, Hkv, S, Sk, D, causal)
    cases = [(f"whisper cross S={s}", 8, 8, 8, s, 1500, 64, False) for s in CROSS_ROWS]
    cases.append(("phi-3-vision prefill layer", 2, 32, 32, 2048, 2048, 96, True))
    for dtype in (torch.bfloat16, torch.float32):
        limit = LIMIT_TEXT[str(dtype).split(".")[1]]
        name, variant = (("flash_attention", "wgmma_bf16") if dtype == torch.bfloat16
                         else ("flash_attention_f32", "fma_f32"))
        for label, b, h, hkv, s, sk, d, causal in cases:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(s + sk + d)
            q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
            kv = torch.randn((2, 2, b, sk, hkv, d), generator=gen, device="cuda").to(dtype)
            q, k, v = q.transpose(1, 2), kv[0, 1].transpose(1, 2), kv[1, 1].transpose(1, 2)
            kernels.reset_launch_counts()
            got = multi_head_attention(q, k, v, causal=causal)
            again = multi_head_attention(q, k, v, causal=causal)
            counts = kernels.variant_counts()
            want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
            torch.cuda.synchronize()
            require(counts[f"flash_attention.{variant}"] == 2 and
                    kernels.launch_counts()["flash_attention"] == 2,
                    f"flash_attention {label} {dtype}: variant launches {counts}")
            require(torch.equal(got, again), f"flash_attention {label} {dtype}: two calls differ")
            err, ratio = compare_attention(name, got, want, f"flash_attention {label} {dtype}")
            split = ""
            if dtype == torch.bfloat16:
                emu = attention_split_p_ref(q.float(), k.float(), v.float(), causal=causal)
                _, emu_ratio = compare_attention(name, got, emu,
                                                 f"flash_attention {label} {dtype} vs split-P")
                split = f"; vs the split-P emulation at {emu_ratio:.3f} x the limit"
            print(f"check flash_attention {label} B={b} H={h} Hkv={hkv} S={s} Sk={sk} D={d} "
                  f"causal={causal} {dtype} ({variant}): max abs err {err:.3e} from the "
                  f"plain output; error vs float32 at {ratio:.3f} x its limit ({limit})"
                  f"{split}; two calls equal")
            del q, k, v, kv, got, again, want
        # (label, B, KV, D, cache rows, lengths)
        for label, b, kv, d, rows, lens in (
                ("phi-3-vision decode", 2, 32, 96, 2080, [1, 2079]),
                ("phi-3-vision decode ragged", 2, 32, 96, 2080, [2079, 1537]),
                ("whisper cross rows", 8, 8, 64, 1500, [1500] * 8)):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(rows + d)
            q = torch.randn((b, kv, 1, d), generator=gen, device="cuda").to(dtype)
            cache = torch.randn((2, 2, b, rows, kv, d), generator=gen, device="cuda").to(dtype)
            k, v = cache[0, 1], cache[1, 1]
            length = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = grouped_decode_attention(q, k, v, length)
            again = grouped_decode_attention(q, k, v, length)
            want = decode_attention_ref(q.float(), k.float(), v.float(), length)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"decode_attention {label} {dtype}: two calls differ")
            err, ratio = compare_attention("decode_attention", got, want,
                                           f"decode_attention {label} {dtype}")
            print(f"check decode_attention {label} B={b} KV={kv} G=1 D={d} S={rows} "
                  f"lengths={lens[:2]}{'...' if len(lens) > 2 else ''} {dtype}: max abs err "
                  f"{err:.3e} from the plain output; error vs float32 at {ratio:.3f} x its "
                  f"limit ({limit}); two calls equal")
        torch.cuda.empty_cache()


def serve_requests(vocab):
    import numpy as np
    from repro_torch.launch.serve_profile import SERVE_MAX_NEW, SERVE_PROMPTS
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=SERVE_MAX_NEW)
            for i, n in enumerate(SERVE_PROMPTS)]


def _serve_twice(cfg, params):
    """ServingEngine.serve of the serving traffic twice on the same weights:
    every request answered in the vocabulary, K6 (its wgmma variant only)
    once per attention layer and prefill sub-batch and K7 once per
    attention layer and decode step (a gate of 0 for a model with no
    attention layer, xlstm), the same greedy outputs twice.  Prints each
    serve's prefill s, decode ms a step, tokens/s and peak memory.  Returns
    the first serve's launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.serve_profile import (SERVE_BATCHES, SERVE_MAX_NEW,
                                                  SERVE_PROMPTS, SERVE_S_MAX)
    from repro_torch.models import Model, stages_meta
    from repro_torch.serving import ServingEngine

    n_layers = sum(c for _, c in stages_meta(cfg))
    n_attn = _attention_layers(cfg)
    model = Model(cfg)
    reqs = serve_requests(cfg.vocab_size)
    outputs, first_counts = [], None
    for run in range(2):
        engine = ServingEngine(model, params, s_max=SERVE_S_MAX)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, stats = engine.serve(reqs, n_batches=SERVE_BATCHES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        counts.update(kernels.variant_counts())
        n_sub = stats["latency"]["n_batches"]
        steps = stats["decode_steps"]
        n_tok = sum(len(o) for o in results.values())
        lat = stats["latency"]
        print(f"serve {cfg.name} ({n_layers} layers) run {run}: {len(results)} requests "
              f"({SERVE_PROMPTS} prompt tokens, {SERVE_MAX_NEW} new each, {SERVE_BATCHES} "
              f"batches -> {n_sub} prefill sub-batches, {steps} decode steps) "
              f"wall_s={wall:.4f} prefill_s={stats['phase_s']['prefill']:.4f} "
              f"decode_s={stats['phase_s']['decode']:.4f} "
              f"decode_ms_per_step={stats['phase_s']['decode'] / steps * 1e3:.3f} "
              f"generated_tokens={n_tok} tokens_per_s={n_tok / wall:.2f} "
              f"answer_ms p50={lat['answer_ms']['p50']:.1f} p99={lat['answer_ms']['p99']:.1f} "
              f"pack_eff={stats['padding_efficiency']:.3f} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"launches={counts}")
        require(len(results) == len(reqs), f"{cfg.name}: not every request was answered")
        for r in reqs:
            o = results[r.rid]
            require(o.shape == (SERVE_MAX_NEW,) and o.dtype == np.int32,
                    f"{cfg.name} request {r.rid}: output {o.shape} {o.dtype}")
            require(bool(((o >= 0) & (o < cfg.vocab_size)).all()),
                    f"{cfg.name} request {r.rid}: token out of the vocabulary")
        require(counts["flash_attention"] == n_attn * n_sub,
                f"{cfg.name}: flash_attention launched {counts['flash_attention']} times, "
                f"expected {n_attn} per prefill sub-batch x {n_sub}")
        require(counts["flash_attention.wgmma_bf16"] == n_attn * n_sub and
                counts["flash_attention.fma_f32"] == 0,
                f"{cfg.name}: the bf16 serve launched the flash_attention variants "
                f"wgmma_bf16 {counts['flash_attention.wgmma_bf16']} times and "
                f"fma_f32 {counts['flash_attention.fma_f32']} times, expected "
                f"{n_attn * n_sub} and 0")
        require(counts["decode_attention"] == n_attn * steps,
                f"{cfg.name}: decode_attention launched {counts['decode_attention']} "
                f"times, expected {n_attn} per decode step x {steps}")
        require(all(counts[k] == 0 for k in MINING_KERNELS),
                "serving launched a mining kernel")
        outputs.append(results)
        if first_counts is None:
            first_counts = counts
    for r in reqs:
        require(np.array_equal(outputs[0][r.rid], outputs[1][r.rid]),
                f"{cfg.name} request {r.rid}: greedy outputs differ between two runs")
    print(f"serve {cfg.name}: greedy outputs identical across two runs "
          f"(request 0 starts {outputs[0][0][:8].tolist()})")
    _decode_step_syncs(model, params)
    return first_counts


def _attention_layers(cfg):
    """The layers of ``cfg`` that run attention (K6 in a prefill, K7 in a
    decode step): all but the mLSTM and sLSTM blocks."""
    from repro_torch.models import stages_meta
    from repro_torch.models.transformer import has_attention
    return sum(c for k, c in stages_meta(cfg) if has_attention(k))


def _attention_launches(cfg):
    """(K6 a prefill, K7 a decode step, K6 an encoding) of ``cfg``: one of
    each per attention layer; whisper's decoder layers attend twice (self,
    then cross over the encoder's rows) and its encoder layers once."""
    if cfg.n_encoder_layers:
        return 2 * cfg.n_layers, 2 * cfg.n_layers, cfg.n_encoder_layers
    n = _attention_layers(cfg)
    return n, n, 0


def _cross_kv(model, params, frames):
    """An encoder-decoder's cross K/V of ``frames`` (``Model.encode`` then
    ``Model.cross_kv``), None for ``frames`` None."""
    if frames is None:
        return None
    return model.cross_kv(params, model.encode(params, frames))


def _decode_step_syncs(model, params, frames=None):
    """Host syncs in one ``Model.decode_step`` of the served model (2
    sequences after an 8-token prefill; an encoder-decoder over the cross
    K/V of the first 2 of ``frames``, made before), counted by torch's
    sync-debug mode (one warning per synchronising call); the step must make
    none, so the engine's one read of the step's tokens is a step's only
    wait."""
    import warnings
    import torch
    toks = torch.arange(16, device="cuda").reshape(2, 8) % model.cfg.vocab_size
    with torch.inference_mode():
        enc = _cross_kv(model, params, None if frames is None else frames[:2])
        logits, cache = model.prefill(params, {"tokens": toks}, 16, enc_out=enc)
        token = logits.argmax(-1)
        pos = torch.full((2,), 8, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                model.decode_step(params, token, cache, pos, enc_out=enc)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchronizing CUDA operation" in str(w.message) for w in seen)
    print(f"serve {model.cfg.name}: host syncs in one decode step "
          f"(Model.decode_step, sync-debug count)={syncs}")
    require(syncs == 0, f"{model.cfg.name}: a decode step synchronised with the "
            f"host {syncs} times")


def _init_served(arch):
    """The served model of ``arch`` (launch.serve_profile's depth) at full
    width, bf16, random weights from a generator seeded 0 on the card,
    its parameter count held to the config's tree (``param_shapes``) and,
    but for hymba and whisper, to the config's analytic count (which
    leaves out the final norm and every layernorm's bias and, of hymba's
    SSM, the conv taps and most of ``a_log``, of whisper ``enc_pos``, the
    encoder's final norm and the decoder's ``normx``: it is printed there,
    not held)."""
    import math
    import torch
    from repro_torch.launch.serve_profile import served_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import param_shapes
    cfg = served_config(arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"serve init {cfg.name} ({cfg.n_layers} layers): {n_params} parameters "
          f"({cfg.dtype}, {n_bytes / 1e9:.2f} GB; config param_count "
          f"{cfg.param_count()}) in {time.perf_counter() - t0:.2f}s, "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f}")
    require(n_params == sum(math.prod(t) for t in _leaves(param_shapes(cfg))),
            f"{cfg.name}: parameter count differs from the config's tree")
    # the final norm, and with layernorm its bias and the layers' 2 biases
    norms = cfg.d_model * (2 * cfg.n_layers + 2 if cfg.norm == "layernorm" else 1)
    require(cfg.hybrid or cfg.n_encoder_layers or
            n_params == cfg.param_count() + norms,
            f"{cfg.name}: parameter count differs from the config's analytic count")
    return cfg, params


def run_serving():
    """gemma3-4b at full width and depth, bf16, random weights from a seeded
    generator: ServingEngine.serve twice on the same requests.  Returns the
    params, the config and the launch counts of the first serve."""
    from repro_torch.launch.serve_profile import ARCH
    cfg, params = _init_served(ARCH)
    require(cfg.n_layers == 34, f"gemma3-4b has {cfg.n_layers} layers, expected 34")
    return params, cfg, _serve_twice(cfg, params)


def _moe_stats(cfg, params):
    """Each MoE layer's dropped share and expert load on the prefill of the
    serving traffic's first sub-batch (2 prompts of 2,048 tokens) at the
    config's capacity: the layer's output is the served one; its aux is
    read through a spy on the transformer's ``moe`` (a patch of this
    process only)."""
    import numpy as np
    import torch
    import repro_torch.models.transformer as tr
    from repro_torch.launch.serve_profile import SERVE_PROMPTS, SERVE_S_MAX
    from repro_torch.models import Model
    reqs = [r for r in serve_requests(cfg.vocab_size)
            if r.prompt.shape[0] == max(SERVE_PROMPTS)][:2]
    toks = torch.from_numpy(np.stack([r.prompt for r in reqs]).astype(np.int64)).cuda()
    seen, real = [], tr.moe

    def spy(*args, **kwargs):
        out, aux = real(*args, **kwargs)
        seen.append({k: v.detach().float().cpu() for k, v in aux.items()})
        return out, aux
    tr.moe = spy
    try:
        with torch.inference_mode():
            Model(cfg).prefill(params, {"tokens": toks}, SERVE_S_MAX)
    finally:
        tr.moe = real
    moe_layers = [i for i, k in enumerate(cfg.layer_pattern()) if k.endswith("+moe")]
    require(len(seen) == len(moe_layers), f"{cfg.name}: {len(seen)} MoE calls in a "
            f"prefill, expected {len(moe_layers)}")
    for i, aux in zip(moe_layers, seen):
        load = aux["expert_load"]
        require(abs(float(load.sum()) - 1.0) < 1e-5 and bool(torch.isfinite(aux["aux_loss"])),
                f"{cfg.name} layer {i}: expert load {load.tolist()}")
        print(f"moe {cfg.name} layer {i} (top-{cfg.top_k} of {cfg.n_experts}, capacity "
              f"factor {cfg.capacity_factor}, {toks.numel()} tokens): dropped_frac="
              f"{float(aux['dropped_frac']):.4f} aux_loss={float(aux['aux_loss']):.4f} "
              f"expert load (top-1 share) min={float(load.min()):.4f} "
              f"max={float(load.max()):.4f} max/mean={float(load.max() * cfg.n_experts):.3f} "
              f"cv={float(load.std() / load.mean()):.3f} experts with no top-1 "
              f"token={int((load == 0).sum())}")


def _depth_cut(cfg, params, n):
    """(config, params) of the first ``n`` layers at full width: the
    stacked leaves sliced and copied (so the rest can be freed), the
    embedding, head and final norm shared.  A model of ``n`` layers is
    returned as it is."""
    import dataclasses
    from repro_torch.models import stages_meta
    if cfg.n_layers == n:
        return cfg, params
    cut = dataclasses.replace(cfg, n_layers=n)
    stages, left = {}, n
    for i, (_, count) in enumerate(stages_meta(cfg)):
        take = min(count, left)
        if take == 0:
            break
        stages[f"s{i}"] = {k: v[:take].clone() for k, v in params["stages"][f"s{i}"].items()}
        left -= take
    require([c for _, c in stages_meta(cut)] ==
            [next(iter(v.values())).shape[0] for v in stages.values()],
            f"{cfg.name}: depth cut")
    return cut, {**{k: v for k, v in params.items() if k != "stages"}, "stages": stages}


def run_model_serving(arch):
    """One of the models added after gemma3-4b at full width (bf16, random
    weights from a seeded generator, depth cut to fit the card): the
    serving traffic twice (_serve_twice), the MoE layers' drops and expert
    load, then on a copy of its first DEPTH_CUT layers (CUT_LAYERS) at full
    width the kernel path against the plain path and
    decode-matches-prefill (_check_cut_model).  Returns the first serve's
    launch counts."""
    import gc
    import torch
    cfg, params = _init_served(arch)
    counts = _serve_twice(cfg, params)
    if cfg.n_experts:
        _moe_stats(cfg, params)
    cut_cfg, cut = _depth_cut(cfg, params, CUT_LAYERS.get(arch, DEPTH_CUT))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _check_cut_model(cut_cfg, cut)
    del cut
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def run_whisper_serving():
    """whisper-base at full width and depth (6 encoder and 6 decoder layers,
    bf16, random weights from a generator seeded 0): its serving traffic
    (launch.serve_profile: 8 clips of 1,500 frame embeddings, the 4-token
    start-of-transcript prompt, 224 greedy tokens) through
    ``serve_profile.transcribe`` twice: ``encode`` -> ``cross_kv`` once,
    the prefill, the decode steps.  K6 once per encoder layer and twice per
    decoder layer (self, then cross at Sk = 1,500 != S) in the wgmma
    variant only, K7 twice per decoder layer and decode step (self, then
    over the 1,500 cross rows), the same greedy tokens twice, no host sync
    in a decode step; then decode-matches-prefill and the kernel path
    against the plain path over the first WHISPER_CHECK tokens of clip 0's
    transcript.  Returns the first serve's launch counts, with the
    attention kernels' split by what they attend over
    (``kernels.shape_counts``)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.serve_profile import (CLIPS, TRANSCRIBE_NEW,
                                                  TRANSCRIBE_PROMPT,
                                                  TRANSCRIBE_S_MAX, clip_embeds,
                                                  transcribe)
    from repro_torch.models import Model
    cfg, params = _init_served("whisper-base")
    require(cfg.n_layers == 6 and cfg.n_encoder_layers == 6 and cfg.encoder_len == 1500,
            f"whisper-base: {cfg.n_encoder_layers} + {cfg.n_layers} layers")
    model = Model(cfg)
    frames = clip_embeds(cfg, CLIPS, "cuda")
    prompt = torch.tensor([TRANSCRIBE_PROMPT] * CLIPS, device="cuda")
    k6_prefill, k7_step, k6_encode = _attention_launches(cfg)
    outputs, first = [], None
    for run in range(2):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, stats = transcribe(model, params, frames, prompt, TRANSCRIBE_NEW,
                                 TRANSCRIBE_S_MAX)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**kernels.launch_counts(), **kernels.variant_counts(),
                  **kernels.shape_counts()}
        steps = stats["decode_steps"]
        print(f"serve {cfg.name} ({cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder "
              f"layers) run {run}: {CLIPS} clips x {cfg.encoder_len} frames, prompt "
              f"{list(TRANSCRIBE_PROMPT)}, {TRANSCRIBE_NEW} greedy tokens each "
              f"({steps} decode steps) wall_s={wall:.4f} encode_s={stats['encode_s']:.4f} "
              f"prefill_s={stats['prefill_s']:.4f} decode_s={stats['decode_s']:.4f} "
              f"decode_ms_per_step={stats['decode_s'] / steps * 1e3:.3f} "
              f"generated_tokens={toks.size} tokens_per_s={toks.size / wall:.2f} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"launches={counts}")
        require(toks.shape == (CLIPS, TRANSCRIBE_NEW) and toks.dtype == np.int32 and
                bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                f"{cfg.name}: tokens {toks.shape} {toks.dtype} out of the vocabulary")
        want = {"flash_attention": k6_encode + k6_prefill,
                "flash_attention.wgmma_bf16": k6_encode + k6_prefill,
                "flash_attention.fma_f32": 0, "decode_attention": k7_step * steps}
        require(all(counts[k] == n for k, n in want.items()) and
                all(counts[k] == 0 for k in MINING_KERNELS),
                f"{cfg.name}: launches {counts}, expected {want}")
        # the split: the encoder's non-causal layers, the decoder's causal
        # self-attention and cross-attention in the prefill; each decode
        # step's self rows (the cache's TRANSCRIBE_S_MAX) and cross rows
        by_shape = {"flash_attention.full": cfg.n_encoder_layers,
                    "flash_attention.causal": cfg.n_layers,
                    "flash_attention.cross": cfg.n_layers,
                    f"decode_attention.rows={TRANSCRIBE_S_MAX}": cfg.n_layers * steps,
                    f"decode_attention.rows={cfg.encoder_len}": cfg.n_layers * steps}
        require(all(counts.get(k) == n for k, n in by_shape.items()),
                f"{cfg.name}: attention launches by shape {counts}, expected {by_shape}")
        outputs.append(toks)
        if first is None:
            first = counts
    require(np.array_equal(outputs[0], outputs[1]),
            f"{cfg.name}: greedy outputs differ between two runs")
    print(f"serve {cfg.name}: greedy outputs identical across two runs (clip 0 starts "
          f"{outputs[0][0][:8].tolist()})")
    _decode_step_syncs(model, params, frames)
    check = torch.from_numpy(np.concatenate(
        [np.asarray(TRANSCRIBE_PROMPT, np.int64),
         outputs[0][0, :WHISPER_CHECK - len(TRANSCRIBE_PROMPT)]]))[None].cuda()
    _kernel_vs_plain_and_decode(
        f"{cfg.name} (all {cfg.n_encoder_layers} + {cfg.n_layers} layers, clip 0, "
        f"{WHISPER_CHECK} tokens)", cfg, params, _cast(params, torch.float32), check,
        TRANSCRIBE_S_MAX, frames[:1])
    return first


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _both_paths(p, cfg, prompt, dtype, s_max, frames=None):
    """Last-position logits of ``prompt`` (1, S) prefilled whole, and
    prefilled to S - DECODE_K then decoded DECODE_K steps, by the model of
    ``cfg`` in ``dtype`` on the weights ``p``; both finite.  An
    encoder-decoder encodes ``frames`` (1, Se, D) once, and both paths read
    its cross K/V."""
    import dataclasses
    import torch
    from repro_torch.models import Model
    model = Model(dataclasses.replace(cfg, dtype=dtype))
    split = prompt.shape[1] - DECODE_K
    with torch.inference_mode():
        enc = _cross_kv(model, p, frames)
        full, _ = model.prefill(p, {"tokens": prompt}, s_max, enc_out=enc)
        logits, cache = model.prefill(p, {"tokens": prompt[:, :split]}, s_max,
                                      enc_out=enc)
        for t in range(split, prompt.shape[1]):
            pos = torch.full((1,), t, dtype=torch.int32, device="cuda")
            logits, cache = model.decode_step(p, prompt[:, t:t + 1], cache, pos,
                                              enc_out=enc)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(full).all() and torch.isfinite(logits).all()),
            f"{cfg.name} {dtype}: non-finite logits")
    return full, logits


@contextlib.contextmanager
def _plain_attention():
    """The model with the attention kernels' plain versions in their place
    (a patch of this process only; the package has no switch for it); the
    run launches no kernel."""
    import repro_torch.models.attention as attn_mod
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    saved = attn_mod.multi_head_attention, attn_mod.grouped_decode_attention
    attn_mod.multi_head_attention = lambda q, k, v, *, causal, window, sm_scale, softcap: \
        attention_ref(q, k, v, causal=causal, window=window or None, sm_scale=sm_scale,
                      softcap=softcap)
    attn_mod.grouped_decode_attention = decode_attention_ref
    kernels.reset_launch_counts()
    try:
        yield
    finally:
        attn_mod.multi_head_attention, attn_mod.grouped_decode_attention = saved
    require(not any(kernels.launch_counts().values()),
            "the plain-path run launched a kernel")


@contextlib.contextmanager
def _experts_in_float32():
    """An MoE's expert products on bf16 weights with float32 activations:
    each slot's weights cast to float32 as it is used (exact), so a float32
    model needs no float32 copy of all its experts (llama4's 128 are 32 GB
    in bf16).  A patch of this process only."""
    import torch
    import repro_torch.models.moe as moe_mod
    real = moe_mod._experts

    def per_slot(p, buf, cfg):
        if p["experts_up"].dtype == buf.dtype:
            return real(p, buf, cfg)
        names = [k for k in ("experts_up", "experts_gate", "experts_down") if k in p]
        return torch.cat([
            real({k: p[k][i:i + 1].to(buf.dtype) for k in names}, buf[i:i + 1], cfg)
            for i in range(buf.shape[0])])
    moe_mod._experts = per_slot
    try:
        yield
    finally:
        moe_mod._experts = real


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _variants_used(label, want):
    from repro_torch import kernels
    got = kernels.variant_counts()
    other = ({"wgmma_bf16", "fma_f32"} - {want}).pop()
    require(got[f"flash_attention.{want}"] > 0 and got[f"flash_attention.{other}"] == 0,
            f"{label} model runs launched flash_attention variants {got}")
    print(f"check {label} model runs: flash_attention variants {got}")


def _kernel_vs_plain_and_decode(label, cfg, p16, p32, prompt, s_max, frames=None):
    """The checks of a full-width model (gemma3-4b whole, the new models on
    a depth-cut copy): the kernel path against the plain path in float32
    (within DECODE_TOL_F32) and bf16 (within KERNELS_VS_PLAIN_BF16), and
    decode against prefill (float32 within DECODE_TOL_F32; bf16 off float32
    by at most DECODE_BF16_FACTOR times the prefill path's own bf16
    error).  ``p32``: the weights in float32 (an MoE's experts may stay
    bf16: _experts_in_float32).  A model with no attention layer (xlstm)
    launches no kernel here, so it is held to that and to
    decode-matches-prefill only.  An encoder-decoder (whisper) encodes
    ``frames`` once per path and dtype (``frames`` in float32 for the
    float32 runs: the bf16 frames cast exactly)."""
    import torch
    from repro_torch import kernels
    n_attn = _attention_layers(cfg)
    k6_prefill, k7_step, k6_encode = _attention_launches(cfg)
    f32 = None if frames is None else frames.float()
    with _experts_in_float32():
        kernels.reset_launch_counts()
        full32, dec32 = _both_paths(p32, cfg, prompt, "float32", s_max, f32)
        if n_attn:
            _variants_used(f"{label} float32", "fma_f32")
            with _plain_attention():
                plain32 = _both_paths(p32, cfg, prompt, "float32", s_max, f32)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    full16, dec16 = _both_paths(p16, cfg, prompt, "bfloat16", s_max, frames)
    counts = kernels.launch_counts()
    require(counts["flash_attention"] == 2 * k6_prefill + k6_encode and
            counts["decode_attention"] == DECODE_K * k7_step,
            f"{label}: two prefills and {DECODE_K} decode steps launched {counts}")
    if n_attn:
        _variants_used(f"{label} bfloat16", "wgmma_bf16")
        with _plain_attention():
            plain16 = _both_paths(p16, cfg, prompt, "bfloat16", s_max, frames)
        _kernels_vs_plain(label, (full32, dec32), plain32, (full16, dec16), plain16)
    else:
        print(f"check {label}: no attention layer, no kernel launched by two "
              f"prefills and {DECODE_K} decode steps in bf16")

    r32, r16 = _rel(dec32, full32), _rel(dec16, full16)
    floor, dec_err = _rel(full16, full32), _rel(dec16, full32)
    top = {n: bool(torch.equal(a.argmax(-1), b.argmax(-1)))
           for n, (a, b) in {"float32": (dec32, full32),
                             "bfloat16": (dec16, full16)}.items()}
    n = prompt.shape[1]
    print(f"check decode-matches-prefill {label} float32: prompt {n}, prefill "
          f"{n - DECODE_K} + {DECODE_K} decode steps vs prefill {n}: rel L2 err "
          f"{r32:.3e} <= {DECODE_TOL_F32:.0e}, max abs err "
          f"{float((dec32 - full32).abs().max()):.3e} (logits max abs "
          f"{float(full32.abs().max()):.3f}), same argmax {top['float32']}")
    print(f"check decode-matches-prefill {label} bfloat16: rel L2 err "
          f"{r16:.3e} (max abs {float((dec16 - full16).abs().max()):.3e}, same "
          f"argmax {top['bfloat16']}); against float32 the prefill path is off "
          f"by {floor:.3e} and the decode path by {dec_err:.3e} <= "
          f"{DECODE_BF16_FACTOR} x {floor:.3e}")
    require(r32 <= DECODE_TOL_F32,
            f"{label}: decode does not match prefill in float32: rel err {r32:.3e}")
    require(dec_err <= DECODE_BF16_FACTOR * floor,
            f"{label}: bf16 decode path off float32 by {dec_err:.3e}, more than "
            f"{DECODE_BF16_FACTOR} x the prefill path's {floor:.3e}")


def _kernels_vs_plain(label, kern32, plain32, kern16, plain16):
    """The kernel path's (prefill, decode) logits against the plain
    path's: float32 within DECODE_TOL_F32, bf16 within
    KERNELS_VS_PLAIN_BF16."""
    import torch
    (full32, dec32), (plain_full32, plain_dec32) = kern32, plain32
    (full16, dec16), (plain_full16, plain_dec16) = kern16, plain16
    kp_full, kp_dec = _rel(full32, plain_full32), _rel(dec32, plain_dec32)
    print(f"check kernels vs plain path {label} float32: prefill logits rel L2 err "
          f"{kp_full:.3e}, after {DECODE_K} decode steps {kp_dec:.3e}, both <= "
          f"{DECODE_TOL_F32:.0e}")
    require(kp_full <= DECODE_TOL_F32 and kp_dec <= DECODE_TOL_F32,
            f"{label}: the kernel path and the plain path differ (float32)")
    kp16_full, kp16_dec = _rel(full16, plain_full16), _rel(dec16, plain_dec16)
    same = (bool(torch.equal(full16.argmax(-1), plain_full16.argmax(-1))) and
            bool(torch.equal(dec16.argmax(-1), plain_dec16.argmax(-1))))
    print(f"check kernels vs plain path {label} bfloat16: prefill logits rel L2 err "
          f"{kp16_full:.3e}, after {DECODE_K} decode steps {kp16_dec:.3e}, both <= "
          f"{KERNELS_VS_PLAIN_BF16:.0e}, same argmax {same}; the plain path's own bf16 "
          f"error vs float32 is {_rel(plain_full16, plain_full32):.3e} (prefill), "
          f"{_rel(plain_dec16, plain_dec32):.3e} (decode)")
    require(kp16_full <= KERNELS_VS_PLAIN_BF16 and kp16_dec <= KERNELS_VS_PLAIN_BF16,
            f"{label}: the kernel path and the plain path differ (bfloat16)")


def check_decode_matches_prefill(params, cfg):
    """gemma3-4b, all 34 layers: logits of the last prompt position,
    prefilled whole and prefilled to 2,048 - K then decoded K steps, in
    float32 (the served weights, cast) and in bf16 (the served model); and
    in both dtypes the same two runs with the attention kernels' plain
    versions in their place."""
    import numpy as np
    import torch
    from repro_torch.launch.serve_profile import SERVE_S_MAX
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2048))).cuda()
    p32 = _cast(params, torch.float32)
    _kernel_vs_plain_and_decode(f"{cfg.name} (all {cfg.n_layers} layers)", cfg, params,
                                p32, prompt, SERVE_S_MAX)


def _check_cut_model(cfg, params):
    """A new model's first DEPTH_CUT layers at full width, bf16 weights:
    _kernel_vs_plain_and_decode over a CUT_PROMPT-token prompt, an MoE at
    capacity_factor = n_experts (no drops); float32 from the same weights
    (the experts cast slot by slot as they are used)."""
    import dataclasses
    import numpy as np
    import torch
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CUT_PROMPT))).cuda()

    def f32(tree, key=""):
        if isinstance(tree, dict):
            return {k: f32(v, k) for k, v in tree.items()}
        return tree if key.startswith("stk_experts_") else tree.float()
    _kernel_vs_plain_and_decode(
        f"{cfg.name} (first {cfg.n_layers} layers, full width"
        f"{', no-drop capacity' if cfg.n_experts else ''})", cfg, params, f32(params),
        prompt, CUT_PROMPT + 32)


def check_reduced_models():
    """The configs served after gemma3-4b, reduced, float32, on the card
    against the same weights on the CPU: prefill and 4 decode steps' logits
    within REDUCED_LOGITS_TOL, and a greedy serve token for token; also at
    the configs' own group sizes (the reduced ones have 4 heads, G = 1 or
    2): G = 6 (internlm2, grok with its soft-cap) and G = 5 (llama4,
    hymba).  K6 and K7 launch once per attention layer (xlstm: none)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models import Model, init_params
    from repro_torch.serving import Request, ServingEngine
    cases = [(a, None) for a in ("internlm2-20b", "command-r-35b", "grok-1-314b",
                                 "llama4-maverick-400b-a17b")]
    cases += [("internlm2-20b", (12, 2)), ("grok-1-314b", (12, 2)),
              ("llama4-maverick-400b-a17b", (10, 2)), ("hymba-1.5b", None),
              ("hymba-1.5b", (10, 2)), ("xlstm-1.3b", None),
              ("phi-3-vision-4.2b", None)]
    for arch, heads in cases:
        cfg = reduced_config(get_config(arch))
        if heads:
            cfg = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
        model = Model(cfg)
        host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = _cast(host, torch.float32, "cuda")
        rng = np.random.default_rng(2)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
        kernels.reset_launch_counts()
        worst = 0.0
        with torch.inference_mode():
            got, gc_ = model.prefill(card, {"tokens": toks.cuda()}, 32)
            want, wc = model.prefill(host, {"tokens": toks}, 32)
            worst = max(worst, float((got.cpu() - want).abs().max()))
            for t in range(4):
                nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
                pos = torch.full((2,), 24 + t, dtype=torch.int32)
                got, gc_ = model.decode_step(card, nxt.cuda(), gc_, pos.cuda())
                want, wc = model.decode_step(host, nxt, wc, pos)
                worst = max(worst, float((got.cpu() - want).abs().max()))
        counts = kernels.launch_counts()
        n_attn = _attention_layers(cfg)
        require(counts["flash_attention"] == n_attn and
                counts["decode_attention"] == 4 * n_attn,
                f"reduced {arch} {heads}: launches {counts}")
        require(worst <= REDUCED_LOGITS_TOL,
                f"reduced {arch} {heads}: card logits off the CPU's by {worst:.3e}")
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
                for i, n in enumerate((12, 12, 7))]
        out_card, _ = ServingEngine(model, card, s_max=32).serve(reqs, 1)
        out_host, _ = ServingEngine(model, host, s_max=32).serve(reqs, 1)
        same = all(np.array_equal(out_card[r.rid], out_host[r.rid]) for r in reqs)
        require(same, f"reduced {arch} {heads}: greedy tokens differ card vs CPU")
        g = cfg.n_heads // cfg.n_kv_heads
        print(f"check reduced {arch} float32 G={g} softcap={cfg.attn_logit_softcap}: "
              f"card vs CPU logits max abs err {worst:.3e} <= {REDUCED_LOGITS_TOL:.0e} "
              f"(prefill + 4 decode steps), greedy serve equal token for token")


# ---------------------------------------------------------------------------
# LM training phases (K6's backward, the reduced configs, gemma-2b)
# ---------------------------------------------------------------------------

def check_flash_attention_bwd():
    """K6's forward lse and its backward kernels against the plain textbook
    backward at the training shapes: gemma-2b's global layer (bf16 and
    float32), gemma3-4b's local layer (bf16) and a ragged length; with
    grok's soft-cap of 30 (q drawn CAP_Q_SCALE times larger) its training
    layer (G = 6, bf16), the reduced grok (float32), a windowed layer and
    G = 1; phi3's layer (D = 96); whisper's training layers, the
    cross-attention over keys that are not the queries (S = 448 over
    Sk = 1,500, non-causal; a ragged last k tile) and the encoder's
    non-causal self-attention (bf16 and float32); hymba's training layer
    (D = 64, G = 5, window 2,048) at B = 4 (each group's 5 heads in one
    dK/dV block) and at B = 2 (one head a block, a 5-way split summed by
    the reduction kernel), bf16 and float32, and its heads at S = 2,100,
    where the window bites; the bf16 kernels also against the emulation of
    their arithmetic; a second call gives the same bits."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import (attention_bwd_bf16_ref,
                                                     attention_lse_ref,
                                                     attention_ref_bwd,
                                                     bwd_plan, f32_plan,
                                                     flash_attention,
                                                     flash_attention_bwd)
    # (label, B, H, Hkv, S, D, window, softcap, dtypes[, Sk, causal]):
    # causal self-attention unless the last two say otherwise
    both = (torch.bfloat16, torch.float32)
    cases = [("gemma-2b global", 4, 8, 1, 1024, 256, 0, 0.0,
              (torch.bfloat16, torch.float32)),
             ("gemma3-4b local", 2, 8, 4, 2048, 256, 1024, 0.0, (torch.bfloat16,)),
             ("ragged S=1000 local", 2, 8, 4, 1000, 256, 1024, 0.0,
              (torch.bfloat16, torch.float32)),
             ("grok-1 training layer capped", *GROK_LAYER, 0, CAP, (torch.bfloat16,)),
             ("reduced grok capped", 4, 4, 4, 64, 16, 0, CAP, (torch.float32,)),
             ("capped local S=1000", 2, 12, 2, 1000, 128, 256, CAP,
              (torch.bfloat16, torch.float32)),
             ("capped G=1", 2, 8, 8, 512, 128, 0, CAP, (torch.bfloat16,)),
             ("phi-3-vision training layer D=96", *PHI3_LAYER, 0, 0.0, both),
             ("whisper-base training cross", *WHISPER_CROSS[:4], WHISPER_CROSS[5], 0, 0.0,
              both, WHISPER_CROSS[4], False),
             ("whisper-base training encoder", WHISPER_B, 8, 8, 1500, 64, 0, 0.0, both,
              1500, False),
             ("hymba-1.5b training layer", *HYMBA_TRAIN[:5], HYMBA_TRAIN[5], 0.0, both),
             ("hymba-1.5b training layer at B=2 (5-way split)", 2, *HYMBA_TRAIN[1:5],
              HYMBA_TRAIN[5], 0.0, both),
             ("hymba-1.5b heads, the window biting at S=2100", 1, 25, 5, 2100, 64,
              HYMBA_TRAIN[5], 0.0, (torch.bfloat16,))]
    # hymba's layer takes both plans: at B = 4 all 5 heads of a group in one
    # dK/dV block (320 blocks), at B = 2 one head a block, 5 float32 partials
    for b, split in ((HYMBA_TRAIN[0], 1), (2, 5)):
        p = bwd_plan(b, *HYMBA_TRAIN[1:])
        require(p.n_split == split and p.heads_per_block == 5 // split,
                f"hymba's backward plan at B={b}: {p}")
    for label, b, h, hkv, s, d, window, cap, dtypes, *other in cases:
        sk, causal = other or (s, True)
        for dtype in dtypes:
            what = f"flash_attention_bwd {label} {dtype}"
            q, k, v = attn_inputs(b, h, hkv, s, d, dtype, seed=s + h + d, model_layout=True)
            if sk != s:
                _, k, v = attn_inputs(b, hkv, hkv, sk, d, dtype, seed=sk + d,
                                      model_layout=True)
            if cap:
                q = (q.float() * CAP_Q_SCALE).to(dtype)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(s)
            dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
            kernels.reset_launch_counts()
            out, lse = flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                                       return_lse=True)
            got = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window,
                                      softcap=cap)
            again = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                        window=window, softcap=cap)
            variant = "wgmma_bf16" if dtype == torch.bfloat16 else "fma_f32"
            counts = kernels.variant_counts()
            torch.cuda.synchronize()
            kind = "cross" if sk != s else "causal" if causal else "full"
            require(counts[f"flash_attention_bwd.{variant}"] == 2 and
                    kernels.launch_counts()["flash_attention_bwd"] == 2 and
                    kernels.shape_counts()[f"flash_attention_bwd.{kind}"] == 2,
                    f"{what}: variant launches {counts}, by shape {kernels.shape_counts()}")
            args = dict(causal=causal, window=window or None, softcap=cap)
            want_lse = attention_lse_ref(q.float(), k.float(), **args)
            lse_err = float((lse - want_lse).abs().max())
            require(lse_err <= LSE_TOL, f"{what}: lse off by {lse_err:.3e}")
            want = attention_ref_bwd(q.float(), k.float(), v.float(), out.float(),
                                     dout.float(), want_lse, **args)
            emu = (attention_bwd_bf16_ref(q, k, v, out, dout, lse, **args)
                   if dtype == torch.bfloat16 else want)
            parts = []
            for name, g, a, w, e in zip(("dq", "dk", "dv"), got, again, want, emu):
                require(g.dtype == dtype and g.shape == w.shape,
                        f"{what}: {name} {g.dtype} {tuple(g.shape)}")
                require(bool(torch.isfinite(g.float()).all()), f"{what}: non-finite {name}")
                require(torch.equal(g, a), f"{what}: two calls give different {name}")
                err = float((g.float() - w.to(dtype).float()).abs().max())
                rel = float((g.float() - w).norm() / w.norm())
                MAX_ABS_ERR["flash_attention_bwd"] = max(MAX_ABS_ERR["flash_attention_bwd"], err)
                if dtype == torch.float32:
                    require(err <= BWD_TOL_F32, f"{what}: {name} max abs err {err:.3e}")
                    parts.append(f"{name} max abs err {err:.3e} rel L2 {rel:.3e}")
                    continue
                require(rel <= BWD_REL_BF16, f"{what}: {name} rel L2 err {rel:.3e}")
                e = e.to(dtype).float()
                rel_emu = float((g.float() - e).norm() / e.norm())
                require(rel_emu <= BWD_REL_EMU,
                        f"{what}: {name} rel L2 {rel_emu:.3e} from the emulation")
                parts.append(f"{name} max abs err {err:.3e} rel L2 {rel:.3e}, from the "
                             f"emulation rel L2 {rel_emu:.3e}")
            limit = (f"{BWD_TOL_F32:.0e} abs" if dtype == torch.float32
                     else f"rel L2 {BWD_REL_BF16:.0e}, emulation {BWD_REL_EMU:.0e}")
            if dtype == torch.bfloat16:
                p = bwd_plan(b, h, hkv, s, d, window, sk=sk)
                plan = (f", {p.heads_per_block} head(s) per dK/dV block, {p.n_split} "
                        f"split(s), {p.dkdv_blocks} dK/dV + {p.dq_blocks} dQ blocks")
            else:
                p = f32_plan(b, h, hkv, s, d, window, sk=sk, causal=causal)
                plan = (f", instance D={p.kd}, {p.ds_blocks} P/dS blocks, "
                        f"{p.dkdv_blocks} dK/dV + {p.dq_blocks} dQ blocks, "
                        f"{p.tiles_per_head} kept tiles a head, "
                        f"{4 * p.scratch_floats / 2 ** 20:.1f} MiB of scratch")
            print(f"check {what} B={b} H={h} Hkv={hkv} S={s} Sk={sk} D={d} "
                  f"{'causal' if causal else 'non-causal'} window={window} "
                  f"softcap={cap:g} ({variant}{plan}): lse max abs err {lse_err:.3e}; {'; '.join(parts)} "
                  f"(limit {limit}); two calls equal")
            del q, k, v, dout, out, lse, got, again, want, want_lse, emu
            torch.cuda.empty_cache()


def _train_counts():
    from repro_torch import kernels
    counts = kernels.launch_counts()
    counts.update(kernels.variant_counts())
    counts.update(kernels.shape_counts())
    return counts


def run_training_reduced():
    """The float32 reduced gemma-2b and gemma3-4b, 5 make_train_step steps
    on the card and on the CPU from the same weights and batches; K6's FMA
    forward and backward once per layer a step (the forward twice under
    remat="full", which recomputes each layer)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model, init_params, stages_meta
    from repro_torch.training import adamw_init, make_train_step
    for arch in ("gemma-2b", "gemma3-4b"):
        cfg = reduced_config(get_config(arch))
        n_layers = sum(c for _, c in stages_meta(cfg))
        pipe = TokenPipeline(cfg.vocab_size, batch=4, seq_len=64, seed=0)
        for remat in ("none", "full"):
            tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=5,
                               remat=remat)
            step = make_train_step(Model(cfg), tcfg)
            host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            card = _cast(host, torch.float32, "cuda")
            hs, cs = adamw_init(host), adamw_init(card)
            fwd = n_layers * (2 if remat == "full" else 1)
            losses, worst = [], 0.0
            for i in range(5):
                toks = torch.from_numpy(pipe.batch_at(i)["tokens"])
                kernels.reset_launch_counts()
                card, cs, cm = step(card, cs, {"tokens": toks.cuda()})
                torch.cuda.synchronize()
                counts = _train_counts()
                want = {"flash_attention.fma_f32": fwd, "flash_attention_bwd.fma_f32": n_layers,
                        "flash_attention.wgmma_bf16": 0, "flash_attention_bwd.wgmma_bf16": 0,
                        "decode_attention": 0}
                require(all(counts[k] == n for k, n in want.items()) and
                        all(counts[k] == 0 for k in MINING_KERNELS),
                        f"reduced {arch} remat={remat} step {i + 1}: launches {counts}")
                host, hs, hm = step(host, hs, {"tokens": toks})
                a, b = float(cm["loss"]), float(hm["loss"])
                worst = max(worst, abs(a - b) / abs(b))
                losses.append(a)
                require(worst <= TRAIN_F32_REL,
                        f"reduced {arch} remat={remat} step {i + 1}: loss {a} on the "
                        f"card, {b} on the CPU")
            print(f"check training reduced {arch} float32 remat={remat}: 5 steps, card "
                  f"losses {[round(x, 6) for x in losses]}, largest rel diff from the "
                  f"CPU {worst:.3e} <= {TRAIN_F32_REL:.0e}; K6 fma_f32 forward {fwd} "
                  f"and backward {n_layers} launches a step ({n_layers} layers)")


def _train_on_card(cfg, label, batch, seq, steps, every=None, plain_remat=None,
                   remat="none"):
    """``cfg`` in bf16 on the card, ``batch`` x ``seq`` tokens a step:
    ``steps`` steps, the first ``every`` through TrainingRunner.run with a
    checkpoint at step ``every``, then a fresh runner restored from it
    whose steps must equal the first run's bit for bit (with no ``every``,
    the steps in memory and no checkpoint); K6 forward and backward once a
    layer and step (wgmma_bf16), the plain attention paths raising on the
    card throughout; then step 1 again with the plain attention patched in
    (with ``plain_remat``, when given: the plain version holds each
    layer's (B, H, S, S) float32 scores, which for all layers at once may
    not fit beside the model's state).  A vision config's batches hold ``frontend_len`` image embeddings
    (normal, from a generator seeded with the step, bf16) that prefix the
    text; an encoder-decoder's hold ``encoder_len`` frame embeddings
    (normal x 0.05, the same generator), and K6 and its backward run once
    per encoder layer (non-causal) and twice per decoder layer (causal
    self, then cross at Sk != S), each split counted by
    ``kernels.shape_counts``.  Only the layers with attention launch
    (xlstm's none: its "plain" step 1 is the same step run again).  With
    ``remat="full"`` each layer's forward runs twice (the backward pass
    recomputes it), so K6's forward launches twice a layer.  Returns the
    backward kernel's launches over the kernel steps, and the run's
    numbers for the timing line (with the backward's launches by shape,
    ``bwd_by_shape``)."""
    import shutil
    import types
    import torch
    import repro_torch.kernels.flash_attention.ops as ops_mod
    import repro_torch.models.attention as attn_mod
    from repro_torch import kernels
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models import Model, init_params
    from repro_torch.training import (RunnerConfig, TrainingRunner, adamw_init,
                                      make_train_step, valid_steps)
    from repro_torch.training.optimizer import tree_leaves

    n_layers = _attention_layers(cfg)
    n_enc = cfg.n_encoder_layers
    # K6's calls a step by what they attend over: the encoder's non-causal
    # layers, the decoder's causal self-attention and its cross-attention
    by_shape = {"full": n_enc, "causal": n_layers, "cross": n_layers if n_enc else 0}
    n_attn = sum(by_shape.values())
    fwd = 2 if remat == "full" else 1
    t0 = time.perf_counter()
    pipe = TokenPipeline(cfg.vocab_size, batch=batch, seq_len=seq, seed=0)
    batches = {i: pipe.batch_at(i) for i in range(steps)}
    images = cfg.frontend_len if cfg.frontend == "vision" else 0
    frames = cfg.encoder_len if n_enc else 0

    def on_card(i):
        """Step ``i``'s batch on the card (its image or frame embeddings
        made there)."""
        out = {"tokens": torch.from_numpy(batches[i]["tokens"]).cuda()}
        if images or frames:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(i)
        if images:
            out["img_embeds"] = torch.randn((batch, images, cfg.d_model), generator=gen,
                                            device="cuda").to(torch.bfloat16)
        if frames:
            out["enc_embeds"] = (torch.randn((batch, frames, cfg.d_model), generator=gen,
                                             device="cuda") * 0.05).to(torch.bfloat16)
        return out
    extra = (f"; the first {images} positions image embeddings" if images else
             f"; {frames} frame embeddings a sequence" if frames else "")
    print(f"train data {label}: {steps} batches of {batch} x {seq} tokens "
          f"(TokenPipeline seed 0{extra}) in {time.perf_counter() - t0:.2f}s")
    # warmup 1: every step after the first (whose scheduled rate is 0, as
    # in the reference) moves the bf16 weights by more than half a unit
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=steps,
                       remat=remat)
    step = make_train_step(Model(cfg), tcfg)
    records = []

    def counted_step(p, s, b):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(p, s, b)
        torch.cuda.synchronize()
        records.append((time.perf_counter() - t, _train_counts()))
        return out

    def steps_from(runner, start):
        """The runner's state carried on from step ``start`` to the last,
        in memory (no checkpoint written); their metrics."""
        log = []
        for i in range(start, steps):
            runner.params, runner.opt_state, m = counted_step(
                runner.params, runner.opt_state, on_card(i))
            log.append({k: float(v) for k, v in m.items()})
        return log

    def fresh(seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        params = init_params(cfg, gen, "cuda")
        return params, adamw_init(params)

    def guard(fn, name):
        def wrapped(q, *a, **kw):
            if q.device.type == "cuda":
                raise SmokeFailure(f"{name} ran on the card during training")
            return fn(q, *a, **kw)
        return wrapped

    saved = attn_mod.flash_chunked, ops_mod.attention_ref
    attn_mod.flash_chunked = guard(attn_mod.flash_chunked, "flash_chunked")
    ops_mod.attention_ref = guard(ops_mod.attention_ref, "attention_ref")
    # with ``every`` the run writes one checkpoint (bf16 params, float32
    # AdamW moments), and both runs go on past it in memory
    directory = None if every is None else tempfile.mkdtemp(prefix="chip_smoke-train-")
    again, wall_b, write_s = [], None, None
    try:
        torch.cuda.reset_peak_memory_stats()
        params, opt = fresh(0)
        n_params = sum(t.numel() for t in tree_leaves(params))
        state_gb = torch.cuda.memory_allocated() / 1e9
        print(f"train init {label}: {n_params} parameters (bf16), AdamW mu/nu "
              f"float32; {state_gb:.2f} GB on the card")
        if directory is None:
            held = types.SimpleNamespace(params=params, opt_state=opt)
            del params, opt
            t = time.perf_counter()
            first = steps_from(held, 0)
            wall_a = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated()
            del held
        else:
            require(not images, "the runner's batches hold tokens only")
            runner = TrainingRunner(RunnerConfig(directory, checkpoint_every=every),
                                    counted_step, params, opt, batches.__getitem__)
            del params, opt
            t = time.perf_counter()
            require(runner.run(every) == every, "the runner stopped early")
            wall_a = time.perf_counter() - t
            write_s = runner.ckpt.last_write_s
            found = valid_steps(directory)
            require(found == [every], f"checkpoints at {found}")
            first = runner.metrics_log + steps_from(runner, every)
            peak = torch.cuda.max_memory_allocated()
            del runner
            torch.cuda.empty_cache()
            # a fresh runner (other weights) restores step `every` and replays
            params, opt = fresh(1)
            restored = TrainingRunner(RunnerConfig(directory, checkpoint_every=every),
                                      counted_step, params, opt, batches.__getitem__)
            del params, opt
            t = time.perf_counter()
            require(restored.maybe_restore() == every, f"no restore at step {every}")
            again = steps_from(restored, every)
            wall_b = time.perf_counter() - t
            del restored
        torch.cuda.empty_cache()
    finally:
        attn_mod.flash_chunked, ops_mod.attention_ref = saved
        if directory is not None:
            shutil.rmtree(directory, ignore_errors=True)
    require(len(first) == steps and len(again) == (0 if every is None else steps - every),
            f"metrics of {len(first)} and {len(again)} steps")
    for m in first:
        require(all(map(lambda x: x == x and abs(x) != float("inf"),
                        (m["loss"], m["grad_norm"]))), f"non-finite metrics {m}")
    require(every is None or again == first[every:],
            f"the restored steps differ: {again} against {first[every:]}")
    want = {"flash_attention": fwd * n_attn, "flash_attention.wgmma_bf16": fwd * n_attn,
            "flash_attention_bwd": n_attn, "flash_attention_bwd.wgmma_bf16": n_attn,
            "flash_attention.fma_f32": 0, "flash_attention_bwd.fma_f32": 0,
            "decode_attention": 0}
    want.update({f"flash_attention.{kind}": fwd * n for kind, n in by_shape.items()})
    want.update({f"flash_attention_bwd.{kind}": n for kind, n in by_shape.items()})
    for i, (_, counts) in enumerate(records):
        require("flash_attention_bwd.fma_bf16" not in counts and
                all(counts[k] == n for k, n in want.items()) and
                all(counts[k] == 0 for k in MINING_KERNELS) and
                counts["popcount_support"] == 0 and counts["fused_intersect_partial"] == 0,
                f"{label} training step call {i}: launches {counts}")
    bwd_launches = sum(c["flash_attention_bwd"] for _, c in records)
    bwd_by_shape = {kind: sum(c[f"flash_attention_bwd.{kind}"] for _, c in records)
                    for kind in by_shape}

    # step 1 again, with the plain attention patched in
    plain_step = step if plain_remat is None else make_train_step(
        Model(cfg), dataclasses.replace(tcfg, remat=plain_remat))
    params, opt = fresh(0)
    plain_mha = attn_mod.multi_head_attention
    attn_mod.multi_head_attention = lambda q, k, v, *, causal, window, sm_scale, softcap: \
        attention_ref(q, k, v, causal=causal, window=window or None, sm_scale=sm_scale,
                      softcap=softcap)
    try:
        kernels.reset_launch_counts()
        _, _, plain = plain_step(params, opt, on_card(0))
        torch.cuda.synchronize()
        plain = {k: float(v) for k, v in plain.items()}
    finally:
        attn_mod.multi_head_attention = plain_mha
    require(not any(kernels.launch_counts().values()), "the plain step launched a kernel")
    del params, opt
    torch.cuda.empty_cache()
    rel_loss = abs(plain["loss"] - first[0]["loss"]) / abs(plain["loss"])
    rel_norm = abs(plain["grad_norm"] - first[0]["grad_norm"]) / plain["grad_norm"]
    against = "the plain attention" if n_attn else "the same step run again"
    require(rel_loss <= TRAIN_PLAIN_BF16_REL and rel_norm <= TRAIN_PLAIN_BF16_REL,
            f"{label} step 1 through the kernels (loss {first[0]['loss']}, grad norm "
            f"{first[0]['grad_norm']}) against {against} (loss "
            f"{plain['loss']}, grad norm {plain['grad_norm']})")
    how = ("in memory, no checkpoint" if every is None else
           f"restored at step {every}: steps {every + 1}-{steps} bit-equal")
    split = (f" (by shape: {by_shape})" if n_enc else "")
    print(f"train {label} bf16 B={batch} S={seq} remat={remat}: losses "
          f"{[m['loss'] for m in first]} grad norms {[m['grad_norm'] for m in first]}; "
          f"{how}; K6 forward {fwd * n_attn} (wgmma_bf16) and backward {n_attn} "
          f"(wgmma_bf16) launches every step{split}, no plain attention on the card")
    same = plain["loss"] == first[0]["loss"] and plain["grad_norm"] == first[0]["grad_norm"]
    print(f"train {label}: step 1 with {against}"
          f"{'' if plain_remat is None else f' (remat={plain_remat})'}: loss {plain['loss']} "
          f"(rel diff {rel_loss:.3e}), grad norm {plain['grad_norm']} (rel diff "
          f"{rel_norm:.3e}), both <= {TRAIN_PLAIN_BF16_REL:.0e}"
          f"{'' if n_attn else f'; bit-equal: {same}'}")
    return bwd_launches, dict(step_s=[t for t, _ in records], peak=peak,
                              state_gb=state_gb, wall_a=wall_a, wall_b=wall_b,
                              write_s=write_s, bwd_by_shape=bwd_by_shape)


def _train_timing_line(label, batch, seq, steps, every, run):
    import statistics
    from repro_torch.launch.kernel_timing import nvidia_smi
    median_ms = statistics.median(run["step_s"][1:steps]) * 1e3
    print(f"train {label} timing ({nvidia_smi('name,power.limit')}): step_ms "
          f"median of steps 2-{steps} {median_ms:.1f} (all: "
          f"{[round(t * 1e3, 1) for t in run['step_s']]}), tokens_per_s "
          f"{batch * seq / median_ms * 1e3:.0f}, peak_mem_GB {run['peak'] / 1e9:.2f} "
          f"(weights and AdamW state {run['state_gb']:.2f}), " + (
              f"wall_s {run['wall_a']:.1f} ({steps} steps in memory)" if every is None
              else f"runner wall_s {run['wall_a']:.1f} ({every} steps and the "
              f"step-{every} checkpoint) + {run['wall_b']:.1f} (restore + "
              f"{steps - every} steps), checkpoint write_s {run['write_s']:.1f}"))


def run_training():
    """gemma-2b at full width and depth, bf16, B = 4, S = 1,024: 6 steps
    with a checkpoint at 3 and a restore replaying 4-6 bit for bit
    (:func:`_train_on_card`).  Returns the backward kernel's launches over
    the 9 kernel steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import stages_meta
    cfg = get_config("gemma-2b")
    n_layers = sum(c for _, c in stages_meta(cfg))
    require(n_layers == 18 and cfg.dtype == "bfloat16",
            f"gemma-2b: {n_layers} layers {cfg.dtype}, expected 18 bfloat16")
    # one checkpoint of gemma-2b (bf16 params, float32 AdamW moments) is
    # 25 GB; the card's machine allows 45 GiB of disk writes a call
    launches, run = _train_on_card(cfg, "gemma-2b", TRAIN_B, TRAIN_S, TRAIN_STEPS,
                                   TRAIN_EVERY)
    _train_timing_line("gemma-2b", TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_EVERY, run)
    return launches


@contextlib.contextmanager
def _moe_stats_printed(label):
    """Record each MoE call's dropped share and expert load while the block
    runs (``launch.train.moe_calls``, this process only), then print them
    in call order."""
    from repro_torch.launch.train import moe_calls
    with moe_calls() as calls:
        yield
    seen = [(float(d), [round(x, 4) for x in load.tolist()]) for d, load in calls]
    require(seen, f"{label}: no MoE call")
    print(f"moe {label}: {len(seen)} MoE calls (one a step); dropped_frac "
          f"{[round(d, 4) for d, _ in seen]}; expert load of the first "
          f"{seen[0][1]} and last {seen[-1][1]}")


def run_training_grok():
    """grok-1-314b at its published width cut to 1 of its 64 layers (a MoE
    of top-2 of 8 experts, attention soft-capped at 30), bf16, B = 2, S =
    1,024: GROK_STEPS steps in memory, no checkpoint (57 GB of state to
    write; ``run_training`` holds the runner's checkpoint and restore),
    K6's capped forward and backward once a step
    (:func:`_train_on_card`), each step's MoE dropped share printed, the
    peak memory against the 68.7 GB of weights, gradients and AdamW state
    the config gives.  Returns the capped backward's launches."""
    import torch
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("grok-1-314b"), n_layers=1)
    require(cfg.dtype == "bfloat16" and cfg.attn_logit_softcap == CAP,
            f"grok-1-314b: {cfg.dtype}, softcap {cfg.attn_logit_softcap}")
    with _moe_stats_printed("grok-1-314b train"):
        launches, run = _train_on_card(cfg, "grok-1-314b (1 of 64 layers)", GROK_B,
                                       GROK_S, GROK_STEPS)
    _train_timing_line("grok-1-314b (1 of 64 layers)", GROK_B, GROK_S, GROK_STEPS,
                       None, run)
    require(run["peak"] <= torch.cuda.get_device_properties(0).total_memory,
            f"grok peak {run['peak']}")
    return launches


def run_training_phi3():
    """phi-3-vision-4.2b at full width and depth (32 layers, D = 96, G = 1),
    bf16, PHI3_B x PHI3_S positions a step with the 256-position image
    prefix: PHI3_STEPS steps in memory, no remat, K6's forward and
    backward once a layer and step at D = 96, step 1 within TRAIN_PLAIN_BF16_REL of the plain
    attention (:func:`_train_on_card`, that step under remat="full"); the
    peak printed beside the 45.9 GB
    of weights, gradients and AdamW moments (3.82 G x 12 bytes) and held to
    the card.  Returns the backward's launches."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("phi-3-vision-4.2b")
    require(cfg.n_layers == 32 and cfg.head_dim == 96 and cfg.frontend_len == 256 and
            cfg.dtype == "bfloat16", f"phi-3-vision-4.2b: {cfg}")
    label = f"phi-3-vision-4.2b (image prefix {cfg.frontend_len})"
    # the plain step recomputes each layer: the plain attention's 32
    # layers of (4, 32, 1,024, 1,024) float32 scores (0.5 GB each, several
    # kept a layer) do not fit beside the 38 GB of weights and AdamW state
    launches, run = _train_on_card(cfg, label, PHI3_B, PHI3_S, PHI3_STEPS,
                                   plain_remat="full")
    _train_timing_line(label, PHI3_B, PHI3_S, PHI3_STEPS, None, run)
    print(f"train {label}: remat=none, peak_mem_GB {run['peak'] / 1e9:.2f} of "
          f"the card's {torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}; "
          f"weights, gradients and AdamW moments {cfg.param_count() * 12 / 1e9:.2f} GB "
          f"by the analytic count")
    require(run["peak"] <= torch.cuda.get_device_properties(0).total_memory,
            f"phi3 peak {run['peak']}")
    return launches


def run_training_whisper():
    """whisper-base at full width and depth (6 encoder and 6 decoder
    layers, bf16), WHISPER_B clips a step of WHISPER_S decoder tokens over
    the 1,500 encoder frames: WHISPER_STEPS steps in memory, no remat, the
    loss's encoder branch, K6's forward and backward once per encoder
    layer (non-causal) and twice per decoder layer (causal self, then
    cross at Sk = 1,500 != S) a step, step 1 within TRAIN_PLAIN_BF16_REL
    of the plain attention (under remat="full") (:func:`_train_on_card`);
    the peak printed and held to the card.  Returns the cross backward's
    launches over the kernel steps."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("whisper-base")
    require(cfg.n_layers == 6 and cfg.n_encoder_layers == 6 and cfg.encoder_len == 1500
            and (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == WHISPER_CROSS[1:3] + (64,)
            and cfg.dtype == "bfloat16", f"whisper-base: {cfg}")
    label = (f"whisper-base ({cfg.n_encoder_layers} + {cfg.n_layers} layers, "
             f"{cfg.encoder_len} frames)")
    launches, run = _train_on_card(cfg, label, WHISPER_B, WHISPER_S, WHISPER_STEPS,
                                   plain_remat="full")
    _train_timing_line(label, WHISPER_B, WHISPER_S, WHISPER_STEPS, None, run)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"train {label}: remat=none, peak_mem_GB {run['peak'] / 1e9:.2f} of the "
          f"card's {total / 1e9:.2f}; K6 backward launches over {WHISPER_STEPS} steps "
          f"{launches}, by shape {run['bwd_by_shape']}")
    require(run["peak"] <= total, f"whisper peak {run['peak']}")
    return run["bwd_by_shape"]["cross"]


def run_training_recurrent():
    """xlstm-1.3b (48 layers: 42 mLSTM, 6 sLSTM) and hymba-1.5b (32 hybrid
    layers: K6 at D = 64, G = 5 beside the SSM) at full width and depth,
    bf16, RECURRENT_B x RECURRENT_S tokens a step, RECURRENT_STEPS steps in
    memory under remat="full" (:func:`_train_on_card`): hymba's K6 forward
    twice (the backward pass recomputes each layer) and its backward once
    per layer a step, step 1 within TRAIN_PLAIN_BF16_REL of the plain
    attention; xlstm no attention kernel, step 1 held against the same
    step run again; each peak printed and held to the card.  Returns
    hymba's backward launches over its steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import stages_meta
    total = torch.cuda.get_device_properties(0).total_memory
    launches = None
    for arch, layers in (("hymba-1.5b", [("hybrid", 32)]),
                         ("xlstm-1.3b", [("mlstm", 7), ("slstm", 1)] * 6)):
        cfg = get_config(arch)
        require(stages_meta(cfg) == layers and cfg.dtype == "bfloat16",
                f"{arch}: stages {stages_meta(cfg)} {cfg.dtype}")
        n, run = _train_on_card(cfg, arch, RECURRENT_B, RECURRENT_S, RECURRENT_STEPS,
                                remat="full")
        _train_timing_line(arch, RECURRENT_B, RECURRENT_S, RECURRENT_STEPS, None, run)
        print(f"train {arch}: remat=full, peak_mem_GB {run['peak'] / 1e9:.2f} of the "
              f"card's {total / 1e9:.2f}; weights, gradients and AdamW moments "
              f"{cfg.param_count() * 12 / 1e9:.2f} GB by the analytic count")
        require(run["peak"] <= total, f"{arch} peak {run['peak']}")
        if arch == "hymba-1.5b":
            launches = n
    return launches


def _stage_of(cfg, kind, tree):
    """The stacked leaves of a layer of ``kind`` in ``tree`` (the parameter
    tree's shapes, or its placements)."""
    from repro_torch.models import stages_meta
    if kind == "enc":
        return tree["enc_stages"]["e0"]
    return tree["stages"][next(f"s{i}" for i, (k, _) in enumerate(stages_meta(cfg))
                               if k.split("+")[0] == kind)]


def _split_leaves(cfg, names, kind):
    """How many of a layer's ``names`` the tiny mesh's placement splits over
    ``model``."""
    from repro_torch.dist.sharding import spec_tree
    from repro_torch.launch.mesh import named_mesh_layout
    from repro_torch.models.convert import param_shapes
    specs = _stage_of(cfg, kind, spec_tree(param_shapes(cfg), named_mesh_layout("tiny"),
                                           cfg.expert_sharding, cfg.mlp_dp))
    return sum(any(e == "model" for e in specs[f"stk_{n}"])
               for n in names if f"stk_{n}" in specs)


def _layer_parts(cfg, kind, sp):
    """The model-axis parts of one layer of ``kind`` on the tiny mesh, in
    forward order, and whether its last op is the output of a
    tensor-parallel part (which the recompute of remat="full" stops
    before)."""
    from repro_torch.models.attention import head_split
    from repro_torch.models.convert import param_shapes
    from repro_torch.models.mlp import mlp_split
    from repro_torch.models.ssm import ssm_split
    from repro_torch.models.xlstm import mlstm_split, slstm_split
    tp = (cfg.n_kv_heads * cfg.head_dim) % 2 == 0
    form = head_split(cfg, 2)

    def tp_part(*inner):
        return [TP_ENTER[sp], *inner, TP_LEAVE[sp]]

    def whole(n_weights):
        return ([UNSPLIT] * (n_weights + 1) + [SPLIT]) if sp else [UNSPLIT] * n_weights

    attn = (tp_part(*([COL_GATHER] if form != "heads" else [])) if tp else
            whole(_split_leaves(cfg, ("wq", "wk", "wv", "wo"), kind)))
    cross = (tp_part(*([COL_GATHER] if form == "all" else [])) if tp else
             whole(_split_leaves(cfg, ("xwq", "xwo"), kind)))
    if mlp_split(cfg, 2):
        ffn = tp_part()
    else:
        ffn = [SPLIT, UNSPLIT] if cfg.mlp_dp and not sp else []
    blocks = {"hybrid": (ssm_split, "ssm_", [COL_GATHER] + [GRAD_SUM] * 3),
              "mlstm": (mlstm_split, "m_", [COL_GATHER] * 3),
              "slstm": (slstm_split, "s_", [COL_GATHER])}
    block = []
    if kind in blocks:
        split, prefix, inner = blocks[kind]
        names = [k[4:] for k in _stage_of(cfg, kind, param_shapes(cfg))
                 if k.startswith("stk_" + prefix)]
        block = tp_part(*inner) if split(cfg, 2) else whole(_split_leaves(cfg, names, kind))
    parts = {"attn": attn + ffn, "local": attn + ffn, "enc": attn + ffn,
             "xdec": attn + cross + ffn, "hybrid": attn + block + ffn,
             "mlstm": block, "slstm": block}[kind]
    last = (ffn if kind not in ("mlstm", "slstm") else block)[-1:] == [TP_LEAVE[sp]]
    return parts, last


def step_collectives(cfg, n_leaves, chunks, remat="none"):
    """The collectives one train step makes on each rank of the tiny mesh
    (one microbatch, no MoE), worked out from the config, with or without
    ``seq_parallel`` and ``mlp_dp``, whatever the model axis splits: on
    ``model`` each layer's parts (:func:`_layer_parts`; under remat="full"
    each decoder layer's forward ops again but a last tensor-parallel
    output, which the recompute stops before), the embedding's (an
    all-reduce of the vocab-parallel lookup, a reduce-scatter under
    sequence parallelism, or the cut of a replicated lookup to the rank's
    rows), an encoder's frames cut to the rank's rows, the cross K/V's input
    and their gathers (an MQA or every-head form), the loss's (the hidden
    state's gradient summed, or its rows gathered whole; a chunk's max and
    sums), the global norm's and one all-reduce of every leaf a rank
    computes with on its own rows (the norms' under sequence parallelism, a
    replicated FFN's under it or ``mlp_dp``); on ``data`` the mask count,
    the loss and every leaf."""
    from repro_torch.models import stages_meta
    from repro_torch.models.attention import head_split
    from repro_torch.models.convert import param_shapes
    from repro_torch.models.mlp import mlp_split
    sp = cfg.seq_parallel
    ops = {}

    def add(pairs, times=1):
        for f, b in pairs:
            for op in f + b:
                ops[op] = ops.get(op, 0) + times

    per_step = []
    if cfg.vocab_size % 2 == 0:
        per_step.append((["reduce_scatter"], ["all_gather"]) if sp else (["all_reduce"], []))
        per_step.append(COL_GATHER if sp else GRAD_SUM)
        per_step += [(["all_reduce_max", "all_reduce"], [])] * chunks
    elif sp:
        per_step += [SPLIT, UNSPLIT]
    stages = stages_meta(cfg)
    if cfg.n_encoder_layers:
        stages = stages + [("enc", cfg.n_encoder_layers)]
        tp = (cfg.n_kv_heads * cfg.head_dim) % 2 == 0
        per_step += ([SPLIT] if sp else []) + (
            [TP_ENTER[sp]] if tp else [UNSPLIT] if sp else [])
        if tp and head_split(cfg, 2) != "heads":
            per_step += [COL_GATHER] * sum(1 for k, _ in stages_meta(cfg) if k == "xdec")
    add(per_step)
    for kind, count in stages:
        parts, last = _layer_parts(cfg, kind.split("+")[0], sp)
        add(parts, count)
        if remat == "full" and kind != "enc":
            again = [op for f, _ in parts for op in f]
            add([(again[:-1] if last else again, [])], count)
    sums = 0
    for path, _ in _flat_leaves(param_shapes(cfg)):
        name = path.split("/")[-1].removeprefix("stk_")
        ffn = name in ("w_up", "w_gate", "w_down") and not mlp_split(cfg, 2)
        sums += (sp and ("norm" in path or ffn)) or (cfg.mlp_dp and ffn)
    ops["all_reduce"] = ops.get("all_reduce", 0) + 1 + sums
    return {"data": {"all_reduce": 2 + n_leaves}, "model": ops}


def _flat_leaves(tree, path=()):
    """(the '/'-joined path, leaf) of every leaf of a tree of dicts, in
    sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def moe_step_collectives(cfg, microbatches=1, mesh="tiny"):
    """The collectives one train step of a mixture of experts makes on each
    rank of ``mesh`` (a name or (shape, axes)) whose data axes split every
    microbatch, worked out from the config and the placement (no MQA
    gathers; one loss chunk).  On ``model``, per microbatch, two a layer
    forward and backward for attention and two for its MLP (the experts'
    only when the axis has more than one rank), and the vocab-parallel
    embedding's, loss sum's and hidden gradient's with a loss chunk's max
    (a vocabulary split over more than one rank); then the global norm's.
    On each data axis, per microbatch, the mask count and the loss, two a
    MoE layer (its top-1 counts and kept entries, its aux loss) and the
    experts' exchanges: ``ep`` two all-to-alls forward and two backward
    over ``data`` alone (the experts are replicated over ``pod``), ``tp2d``
    a gather and a reduce-scatter forward and their conjugates backward
    over each data axis; then one all-gather of the batch's tokens with two
    microbatches or more (each microbatch is the reference's global rows),
    every leaf its placement does not split over the axis, and the norm's
    (one all-reduce an axis for each set of axes leaves are split over).
    Under ``seq_parallel`` each tensor-parallel part on ``model`` gathers the
    sequence in front and reduce-scatters after (an all-gather and a
    reduce-scatter each way for its two all-reduces), the embedding
    reduce-scatters its sum and the loss gathers the hidden rows, a MoE
    layer gathers its data shard's sequence whole (an all-gather forward,
    one backward for the cut back to the rank's rows), and every norm's
    leaf and, with ``mlp_dp``, the replicated dense FFN's are summed over
    ``model`` a step; ``mlp_dp`` runs that FFN on the rank's rows."""
    from repro_torch.dist.sharding import data_axes, spec_axes, spec_tree
    from repro_torch.launch.mesh import mesh_layout, named_mesh_layout
    from repro_torch.models import stages_meta
    from repro_torch.models.convert import param_shapes
    from repro_torch.training.optimizer import tree_leaves
    layout = (named_mesh_layout(mesh) if isinstance(mesh, str) else mesh_layout(*mesh))
    m = microbatches
    meta = stages_meta(cfg)
    layers = sum(n for _, n in meta)
    n_moe = sum(n for kind, n in meta if kind.endswith("+moe"))
    tree = spec_tree(param_shapes(cfg), layout, cfg.expert_sharding, cfg.mlp_dp)
    named = [{a for e in sp for a in spec_axes(e)} for sp in tree_leaves(tree)]
    norm_sets = {tuple(sorted(axes)) for axes in named if axes}
    out = {}
    for a in data_axes(layout):
        per = {"all_reduce": m * (2 + 2 * n_moe)}
        if cfg.expert_sharding == "tp2d":
            per.update(all_gather=m * 2 * n_moe, reduce_scatter=m * 2 * n_moe)
        elif a == "data":
            per["all_to_all"] = m * 4 * n_moe
        if m > 1:
            per["all_gather"] = per.get("all_gather", 0) + 1
        per["all_reduce"] += (sum(a not in axes for axes in named)
                              + sum(a in axes for axes in norm_sets))
        out[a] = per
    size = layout.shape.get("model", 1)
    split_vocab = size > 1 and cfg.vocab_size % size == 0
    experts = 2 * n_moe if size > 1 else 0
    dense = 0 if cfg.mlp_dp else 2 * (layers - n_moe)
    norm = sum("model" in axes for axes in norm_sets)
    sp = cfg.seq_parallel and size > 1
    summed = 0
    if size > 1:
        for (path, _), axes in zip(_flat_leaves(tree), named):
            ffn = path.endswith(("w_up", "w_gate", "w_down"))
            summed += "model" not in axes and ((sp and ("norm" in path or ffn))
                                               or (cfg.mlp_dp and ffn))
    if sp:
        tp = 2 * layers + dense + (2 if split_vocab else 0)
        model = {"all_reduce": m * (experts + (1 if split_vocab else 0)) + norm + summed,
                 "all_gather": m * (tp + 2 * n_moe), "reduce_scatter": m * tp}
    else:
        model = {"all_reduce": m * (2 * layers + dense + experts
                                    + (3 if split_vocab else 0)) + norm + summed}
        if cfg.mlp_dp and size > 1:
            model["all_gather"] = m * 2 * (layers - n_moe)
    if split_vocab:
        model["all_reduce_max"] = m
    out["model"] = model
    return out


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _tree_equal(a, b):
    import numpy as np
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_tree_equal(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def _k6_step_launches(cfg, remat="none"):
    """K6's launches in one train step of ``cfg`` on one rank, by what they
    attend over (``kernels.shape_counts``): an encoder's non-causal layers
    (``full``), the decoder's attention layers (``causal``) and an
    encoder-decoder's cross-attention (``cross``), forward and backward;
    under ``remat="full"`` the decoder's forward twice (the backward
    recomputes it)."""
    dec = _attention_layers(cfg)
    enc = cfg.n_encoder_layers
    again = 2 if remat == "full" else 1
    fwd = {"full": enc, "causal": again * dec, "cross": again * dec if enc else 0}
    bwd = {"full": enc, "causal": dec, "cross": dec if enc else 0}
    return ({f"flash_attention.{m}": n for m, n in fwd.items()} |
            {f"flash_attention_bwd.{m}": n for m, n in bwd.items()})


def _check_mesh_steps(what, per_rank, n_layers, variant, declared, shapes=None):
    """Every step of every rank launched K6's ``variant`` forward and
    backward once per attention layer (``n_layers`` of them; or ``shapes``,
    :func:`_k6_step_launches`' counts by mask, summed) and nothing else of
    the package, and made the declared collectives."""
    other = "fma_f32" if variant == "wgmma_bf16" else "wgmma_bf16"
    fwd = bwd = n_layers
    if shapes is not None:
        fwd = sum(n for k, n in shapes.items() if k.startswith("flash_attention."))
        bwd = sum(n for k, n in shapes.items() if k.startswith("flash_attention_bwd."))
    want = {f"flash_attention.{variant}": fwd,
            f"flash_attention_bwd.{variant}": bwd,
            f"flash_attention.{other}": 0, f"flash_attention_bwd.{other}": 0,
            "decode_attention": 0, "popcount_support": 0,
            "fused_intersect_partial": 0, **(shapes or {})}
    for r, res in enumerate(per_rank):
        for i, rec in enumerate(res["records"]):
            counts = rec["launches"]
            require(all(counts[k] == n for k, n in want.items()) and
                    all(counts[k] == 0 for k in MINING_KERNELS),
                    f"{what} rank {r} step {i + 1}: launches {counts}")
            got = {a: {op: c["calls"] for op, c in ops.items()}
                   for a, ops in rec["collectives"].items()}
            require(got == declared,
                    f"{what} rank {r} step {i + 1}: collectives {got}, declared {declared}")


def _check_moe_steps(what, got, want, tokens, tol=1e-6):
    """Each step's MoE calls (``train_run``'s ``moe_stats``) on the card
    against the same job's on the host: the same top-1 counts (expert load
    times ``tokens``, the global tokens of a microbatch) and dropped shares
    within ``tol`` (float32 rounding of a mean taken in another order)."""
    import numpy as np
    require(len(got) == len(want), f"{what}: {len(got)} steps, host {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        require(len(a["moe"]) == len(b["moe"]) > 0,
                f"{what} step {i + 1}: MoE calls {len(a['moe'])}, host {len(b['moe'])}")
        for (da, la), (db, lb) in zip(a["moe"], b["moe"]):
            require(np.array_equal(np.rint(np.asarray(la) * tokens),
                                   np.rint(np.asarray(lb) * tokens)) and
                    abs(da - db) <= tol,
                    f"{what} step {i + 1}: expert load {la} dropped {da}, host "
                    f"{lb} dropped {db}")


def run_mesh_training():
    """Training on the reference's tiny mesh, (data, model) = (2, 2), on 4
    gloo ranks sharing the card (NCCL refuses two ranks on one card), all
    jobs in one start of the ranks: (a) the float32 reduced gemma-2b and
    gemma3-4b, 3 steps, against the same model in one CPU process from the
    same weights and batches, and the reduced grok-1 (tp2d) and
    llama4-maverick (ep) at their own capacity factors against the same
    jobs on 4 gloo ranks of the host (the same routing groups per data
    shard, so the same drops): losses, and each step's expert load and
    dropped share; the float32 reduced xlstm-1.3b and hymba-1.5b (their
    mLSTM, sLSTM and SSM blocks tensor-parallel), whisper-base (its encoder
    and cross-attention; a vocabulary of 257 too, replicated),
    phi-3-vision-4.2b (its image prefix) and hymba-1.5b with 5 heads (every
    head on every rank) against one CPU process (MESH_REDUCED_ARCHS);
    (b) gemma-2b at full width in bf16, 4 of its
    18 layers, B = 4, S = 1,024, 3 steps, against the same model on one
    rank of the card; (c) a TrainingRunner restored on the mesh from its
    step-2 checkpoint replaying step 3 bit for bit; (d) xlstm-1.3b at full
    width, 8 of its 48 layers, bf16, the same way as (b)
    (:func:`_check_full_width_mesh`); (e) whisper-base, phi-3-vision-4.2b
    and hymba-1.5b at full width (MESH_FULL) the same way.  Every step of
    every rank launches K6 forward and backward once per attention layer
    (the decoder's forward twice under remat="full") and makes the
    declared collectives.  Returns the lead rank's K6 launches in (b) and
    (e), by job and mask (``shape_counts``' keys), (h)'s added to (b)'s,
    and the float32 ones of (f) and (g).

    (g) the float32 reduced jobs of MESH_SP_JOBS, the same way as (a):
    ``seq_parallel``, ``mlp_dp`` and the parts of a layer the model axis
    does not split; (h) (b)'s model, weights and batches with
    ``seq_parallel`` and ``mlp_dp``, against (b) and (b)'s one rank
    (:func:`_check_sequence_parallel_mesh`)."""
    import shutil
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.launch.kernel_timing import nvidia_smi
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.mesh_runs import run_jobs
    from repro_torch.launch.train import step_embeds, train_run
    from repro_torch.models import init_params
    from repro_torch.dist.sharding import spec_axes, spec_tree
    from repro_torch.launch.mesh import named_mesh_layout
    from repro_torch.models.convert import param_shapes
    from repro_torch.training.optimizer import tree_leaves

    root = tempfile.mkdtemp(prefix="chip_smoke-mesh-train-")
    rate = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    jobs = {}
    for label in MESH_REDUCED_ARCHS:
        arch, over = MESH_REDUCED_CFG.get(label, (label, {}))
        cfg = dataclasses.replace(reduced_config(get_config(arch)), **over)
        host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        # the image or frame embeddings made on the host, so that the card's
        # ranks and the CPU process read the same numbers
        embeds = [{k: v.numpy() for k, v in step_embeds(cfg, i, 4, "cpu").items()}
                  for i in range(3)]
        jobs[label] = dict(kind="train", mesh="tiny", arch=arch, reduced=True, cfg=over,
                           steps=3, batch=4, seq=64, tcfg=rate, params=_np_tree(host),
                           embeds=embeds if embeds[0] else None,
                           moe_stats=bool(cfg.n_experts),
                           remat=MESH_REDUCED_REMAT.get(label, "none"))
    # (f): the mixtures of experts with microbatches and over (pod, data)
    for label, (arch, b, m, mesh) in MESH_MOE_JOBS.items():
        jobs[label] = dict(jobs[arch], mesh=mesh, batch=b, microbatches=m)
    # (c): 2 steps through the runner, a checkpoint at step 2, step 3 in
    # memory; then other weights restored from that checkpoint, step 3
    jobs["ckpt"] = dict(jobs["gemma-2b"], steps=2, ckpt_dir=os.path.join(root, "c"),
                        ckpt_every=2, then=1, gather=True)
    jobs["restored"] = dict(jobs["ckpt"], steps=1, then=0, params=None, seed=1)
    jobs["full"] = dict(kind="train", mesh="tiny", arch="gemma-2b",
                        cfg={"n_layers": MESH_LAYERS}, steps=MESH_STEPS,
                        batch=MESH_B, seq=MESH_S, tcfg=dict(rate, total_steps=MESH_STEPS))
    # (h): (b)'s model, weights and batches with seq_parallel and mlp_dp
    jobs["full sp"] = dict(jobs["full"], cfg=dict(jobs["full"]["cfg"], seq_parallel=True,
                                                  mlp_dp=True))
    # (d): xlstm-1.3b at full width, its first CUT_LAYERS layers (7 mLSTM
    # and an sLSTM), bf16
    jobs["xlstm full"] = dict(jobs["full"], arch="xlstm-1.3b",
                              cfg={"n_layers": CUT_LAYERS["xlstm-1.3b"]})
    # (e): whisper-base, phi-3-vision-4.2b and hymba-1.5b at full width, bf16
    for arch, (layers, b, seq, remat) in MESH_FULL.items():
        jobs[f"{arch} full"] = dict(jobs["full"], arch=arch, batch=b, seq=seq,
                                    remat=remat,
                                    cfg={} if layers is None else {"n_layers": layers})
    labels = list(jobs)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cuda",
                             args=([jobs[k] for k in labels],), timeout=600)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t
    res = {k: [r[i] for r in per_rank] for i, k in enumerate(labels)}
    # the MoE jobs again on 4 gloo ranks of the host
    moe_archs = [a for a in MESH_REDUCED_ARCHS
                 if get_config(jobs[a]["arch"]).n_experts] + list(MESH_MOE_JOBS)
    t = time.perf_counter()
    on_host = run_ranks(run_jobs, 4, backend="gloo", device="cpu",
                        args=([jobs[a] for a in moe_archs],), timeout=600)
    host_wall = time.perf_counter() - t
    host_res = {a: [r[i] for r in on_host] for i, a in enumerate(moe_archs)}
    for k, rs in list(res.items()) + [(f"{a} on the host", x) for a, x in host_res.items()]:
        for r, x in enumerate(rs):
            require("error" not in x, f"mesh training {k} rank {r}: {x.get('error')}")

    # (a) float32 against one CPU process, a MoE against the host's mesh
    for arch in MESH_REDUCED_ARCHS:
        cfg = dataclasses.replace(reduced_config(get_config(jobs[arch]["arch"])),
                                  **jobs[arch]["cfg"])
        n_layers = _attention_layers(cfg)
        against = "4 gloo ranks of the host" if cfg.n_experts else "one CPU process"
        hosts = (host_res[arch] if cfg.n_experts else
                 [train_run(dict(jobs[arch], mesh=None), torch.device("cpu"))] * 4)
        worst = 0.0
        for r, (x, host) in enumerate(zip(res[arch], hosts)):
            for i, (a, b) in enumerate(zip(x["losses"], host["losses"])):
                worst = max(worst, abs(a - b) / abs(b))
                require(abs(a - b) <= TRAIN_F32_REL * abs(b),
                        f"mesh {arch} float32 rank {r} step {i + 1}: loss {a}, "
                        f"{against} {b}")
            if cfg.n_experts:
                _check_moe_steps(f"mesh {arch} float32 rank {r}", x["records"],
                                 host["records"], 4 * 64)
        n_leaves = len(tree_leaves(param_shapes(cfg)))
        remat = jobs[arch]["remat"]
        declared = (moe_step_collectives(cfg) if cfg.n_experts else
                    step_collectives(cfg, n_leaves, 1, remat))
        k6 = _k6_step_launches(cfg, remat)
        _check_mesh_steps(f"mesh {arch} float32", res[arch], n_layers, "fma_f32",
                          declared, k6)
        if cfg.n_experts:
            dropped = [[round(d, 4) for d, _ in rec["moe"]] for rec in res[arch][0]["records"]]
            require(any(d > 0 for step in dropped for d in step),
                    f"mesh {arch}: no step dropped an entry {dropped}")
            print(f"moe mesh {arch} float32, capacity factor {cfg.capacity_factor}: "
                  f"dropped_frac a step and MoE layer {dropped}, each layer's expert "
                  f"load and dropped share equal on the card and on the host's mesh "
                  f"(host ranks started and run in {host_wall:.1f}s)")
        print(f"check mesh training reduced {arch} float32, tiny mesh on 4 gloo "
              f"ranks sharing the card: 3 steps, losses {res[arch][0]['losses']}, "
              f"largest rel diff from {against} {worst:.3e} <= "
              f"{TRAIN_F32_REL:.0e} on every rank; K6 fma_f32 forward and backward "
              f"{sum(n for k, n in k6.items() if k.startswith('flash_attention.'))} "
              f"launches a step on every rank; collectives a step "
              f"{declared} on every rank, as declared")
        if cfg.n_experts:
            recs = [rec for x in res[arch] for rec in x["records"][1:]]
            step_ms = statistics.median(rec["s"] for rec in recs) * 1e3
            share = {a: round(sum(rec["collective_s"].get(a, 0.0) for rec in recs) /
                              sum(rec["s"] for rec in recs), 3) for a in ("data", "model")}
            print(f"train mesh {arch} reduced float32 timing "
                  f"({nvidia_smi('name,power.limit')}): 4 gloo ranks, step_ms median "
                  f"over ranks and steps 2-3 {step_ms:.1f}, collectives' share of a "
                  f"step by axis (host time inside them, waits for the card "
                  f"included) {share}, {cfg.expert_sharding} expert exchanges "
                  f"{ {op: n for op, n in declared['data'].items() if op != 'all_reduce'} }"
                  f" a step")

    # (f) microbatches and two data axes against the host's ranks
    for label, (arch, b, m, mesh) in MESH_MOE_JOBS.items():
        _check_moe_mesh_job(label, jobs[label], res[label], host_res[label], host_wall)

    # (c) restore on the mesh: step 3 replayed bit for bit
    lead_a = next(x for x in res["ckpt"] if x["lead"])
    lead_b = next(x for x in res["restored"] if x["lead"])
    for x in res["restored"]:
        require(x["resumed"] == 2 and x["final"] == 3,
                f"restored runner: steps {x['resumed']}->{x['final']}")
        require(x["losses"] == lead_a["losses"][2:],
                f"restored step 3 loss {x['losses']} != {lead_a['losses'][2:]}")
    require(_tree_equal(lead_b["params"], lead_a["params"]),
            "the restored runner's step-3 params differ from the uninterrupted run's")
    print(f"check mesh training restore: a TrainingRunner restored on the tiny "
          f"mesh from its step-2 checkpoint (lead rank wrote the global arrays) "
          f"replays step 3 bit for bit: loss {lead_b['losses'][0]} and every "
          f"gathered parameter equal")

    # (b) full width, bf16, against one rank of the card
    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=MESH_LAYERS)
    require(cfg.dtype == "bfloat16", f"gemma-2b dtype {cfg.dtype}")
    declared = step_collectives(cfg, len(tree_leaves(param_shapes(cfg))),
                                -(-MESH_S // 512))
    lead, one = _check_full_width_mesh(
        f"gemma-2b bf16 full width, {MESH_LAYERS} of 18 layers", res["full"],
        jobs["full"], MESH_LAYERS, declared,
        f"K6 wgmma_bf16 forward and backward {MESH_LAYERS} launches a step on every "
        f"rank (B=2 H=4 Hkv=1 S=1024 D=256 causal)")
    # (h) the same with seq_parallel and mlp_dp, against (b) and its one rank
    lead_sp = _check_sequence_parallel_mesh(res["full sp"], jobs["full sp"], res["full"],
                                            one)
    print(f"mesh training: ranks started and all jobs run in {wall:.1f}s")
    # (d) xlstm-1.3b at full width, bf16, against one rank of the card
    n = CUT_LAYERS["xlstm-1.3b"]
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=n)
    declared = step_collectives(cfg, len(tree_leaves(param_shapes(cfg))),
                                -(-MESH_S // 512))
    _check_full_width_mesh(f"xlstm-1.3b bf16 full width, {n} of 48 layers (7 mLSTM, "
                           "1 sLSTM)", res["xlstm full"], jobs["xlstm full"], 0,
                           declared, "no kernel launched")
    # (e) whisper-base, phi-3-vision-4.2b, hymba-1.5b at full width, bf16
    leads = {"gemma-2b": lead}
    for arch, (layers, b, seq, remat) in MESH_FULL.items():
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        shapes = _k6_step_launches(cfg, remat)
        declared = step_collectives(cfg, len(tree_leaves(param_shapes(cfg))),
                                    -(-seq // 512), remat)
        depth = ("full depth" if layers is None else
                 f"{layers} of {get_config(arch).n_layers} layers")
        leads[arch], _ = _check_full_width_mesh(
            f"{arch} bf16 full width, {depth}, remat={remat}", res[f"{arch} full"],
            jobs[f"{arch} full"], None, declared,
            f"K6 wgmma_bf16 launches a step on every rank by mask {shapes}", shapes)
    out = {arch: {k: sum(rec["launches"][k] for rec in x["records"])
                  for k in _k6_step_launches(get_config("gemma-2b"))}
           for arch, x in leads.items()}
    # (h) runs K6 at (b)'s rank shapes: its launches join (b)'s row
    for k in out["gemma-2b"]:
        out["gemma-2b"][k] += sum(rec["launches"][k] for rec in lead_sp["records"])
    # (f)'s and (g)'s float32 launches on the lead rank, for the kernels line
    f32_jobs = list(MESH_MOE_JOBS) + list(MESH_SP_JOBS)
    out["f32 bwd"] = sum(rec["launches"]["flash_attention_bwd.fma_f32"]
                         for label in f32_jobs
                         for x in res[label] if x["lead"] for rec in x["records"])
    out["f32 fwd"] = sum(rec["launches"]["flash_attention.fma_f32"]
                         for label in f32_jobs
                         for x in res[label] if x["lead"] for rec in x["records"])
    return out


def _check_moe_mesh_job(label, job, per_rank, host, host_wall):
    """A reduced float32 mixture of experts with microbatches or on a mesh
    of two data axes (MESH_MOE_JOBS) on 4 gloo ranks sharing the card
    against the same job on 4 gloo ranks of the host: each step's loss
    within TRAIN_F32_REL, each MoE call's top-1 counts exactly and its
    dropped share within 1e-7, some entry dropped; every step of every rank
    launches K6's float32 forward and backward once per attention layer
    per microbatch and makes the declared collectives.  Prints the step ms
    per rank with the card's name and power limit."""
    import dataclasses
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.launch.kernel_timing import nvidia_smi
    cfg = dataclasses.replace(reduced_config(get_config(job["arch"])), **job["cfg"])
    m = job["microbatches"]
    worst = 0.0
    for r, (x, h) in enumerate(zip(per_rank, host)):
        for i, (a, b) in enumerate(zip(x["losses"], h["losses"])):
            worst = max(worst, abs(a - b) / abs(b))
            require(abs(a - b) <= TRAIN_F32_REL * abs(b),
                    f"mesh {label} rank {r} step {i + 1}: loss {a}, host ranks {b}")
        _check_moe_steps(f"mesh {label} rank {r}", x["records"], h["records"],
                         job["batch"] // m * job["seq"], tol=1e-7)
    declared = moe_step_collectives(cfg, m, job["mesh"])
    k6 = {k: m * n for k, n in _k6_step_launches(cfg).items()}
    _check_mesh_steps(f"mesh {label} float32", per_rank, None, "fma_f32", declared, k6)
    dropped = [[round(d, 4) for d, _ in rec["moe"]] for rec in per_rank[0]["records"]]
    require(any(d > 0 for step in dropped for d in step),
            f"mesh {label}: no step dropped an entry {dropped}")
    mesh = job["mesh"] if isinstance(job["mesh"], str) else dict(zip(*reversed(job["mesh"])))
    step_ms = [statistics.median(rec["s"] for rec in x["records"][1:]) * 1e3
               for x in per_rank]
    print(f"check mesh training reduced {label} float32 ({cfg.expert_sharding}, "
          f"mesh {mesh}, B={job['batch']}, microbatches {m}, capacity factor "
          f"{cfg.capacity_factor}) on 4 gloo ranks sharing the card: 3 steps, losses "
          f"{per_rank[0]['losses']}, largest rel diff from the host's 4 ranks "
          f"{worst:.3e} <= {TRAIN_F32_REL:.0e}; each MoE call's top-1 counts equal "
          f"and dropped shares within 1e-7 (dropped_frac a step and call {dropped}); "
          f"K6 fma_f32 forward and backward "
          f"{sum(n for k, n in k6.items() if k.startswith('flash_attention.'))} "
          f"launches a step on every rank; collectives a step {declared} on every "
          f"rank, as declared (host ranks started and run in {host_wall:.1f}s)")
    print(f"train mesh {label} reduced float32 timing ({nvidia_smi('name,power.limit')}): "
          f"4 gloo ranks sharing one card (no 4-card mesh), step_ms median of steps "
          f"2-3 by rank {[round(t, 1) for t in step_ms]}")


def _check_full_width_mesh(label, per_rank, job, n_attn, declared, launched,
                           shapes=None):
    """A full-width bf16 job of run_mesh_training (each rank a data half of
    the batch and a model half of the heads and channels, or every head
    where the axis does not divide them) against the same job on one rank
    of the card: losses and grad norms within TRAIN_MESH_BF16_REL every
    step, K6 launched once per attention layer (``n_attn``, or ``shapes``
    by mask: :func:`_check_mesh_steps`) and the declared collectives every
    step and rank.  Prints the check and the timing; returns the lead
    rank's record and the one rank's."""
    import statistics
    import torch
    from repro_torch.launch.kernel_timing import nvidia_smi
    from repro_torch.launch.train import train_run
    one = train_run(dict(job, mesh=None), torch.device("cuda"))
    torch.cuda.empty_cache()
    _check_mesh_steps(f"mesh {label}", per_rank, n_attn, "wgmma_bf16", declared, shapes)
    steps, batch, seq = job["steps"], job["batch"], job["seq"]
    worst = 0.0
    for r, x in enumerate(per_rank):
        for i in range(steps):
            for key in ("losses", "grad_norms"):
                a, b = x[key][i], one[key][i]
                require(a == a and abs(a) != float("inf"), f"non-finite {key} {a}")
                worst = max(worst, abs(a - b) / abs(b))
                require(abs(a - b) <= TRAIN_MESH_BF16_REL * abs(b),
                        f"mesh {label} rank {r} step {i + 1}: {key} {a}, one rank {b}")
    lead = next(x for x in per_rank if x["lead"])
    step_ms = [statistics.median([rec["s"] for rec in x["records"][1:]]) * 1e3
               for x in per_rank]
    coll_share = [{a: round(sum(rec["collective_s"].get(a, 0.0) for rec in x["records"][1:]) /
                            sum(rec["s"] for rec in x["records"][1:]), 3)
                   for a in ("data", "model")} for x in per_rank]
    peaks = [x["peak_bytes"] / 1e9 for x in per_rank]
    one_ms = statistics.median([rec["s"] for rec in one["records"][1:]]) * 1e3
    tokens = batch * seq
    print(f"check mesh training {label}, B={batch} S={seq}, tiny mesh on 4 gloo "
          f"ranks sharing the card: {steps} steps, losses {lead['losses']} grad "
          f"norms {lead['grad_norms']}; one rank: losses {one['losses']} grad norms "
          f"{one['grad_norms']}; largest rel diff {worst:.3e} <= "
          f"{TRAIN_MESH_BF16_REL:.0e} on every rank; {launched}; collectives a step "
          f"{declared} on every rank, as declared")
    print(f"train mesh {label.split()[0]} timing ({nvidia_smi('name,power.limit')}): "
          f"4 gloo ranks, step_ms per rank (median of steps 2-{steps}) "
          f"{[round(v, 1) for v in step_ms]}, tokens_per_s "
          f"{tokens / max(step_ms) * 1e3:.0f}, collectives' share of a step per "
          f"rank and axis (host time inside them) {coll_share}, peak_mem_GB per rank "
          f"{[round(v, 2) for v in peaks]} (card {sum(peaks):.2f} + contexts); one "
          f"rank of the same model: step_ms {one_ms:.1f}, tokens_per_s "
          f"{tokens / one_ms * 1e3:.0f}, peak_mem_GB {one['peak_bytes'] / 1e9:.2f}")
    return lead, one


def _check_sequence_parallel_mesh(per_rank, job, plain, one):
    """Job (h) of run_mesh_training, (b)'s model, weights and batches with
    ``seq_parallel`` and ``mlp_dp``: K6 launched once per layer forward and
    backward and the declared collectives every step and rank, and each
    step's loss and global grad norm within TRAIN_MESH_BF16_REL of (b)'s
    (``plain``, per rank) and of the one rank's (``one``).  Prints the check,
    then the step ms, the peak GB a rank beside (b)'s and the collectives'
    calls and bytes a step by axis and op, with the card's name and power
    limit; returns the lead rank's record."""
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.launch.kernel_timing import nvidia_smi
    from repro_torch.models.convert import param_shapes
    from repro_torch.training.optimizer import tree_leaves
    cfg = dataclasses.replace(get_config("gemma-2b"), **job["cfg"])
    declared = step_collectives(cfg, len(tree_leaves(param_shapes(cfg))),
                                -(-job["seq"] // 512))
    label = (f"gemma-2b bf16 full width seq_parallel mlp_dp, {MESH_LAYERS} of 18 "
             f"layers")
    _check_mesh_steps(f"mesh {label}", per_rank, MESH_LAYERS, "wgmma_bf16", declared)
    worst = {"(b)": 0.0, "one rank": 0.0}
    for r, (x, b_x) in enumerate(zip(per_rank, plain)):
        for i in range(job["steps"]):
            for key in ("losses", "grad_norms"):
                a = x[key][i]
                require(a == a and abs(a) != float("inf"), f"non-finite {key} {a}")
                for name, want in (("(b)", b_x[key][i]), ("one rank", one[key][i])):
                    worst[name] = max(worst[name], abs(a - want) / abs(want))
                    require(abs(a - want) <= TRAIN_MESH_BF16_REL * abs(want),
                            f"mesh {label} rank {r} step {i + 1}: {key} {a}, {name} {want}")
    lead = next(x for x in per_rank if x["lead"])
    print(f"check mesh training {label}, B={job['batch']} S={job['seq']}, tiny mesh on "
          f"4 gloo ranks sharing the card: {job['steps']} steps, losses "
          f"{lead['losses']} grad norms {lead['grad_norms']}; largest rel diff from "
          f"(b) {worst['(b)']:.3e}, from one rank {worst['one rank']:.3e}, <= "
          f"{TRAIN_MESH_BF16_REL:.0e} on every rank; K6 wgmma_bf16 forward and backward "
          f"{MESH_LAYERS} launches a step on every rank (B=2 H=4 Hkv=1 S=1024 D=256 "
          f"causal, the sequence gathered); collectives a step {declared} on every "
          f"rank, as declared")
    step_ms = [statistics.median([rec["s"] for rec in x["records"][1:]]) * 1e3
               for x in per_rank]
    plain_ms = [statistics.median([rec["s"] for rec in x["records"][1:]]) * 1e3
                for x in plain]
    peaks = [x["peak_bytes"] / 1e9 for x in per_rank]
    plain_peaks = [x["peak_bytes"] / 1e9 for x in plain]
    bytes_by = {a: {op: (c["calls"], c["bytes"]) for op, c in ops.items()}
                for a, ops in lead["records"][-1]["collectives"].items()}
    plain_by = {a: {op: (c["calls"], c["bytes"]) for op, c in ops.items()}
                for a, ops in next(x for x in plain if x["lead"])["records"][-1][
                    "collectives"].items()}
    print(f"train mesh gemma-2b seq_parallel mlp_dp timing "
          f"({nvidia_smi('name,power.limit')}): 4 gloo ranks, step_ms per rank (median "
          f"of steps 2-{job['steps']}) {[round(v, 1) for v in step_ms]} ((b): "
          f"{[round(v, 1) for v in plain_ms]}), peak_mem_GB per rank "
          f"{[round(v, 2) for v in peaks]} ((b): {[round(v, 2) for v in plain_peaks]})")
    print(f"train mesh gemma-2b seq_parallel mlp_dp collectives a step on the lead rank "
          f"(axis -> op -> (calls, bytes)): {bytes_by}; (b): {plain_by}")
    return lead


def time_mesh_rank_attention(launches):
    """K6 forward and backward at the ranks' shapes of run_mesh_training's
    full-width jobs (MESH_RANKS), each held to its plain version and timed
    beside its bound, its plain version and SDPA (its backward:
    :func:`_time_training_bwd`); rows for the kernels line.  ``launches``:
    the lead rank's launches in those jobs by job and mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, multi_head_attention
    from repro_torch.launch.kernel_timing import device_ms, median_ms, nvidia_smi
    rows = []
    for i, (label, (b, h, hkv, s, sk, d, causal, window, mask, job)) in enumerate(
            MESH_RANKS.items()):
        shape = (f"B={b} H={h} Hkv={hkv} S={s}{f' Sk={sk}' if sk != s else ''} D={d} "
                 f"bf16 {'causal' if causal else 'non-causal'} window={window} "
                 f"({label}, a tiny-mesh rank)")
        seed = 61 + 10 * i
        q, k, v = attn_inputs(b, h, hkv, s, d, torch.bfloat16, seed=seed, model_layout=True)
        if sk != s:
            _, k, v = attn_inputs(b, hkv, hkv, sk, d, torch.bfloat16, seed=seed + 1,
                                  model_layout=True)
        fn = lambda: multi_head_attention(q, k, v, causal=causal, window=window)
        plain = lambda: attention_ref(q, k, v, causal=causal, window=window or None)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                     enable_gqa=h != hkv)
        got = fn()
        compare_attention("flash_attention", got, attention_ref(
            q.float(), k.float(), v.float(), causal=causal, window=window or None),
            f"flash_attention at {shape}")
        err = float((lib().float() - got.float()).abs().max())
        require(err <= SDPA_TOL, f"SDPA yardstick disagrees with flash_attention at "
                f"{shape}: {err:.3e}")
        kept = s * (s + 1) // 2 if causal else s * sk
        require(not window or window >= s, f"{shape}: SDPA's causal mask would not "
                "stand for the window")
        bms, by = bound_attn(2 * (2 * q.numel() + k.numel() + v.numel()),
                             4 * d * kept * b * h)
        n = launches[job][f"flash_attention.{mask}"]
        row = dict(name="flash_attention", route="cuda",
                   source="src/repro_torch/csrc/flash_attention.cu",
                   replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
                   shape=shape, ms=device_ms(fn, reps=20), plain_ms=device_ms(plain, reps=3),
                   library_ms=device_ms(lib, reps=20), call_ms=median_ms(fn, reps=10),
                   bound_ms=bms, bound_by=by, launches=n, listed=True, also_listed=True)
        print(f"timing flash_attention {shape} ({nvidia_smi('name,power.limit')}): "
              f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
              f"bound_ms={bms:.5f} ({by}) library_ms={row['library_ms']:.5f} "
              f"launches_on_main_path={n} (the lead rank's, {mask}); call_ms="
              f"{row['call_ms']:.5f}; {row['ms'] / bms:.2f}x the bound, "
              f"{row['ms'] / row['library_ms']:.2f}x SDPA")
        for key in ("ms", "plain_ms", "library_ms"):
            require(bms <= row[key], f"flash_attention at {shape}: bound_ms {bms:.5f} "
                    f"exceeds {key}")
        del q, k, v, got
        torch.cuda.empty_cache()
        rows += [row, _time_training_bwd(
            shape, b, h, hkv, s, sk, d, causal, window,
            launches[job][f"flash_attention_bwd.{mask}"], seed=seed + 5)]
    return rows


def _kernel_device_ms(fn, calls=10):
    """Device ms per call of each CUDA kernel ``fn`` launches, as a
    torch.profiler trace of ``calls`` calls reads it (names cut to the
    kernel's own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve_profile import kernel_times
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for key, (ms, _) in kernel_times(prof).items():
        found = re.search(r"\w+_kernel(?:<[^>]*>)?", key)
        name = found.group(0) if found else key[:60]
        out[name] = out.get(name, 0.0) + ms / calls
    return out


def time_flash_attention_bwd(launches):
    """K6's backward at gemma-2b's training layer beside its bound, its
    plain version and the backward of torch's scaled_dot_product_attention
    on the same inputs (the port never calls it), and each of its kernels'
    share of a call's device time (``launch/bwd_splits.py`` times the
    split rule's alternatives)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref_bwd,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch.kernel_timing import device_ms, median_ms, nvidia_smi
    b, h, hkv, s, d = 4, 8, 1, 1024, 256
    q, k, v = attn_inputs(b, h, hkv, s, d, torch.bfloat16, seed=6, model_layout=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
    out, lse = flash_attention(q, k, v, causal=True, window=0, return_lse=True)
    fn = lambda: flash_attention_bwd(q, k, v, out, dout, lse, causal=True, window=0)
    plain = lambda: attention_ref_bwd(q, k, v, out, dout, lse, causal=True)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dout, retain_graph=True)
    err = max(float((a.float() - b_.float()).norm() / b_.float().norm())
              for a, b_ in zip(lib(), fn()))
    require(err <= SDPA_TOL,
            f"SDPA's backward disagrees with flash_attention_bwd: rel L2 {err:.3e}")
    kept = s * (s + 1) // 2
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    bms, by = bound_attn(nbytes, 10 * d * kept * b * h)
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
               shape=REPORT_SHAPE["flash_attention_bwd"],
               ms=device_ms(fn, reps=20), plain_ms=device_ms(plain, reps=3),
               library_ms=device_ms(lib, reps=20), call_ms=median_ms(fn, reps=10),
               bound_ms=bms, bound_by=by, launches=launches, listed=True)
    print(f"timing flash_attention_bwd {row['shape']} ({nvidia_smi('name,power.limit')}): "
          f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
          f"({by}) library_ms={row['library_ms']:.5f} launches_on_main_path={launches}; "
          f"call_ms={row['call_ms']:.5f}; {row['ms'] / row['bound_ms']:.2f}x the bound, "
          f"{row['ms'] / row['library_ms']:.2f}x SDPA's backward; bound: 10 D operations "
          f"per kept pair (S recomputed, dV, dP, dQ, dK) at the dense bf16 tensor-core "
          f"rate, q, k, v, out, dout, lse read and dq, dk, dv written once (the kernels "
          f"execute 14 D: the dQ kernel recomputes S and dP); library: the backward of "
          f"scaled_dot_product_attention (enable_gqa), which the port never calls; SDPA's "
          f"gradients within rel L2 {err:.3e} of the kernel's")
    # a profiler trace's kernel times read low late in this process (3.5x
    # on an H100, against within 3% in a fresh one): its shares apportion ms
    kernels_ms = _kernel_device_ms(fn)
    total = sum(kernels_ms.values())
    print(f"timing flash_attention_bwd kernels (share of a call's device time in a "
          f"torch.profiler trace of 10 calls; ms = the call's ms x share): " + ", ".join(
              f"{k_} {t / total:.1%} {row['ms'] * t / total:.5f} ms"
              for k_, t in kernels_ms.items()))
    for key in ("ms", "plain_ms", "library_ms"):
        require(row["bound_ms"] <= row[key],
                f"flash_attention_bwd: bound_ms {row['bound_ms']:.5f} exceeds {key}")
    return row


# K6's float32 backward (its FMA kernels) timed at the float32 forward row's
# shape and at a tiny-mesh rank's attention in the reduced MoE jobs
# (reduced grok and llama4: 4 heads of 16, 2 a rank, B = 2 of 4 rows, S =
# 64): (B, H, Hkv, S, D)
F32_BWD_SHAPES = ((2, 8, 4, 2048, 256), (2, 2, 2, 64, 16))
# its gradients against the plain version at those shapes, by relative L2
# (float32 sums in another order over up to 2,048 keys)
BWD_REL_F32 = 1e-4


def time_f32_flash_attention_bwd(launches):
    """K6's float32 backward (``flash_attention_bwd.fma_f32``) at
    F32_BWD_SHAPES, each held to its plain version, beside its bound (10 D
    operations a kept pair at the float32 rate, q, k, v, out, dout and dq,
    dk, dv moved once), its plain version and the float32 backward of
    torch's scaled_dot_product_attention (the port never calls it); rows
    for the kernels line.  ``launches``: the lead rank's in the reduced
    float32 mesh jobs of run_mesh_training (f) and (g)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.analysis import roofline as rl
    from repro_torch.kernels.flash_attention import (attention_ref_bwd,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch.kernel_timing import device_ms, median_ms, nvidia_smi
    rows = []
    for i, (b, h, hkv, s, d) in enumerate(F32_BWD_SHAPES):
        where = ("the float32 forward row's shape" if i == 0 else
                 "a tiny-mesh rank of the reduced MoE jobs")
        shape = f"B={b} H={h} Hkv={hkv} S={s} D={d} f32 causal window=0 ({where})"
        q, k, v = attn_inputs(b, h, hkv, s, d, torch.float32, seed=91 + i,
                              model_layout=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(95 + i)
        dout = torch.randn((b, s, h, d), generator=gen, device="cuda").transpose(1, 2)
        out, lse = flash_attention(q, k, v, causal=True, window=0, return_lse=True)
        fn = lambda: flash_attention_bwd(q, k, v, out, dout, lse, causal=True, window=0)
        plain = lambda: attention_ref_bwd(q, k, v, out, dout, lse, causal=True)
        kernels.reset_launch_counts()
        got = fn()
        require(kernels.variant_counts()["flash_attention_bwd.fma_f32"] == 1,
                f"flash_attention_bwd at {shape}: variants {kernels.variant_counts()}")
        want = plain()
        rel = max(float((g - w).norm() / w.norm()) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        require(rel <= BWD_REL_F32, f"flash_attention_bwd at {shape}: rel L2 {rel:.3e}")
        MAX_ABS_ERR["flash_attention_bwd"] = max(MAX_ABS_ERR["flash_attention_bwd"], err)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                 enable_gqa=h != hkv)
        lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dout, retain_graph=True)
        lib_err = max(float((a - g).norm() / g.norm()) for a, g in zip(lib(), got))
        require(lib_err <= SDPA_TOL, f"SDPA's float32 backward disagrees with "
                f"flash_attention_bwd at {shape}: rel L2 {lib_err:.3e}")
        kept = s * (s + 1) // 2
        nbytes = 4 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        bms, by = bound_attn(nbytes, 10 * d * kept * b * h, rl.FP32_FLOPS)
        row = dict(name="flash_attention_bwd", route="cuda",
                   source="src/repro_torch/csrc/flash_attention_bwd.cu",
                   replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
                   shape=shape, ms=device_ms(fn, reps=10), plain_ms=device_ms(plain, reps=3),
                   library_ms=device_ms(lib, reps=10), call_ms=median_ms(fn, reps=5),
                   bound_ms=bms, bound_by=by, launches=launches, listed=True,
                   also_listed=True)
        print(f"timing flash_attention_bwd {shape} ({nvidia_smi('name,power.limit')}): "
              f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} bound_ms={bms:.5f} "
              f"({by}) library_ms={row['library_ms']:.5f} launches_on_main_path="
              f"{launches} (the lead rank's fma_f32 backward in the reduced mesh jobs' "
              f"steps, (f) and (g)); call_ms={row['call_ms']:.5f}; {row['ms'] / bms:.2f}x the "
              f"bound, {row['ms'] / row['library_ms']:.2f}x SDPA's float32 backward; "
              f"rel L2 from the plain version {rel:.3e} (max abs {err:.3e}); bound: "
              f"10 D operations for each of the {kept * b * h} kept pairs at the "
              f"float32 rate, {nbytes} bytes read and written once; SDPA's gradients "
              f"within rel L2 {lib_err:.3e}")
        for key in ("ms", "plain_ms", "library_ms"):
            require(bms <= row[key], f"flash_attention_bwd at {shape}: bound_ms "
                    f"{bms:.5f} exceeds {key}")
        rows.append(row)
        del q, k, v, dout, out, lse, got, want, qs, ks, vs, lib_out
        torch.cuda.empty_cache()
    return rows


def time_capped_flash_attention_bwd(launches):
    """K6's soft-capped backward at grok's training layer (GROK_LAYER, cap
    30, q drawn CAP_Q_SCALE times larger) beside its bound, its plain
    version, the uncapped backward on the same inputs and the library's
    capped attention, torch.compile(flex_attention) with the cap as its
    score_mod (the one PyTorch call that computes a capped gradient; the
    port never calls it): its backward alone (``library_ms``, the graph of
    one forward kept), and its forward plus backward beside K6's own.
    Returns the kernels line's row."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref_bwd,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch.kernel_timing import device_ms, median_ms, nvidia_smi
    b, h, hkv, s, d = GROK_LAYER
    q, k, v = attn_inputs(b, h, hkv, s, d, torch.bfloat16, seed=31, model_layout=True)
    q = (q.float() * CAP_Q_SCALE).to(torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
    out, lse = flash_attention(q, k, v, causal=True, window=0, softcap=CAP, return_lse=True)
    fn = lambda: flash_attention_bwd(q, k, v, out, dout, lse, causal=True, window=0,
                                     softcap=CAP)
    uncapped_out, uncapped_lse = flash_attention(q, k, v, causal=True, window=0,
                                                 return_lse=True)
    uncapped = lambda: flash_attention_bwd(q, k, v, uncapped_out, dout, uncapped_lse,
                                           causal=True, window=0)

    def both():
        o, lse_ = flash_attention(q, k, v, causal=True, window=0, softcap=CAP,
                                  return_lse=True)
        return flash_attention_bwd(q, k, v, o, dout, lse_, causal=True, window=0,
                                   softcap=CAP)
    plain = lambda: attention_ref_bwd(q, k, v, out, dout, lse, causal=True, softcap=CAP)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    flex = flex_capped(qs, ks, vs, CAP, causal=True)
    flex_out = flex()
    lib = lambda: torch.autograd.grad(flex_out, (qs, ks, vs), dout, retain_graph=True)
    lib_both = lambda: torch.autograd.grad(flex(), (qs, ks, vs), dout)
    err = max(float((a.float() - b_.float()).norm() / b_.float().norm())
              for a, b_ in zip(lib(), fn()))
    require(err <= SDPA_TOL,
            f"flex_attention's capped gradient disagrees with the capped backward: "
            f"rel L2 {err:.3e}")
    kept = s * (s + 1) // 2
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    bms, by = bound_attn(nbytes, 10 * d * kept * b * h)
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
               shape=f"{GROK_LAYER_SHAPE} (grok-1 training)",
               ms=device_ms(fn, reps=20), plain_ms=device_ms(plain, reps=3),
               library_ms=device_ms(lib, reps=10), call_ms=median_ms(fn, reps=10),
               bound_ms=bms, bound_by=by, launches=launches, listed=True,
               also_listed=True)
    uncapped_ms = device_ms(uncapped, reps=20)
    both_ms = device_ms(both, reps=20)
    lib_both_ms = device_ms(lib_both, reps=10)
    print(f"timing flash_attention_bwd {row['shape']} ({nvidia_smi('name,power.limit')}): "
          f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
          f"({by}) library_ms={row['library_ms']:.5f} launches_on_main_path={launches}; "
          f"call_ms={row['call_ms']:.5f}; {row['ms'] / row['bound_ms']:.2f}x the bound; "
          f"{row['ms'] / row['library_ms']:.2f}x the library's backward; uncapped "
          f"backward on the same inputs {uncapped_ms:.5f} ms; library: "
          f"torch.compile(flex_attention) with the cap as score_mod, its backward "
          f"alone (library_ms) and forward plus backward {lib_both_ms:.5f} ms against "
          f"K6's capped forward plus backward {both_ms:.5f} ms "
          f"({both_ms / lib_both_ms:.2f}x), gradients within rel L2 {err:.3e}")
    for key in ("ms", "plain_ms", "library_ms"):
        require(row["bound_ms"] <= row[key],
                f"capped flash_attention_bwd: bound_ms {row['bound_ms']:.5f} exceeds {key}")
    return row


def time_whisper_cross_bwd(launches):
    """K6's backward at whisper's training cross-attention (WHISPER_CROSS:
    S = 448 decoder rows over Sk = 1,500 encoder rows, non-causal, G = 1;
    :func:`_time_training_bwd`).  ``launches``: the cross backward's
    launches in run_training_whisper."""
    b, h, hkv, s, sk, d = WHISPER_CROSS
    return _time_training_bwd(WHISPER_CROSS_SHAPE, b, h, hkv, s, sk, d, False, 0,
                              launches, seed=41)


def time_hymba_training_bwd(launches):
    """K6's backward at hymba's training layer (HYMBA_TRAIN: B = 4, 25
    heads over 5 KV heads, S = 1,024, D = 64, causal under the window of
    2,048, which keeps every causal pair; each group's 5 heads in one
    dK/dV block; :func:`_time_training_bwd`).  ``launches``: the
    backward's launches in run_training_recurrent."""
    b, h, hkv, s, d, window = HYMBA_TRAIN
    return _time_training_bwd(HYMBA_TRAIN_SHAPE, b, h, hkv, s, s, d, True, window,
                              launches, seed=51)


def _time_training_bwd(shape, b, h, hkv, s, sk, d, causal, window, launches, seed):
    """K6's backward at a training shape beside its bound, its plain
    version and the backward of torch's scaled_dot_product_attention on
    the same inputs (the port never calls it; its causal mask stands for
    the window only where the window keeps every causal pair), after the
    kernel is held to the plain version.  Returns the kernels line's
    row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref_bwd,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch.kernel_timing import device_ms, median_ms, nvidia_smi
    q, k, v = attn_inputs(b, h, hkv, s, d, torch.bfloat16, seed=seed, model_layout=True)
    if sk != s:
        _, k, v = attn_inputs(b, hkv, hkv, sk, d, torch.bfloat16, seed=seed + 1,
                              model_layout=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2)
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
    out, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    fn = lambda: flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
    mask = dict(causal=causal, window=window or None)
    plain = lambda: attention_ref_bwd(q, k, v, out, dout, lse, **mask)
    got = fn()
    want = attention_ref_bwd(q.float(), k.float(), v.float(), out.float(), dout.float(),
                             lse, **mask)
    rel = max(float((g.float() - w).norm() / w.norm()) for g, w in zip(got, want))
    require(rel <= BWD_REL_BF16, f"flash_attention_bwd at {shape}: rel L2 {rel:.3e}")
    # the pairs each query row keeps: all Sk keys, or the causal ones within
    # the window
    kept = (s * sk if not causal else
            sum(min(i + 1, window or i + 1) for i in range(s)))
    require(not causal or kept == s * (s + 1) // 2,
            f"{shape}: SDPA's causal mask would not stand for the window")
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                             enable_gqa=h != hkv)
    lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dout, retain_graph=True)
    err = max(float((a.float() - b_.float()).norm() / b_.float().norm())
              for a, b_ in zip(lib(), got))
    require(err <= SDPA_TOL,
            f"SDPA's backward disagrees with flash_attention_bwd at {shape}: "
            f"rel L2 {err:.3e}")
    # q, out, dout, dq of S rows, k, v, dk, dv of Sk rows (bf16), lse read once
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    bms, by = bound_attn(nbytes, 10 * d * kept * b * h)
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
               shape=shape, ms=device_ms(fn, reps=20),
               plain_ms=device_ms(plain, reps=3), library_ms=device_ms(lib, reps=20),
               call_ms=median_ms(fn, reps=10), bound_ms=bms, bound_by=by,
               launches=launches, listed=True, also_listed=True)
    MAX_ABS_ERR["flash_attention_bwd"] = max(
        MAX_ABS_ERR["flash_attention_bwd"],
        max(float((g.float() - w.to(torch.bfloat16).float()).abs().max())
            for g, w in zip(got, want)))
    print(f"timing flash_attention_bwd {row['shape']} ({nvidia_smi('name,power.limit')}): "
          f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
          f"({by}) library_ms={row['library_ms']:.5f} launches_on_main_path={launches}; "
          f"call_ms={row['call_ms']:.5f}; {row['ms'] / row['bound_ms']:.2f}x the bound, "
          f"{row['ms'] / row['library_ms']:.2f}x SDPA's backward; rel L2 from the plain "
          f"version {rel:.3e}; bound: 10 D operations for each of the {kept * b * h} kept "
          f"pairs at the dense bf16 tensor-core rate, {nbytes} bytes read and written "
          f"once; library: the backward of scaled_dot_product_attention, which the port "
          f"never calls; SDPA's gradients within rel L2 {err:.3e}")
    for key in ("ms", "plain_ms", "library_ms"):
        require(row["bound_ms"] <= row[key],
                f"flash_attention_bwd at {shape}: bound_ms {row['bound_ms']:.5f} "
                f"exceeds {key}")
    del q, k, v, out, dout, lse, got, want, qs, ks, vs, lib_out
    torch.cuda.empty_cache()
    return row


def _cast(tree, dtype, device=None):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def bound_attn(nbytes, flops, rate=None):
    """Least time in ms for work that moves ``nbytes`` and does ``flops``
    operations (two per multiply-add) at ``rate``: the dense bf16
    tensor-core rate for bf16 inputs (the default), the float32 rate for
    float32."""
    from repro_torch.analysis import roofline as rl
    t_b = nbytes / rl.HBM_BYTES_PER_S * 1e3
    t_o = flops / (rl.BF16_TENSOR_FLOPS if rate is None else rate) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def flex_capped(q, k, v, cap, causal):
    """The one PyTorch call that computes soft-capped GQA attention, the
    library yardstick of a capped row (SDPA takes no cap): torch's
    ``flex_attention`` under ``torch.compile``, its score_mod ``tanh(x /
    cap) * cap`` on the scaled score, a causal block mask when ``causal``
    (a one-row q takes its decoding kernel).  The port never calls it.
    Returns the call; it compiles on its first use."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / cap) * cap

    mask = None
    if causal:
        mask = create_block_mask(lambda b, h, q_idx, kv_idx: q_idx >= kv_idx,
                                 None, None, q.shape[2], k.shape[2],
                                 device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(q, k, v, score_mod=score_mod, block_mask=mask,
                        enable_gqa=True)


def time_attention(counts, model_counts, rank_f32_launches):
    """K6 and K7 at gemma3-4b's serving shapes (the kernels line's rows),
    K6's float32 forward there and at a reduced MoE job's mesh rank
    (F32_BWD_SHAPES[1]), then at the shapes of this slice's served models:
    K6 at D = 128, G = 6 (internlm2's and grok's layer) with and without
    grok's soft-cap, K7 at their decode shapes, G = 6 and G = 5 (llama4),
    with and without it.  ``counts``: gemma3-4b's first serve's launches;
    ``model_counts``: each new model's; ``rank_f32_launches``: the lead
    rank's float32 forward launches in the reduced mesh jobs of
    run_mesh_training (f) and (g).  The library time
    of a capped row is :func:`flex_capped`'s, SDPA's of every other row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      grouped_decode_attention)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     multi_head_attention)
    from repro_torch.analysis import roofline as rl
    from repro_torch.launch.kernel_timing import device_ms, median_ms

    def timed(kernel, plain, library, reps=20, plain_reps=20):
        """ms, plain_ms, library_ms: device time per call (calls run back
        to back behind a sleep of the card); *_call_ms: CUDA events around
        each call, the host's launch work included."""
        out = {"library_ms": None, "library_call_ms": None}
        for key, fn, n in (("ms", kernel, reps), ("plain_ms", plain, plain_reps),
                           ("library_ms", library, reps)):
            if fn is not None:
                out[key] = device_ms(fn, reps=n)
                out[key.replace("ms", "call_ms")] = median_ms(fn, reps=n)
        return out

    rows = []
    b, h, hkv, s, d = 2, 8, 4, 2048, 256
    q, k, v = attn_inputs(b, h, hkv, s, d, torch.bfloat16, seed=3, model_layout=True)
    for window in (0, 1024):
        i = torch.arange(s, device="cuda")
        keep = i[None, :] <= i[:, None]
        if window:
            keep &= i[None, :] > i[:, None] - window
        kept = int(keep.sum())
        fn = lambda: multi_head_attention(q, k, v, causal=True, window=window)
        ref = lambda: attention_ref(q, k, v, causal=True, window=window or None)
        if window:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        err = float((lib().float() - fn().float()).abs().max())
        require(err <= SDPA_TOL,
                f"SDPA yardstick disagrees with flash_attention (window {window}): {err:.3e}")
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        bms, by = bound_attn(nbytes, 4 * d * kept * b * h)
        rows.append(dict(name="flash_attention", route="cuda",
                         source="src/repro_torch/csrc/flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
                         shape=f"B={b} H={h} Hkv={hkv} S={s} D={d} bf16 causal window={window}",
                         **timed(fn, ref, lib, plain_reps=5),
                         bound_ms=bms, bound_by=by,
                         launches=counts["flash_attention.wgmma_bf16"]))
        if window == 0:
            # K6's float32 variant (the FMA kernel) at the global layer
            q32, k32, v32 = q.float(), k.float(), v.float()
            fn32 = lambda: multi_head_attention(q32, k32, v32, causal=True, window=0)
            lib32 = lambda: F.scaled_dot_product_attention(
                q32, k32, v32, is_causal=True, enable_gqa=True)
            err = float((lib32() - fn32()).abs().max())
            require(err <= SDPA_TOL,
                    f"SDPA yardstick disagrees with flash_attention float32: {err:.3e}")
            bms32, by32 = bound_attn(2 * nbytes, 4 * d * kept * b * h, rl.FP32_FLOPS)
            rows.append(dict(name="flash_attention_f32", route="cuda",
                             source="src/repro_torch/csrc/flash_attention.cu",
                             replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
                             shape=f"B={b} H={h} Hkv={hkv} S={s} D={d} f32 causal window=0",
                             **timed(fn32, lambda: attention_ref(
                                 q32, k32, v32, causal=True, window=None), lib32,
                                 plain_reps=5),
                             bound_ms=bms32, bound_by=by32,
                             launches=counts["flash_attention.fma_f32"]))
            del q32, k32, v32
    # K6's float32 forward where the mesh jobs run it: a reduced MoE rank
    b, h, hkv, s, d = F32_BWD_SHAPES[1]
    q32, k32, v32 = attn_inputs(b, h, hkv, s, d, torch.float32, seed=93, model_layout=True)
    fn32 = lambda: multi_head_attention(q32, k32, v32, causal=True, window=0)
    lib32 = lambda: F.scaled_dot_product_attention(q32, k32, v32, is_causal=True,
                                                   enable_gqa=h != hkv)
    err = float((lib32() - fn32()).abs().max())
    require(err <= SDPA_TOL,
            f"SDPA yardstick disagrees with flash_attention float32 at D={d}: {err:.3e}")
    bms32, by32 = bound_attn(4 * (2 * q32.numel() + 2 * k32.numel()),
                             4 * d * (s * (s + 1) // 2) * b * h, rl.FP32_FLOPS)
    rows.append(dict(name="flash_attention_f32", route="cuda",
                     source="src/repro_torch/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
                     shape=f"B={b} H={h} Hkv={hkv} S={s} D={d} f32 causal window=0 "
                           "(a reduced MoE job's mesh rank)",
                     **timed(fn32, lambda: attention_ref(q32, k32, v32, causal=True,
                                                         window=None), lib32),
                     bound_ms=bms32, bound_by=by32, launches=rank_f32_launches,
                     also_listed=True))
    del q32, k32, v32
    b, kv, g, d, smax = 2, 4, 2, 256, 2080
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    qd = torch.randn((b, kv, g, d), generator=gen, device="cuda").to(torch.bfloat16)
    cache = torch.randn((2, b, smax, kv, d), generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc = cache[0], cache[1]
    for n, window in ((2079, 0), (2079, 1024)):
        length = torch.full((b,), n, dtype=torch.int32, device="cuda")
        lo = max(0, n - window) if window else 0
        fn = lambda: grouped_decode_attention(qd, kc, vc, length, window=window)
        ref = lambda: decode_attention_ref(qd, kc, vc, length, window=window)
        lib = lambda: F.scaled_dot_product_attention(
            qd.reshape(b, kv * g, 1, d), kc[:, lo:n].transpose(1, 2),
            vc[:, lo:n].transpose(1, 2), enable_gqa=True)
        err = float((lib().reshape(b, kv, g, d).float() - fn().float()).abs().max())
        require(err <= SDPA_TOL,
                f"SDPA yardstick disagrees with decode_attention (window {window}): {err:.3e}")
        rows_read = n - lo
        nbytes = 2 * (2 * qd.numel() + 2 * b * rows_read * kv * d) + 4 * b
        bms, by = bound_attn(nbytes, 4 * d * g * kv * b * rows_read)
        rows.append(dict(name="decode_attention", route="cuda",
                         source="src/repro_torch/csrc/decode_attention.cu",
                         replaces="src/repro/kernels/decode_attention/decode_attention.py:98",
                         shape=f"B={b} KV={kv} G={g} D={d} S={smax} len={n} bf16 window={window}",
                         **timed(fn, ref, lib, reps=50),
                         bound_ms=bms, bound_by=by,
                         launches=counts["decode_attention"]))
    # this slice's models: K6 at internlm2's and grok's layer (B=2 H=48
    # Hkv=8 S=2,048 D=128), K7 at their decode steps and llama4's
    b, h, hkv, s, d = 2, 48, 8, 2048, 128
    q, k, v = attn_inputs(b, h, hkv, s, d, torch.bfloat16, seed=8, model_layout=True)
    kept = s * (s + 1) // 2
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    for arch, cap in (("internlm2-20b", 0.0), ("grok-1-314b", CAP)):
        fn = lambda: multi_head_attention(q, k, v, causal=True, window=0, softcap=cap)
        ref = lambda: attention_ref(q, k, v, causal=True, softcap=cap)
        if cap:
            lib = flex_capped(q, k, v, cap, causal=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                         enable_gqa=True)
        err = float((lib().float() - fn().float()).abs().max())
        require(err <= SDPA_TOL,
                f"{'flex_attention' if cap else 'SDPA'} yardstick disagrees with "
                f"flash_attention at D=128 softcap={cap:g}: {err:.3e}")
        bms, by = bound_attn(nbytes, 4 * d * kept * b * h)
        rows.append(dict(name="flash_attention", route="cuda",
                         source="src/repro_torch/csrc/flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
                         shape=f"B={b} H={h} Hkv={hkv} S={s} D={d} bf16 causal window=0 "
                               f"softcap={cap:g} ({arch})",
                         **timed(fn, ref, lib, plain_reps=3),
                         bound_ms=bms, bound_by=by,
                         launches=model_counts[arch]["flash_attention.wgmma_bf16"]))
    del q, k, v
    b, kv, d, smax, n = 2, 8, 128, 2080, 2079
    cache = torch.randn((2, b, smax, kv, d), generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc = cache[0], cache[1]
    length = torch.full((b,), n, dtype=torch.int32, device="cuda")
    for g, cap, arch in ((6, 0.0, "internlm2-20b"), (6, CAP, "grok-1-314b"),
                         (5, 0.0, "llama4-maverick-400b-a17b"), (5, CAP, None)):
        qd = torch.randn((b, kv, g, d), generator=gen, device="cuda").to(torch.bfloat16)
        fn = lambda: grouped_decode_attention(qd, kc, vc, length, softcap=cap)
        ref = lambda: decode_attention_ref(qd, kc, vc, length, softcap=cap)
        if cap:
            lib = flex_capped(qd.reshape(b, kv * g, 1, d), kc[:, :n].transpose(1, 2),
                              vc[:, :n].transpose(1, 2), cap, causal=False)
        else:
            lib = lambda: F.scaled_dot_product_attention(
                qd.reshape(b, kv * g, 1, d), kc[:, :n].transpose(1, 2),
                vc[:, :n].transpose(1, 2), enable_gqa=True)
        err = float((lib().reshape(b, kv, g, d).float() - fn().float()).abs().max())
        require(err <= SDPA_TOL,
                f"{'flex_attention' if cap else 'SDPA'} yardstick disagrees with "
                f"decode_attention at G={g} softcap={cap:g}: {err:.3e}")
        nbytes = 2 * (2 * qd.numel() + 2 * b * n * kv * d) + 4 * b
        bms, by = bound_attn(nbytes, 4 * d * g * kv * b * n)
        rows.append(dict(name="decode_attention", route="cuda",
                         source="src/repro_torch/csrc/decode_attention.cu",
                         replaces="src/repro/kernels/decode_attention/decode_attention.py:98",
                         shape=f"B={b} KV={kv} G={g} D={d} S={smax} len={n} bf16 window=0 "
                               f"softcap={cap:g} ({arch or 'no served model'})",
                         **timed(fn, ref, lib, reps=50),
                         bound_ms=bms, bound_by=by,
                         launches=model_counts[arch]["decode_attention"] if arch else 0))
    rows += _hymba_attention_rows(model_counts["hymba-1.5b"], timed)
    rows += _command_r_attention_rows(model_counts["command-r-35b"], timed)
    rows += _slice_attention_rows(model_counts["phi-3-vision-4.2b"],
                                  model_counts["whisper-base"], timed)
    for row in rows:
        row["listed"] = True
        lib_text = ("none" if row["library_ms"] is None else
                    f"{row['library_ms']:.5f}")
        lib_call = ("none" if row["library_call_ms"] is None else
                    f"{row['library_call_ms']:.5f}")
        print(f"timing {row['name']} {row['shape']}: ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}) library_ms={lib_text} "
              f"launches_on_main_path={row['launches']}; per call with the host's "
              f"launch work: call_ms={row['call_ms']:.5f} "
              f"plain_call_ms={row['plain_call_ms']:.5f} "
              f"library_call_ms={lib_call}")
        for key in ("ms", "plain_ms", "library_ms"):
            if row[key] is None:
                continue
            require(row["bound_ms"] <= row[key],
                    f"{row['name']} {row['shape']}: bound_ms "
                    f"{row['bound_ms']:.5f} exceeds {key} {row[key]:.5f}")
    print("timing note: attention bounds count the (row, column) pairs the "
          "masks keep, 4 D operations each, at the dense bf16 tensor-core "
          "rate (flash_attention_f32: the float32 rate, 6.7e13 FLOP/s, and 4-byte "
          "elements), and q, k, v, out (decode: the valid cache rows) read or "
          "written once; library_ms is torch scaled_dot_product_attention "
          "(enable_gqa; the windowed layer with a boolean mask) and, on a "
          "soft-capped row, torch.compile(flex_attention) with the cap as its "
          "score_mod, neither of which the port calls (the bound of a capped "
          "row counts the same 4 D per kept pair, not the cap's one tanh per "
          "pair); launches are the first bf16 serve's of gemma3-4b, "
          "per variant (the float32 variant serves no bf16 model), and of the "
          "model named in brackets on the D=128 and D=64 rows; ms, plain_ms and "
          "library_ms of the attention rows are device time per call "
          "(calls run back to back behind a sleep of the card), call_ms "
          "CUDA events around each call")
    return rows


def _hymba_attention_rows(counts, timed):
    """K6 at hymba's prefill layer (B=2 H=25 Hkv=5 S=2,048 D=64, G = 5,
    window 2,048: at S = 2,048 it keeps every causal pair, so SDPA's causal
    call computes the same function) and K7 at its decode step (B=2 KV=5
    G=5 D=64, a 2,080-row cache at length 2,079, the window leaving 2,048
    rows), each beside its bound, its plain version and SDPA; both go
    into the kernels line, each held to its plain version first.
    ``counts``: hymba's first
    serve's launches; ``timed``: time_attention's timer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      grouped_decode_attention)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     multi_head_attention)
    b, h, hkv, s, d, window = 2, 25, 5, 2048, 64, 2048
    q, k, v = attn_inputs(b, h, hkv, s, d, torch.bfloat16, seed=9, model_layout=True)
    i = torch.arange(s, device="cuda")
    kept = int(((i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)).sum())
    require(kept == s * (s + 1) // 2, "hymba's window keeps every causal pair at S = 2,048")
    fn = lambda: multi_head_attention(q, k, v, causal=True, window=window)
    ref = lambda: attention_ref(q, k, v, causal=True, window=window)
    lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    compare_attention("flash_attention", fn(),
                      attention_ref(q.float(), k.float(), v.float(), causal=True,
                                    window=window),
                      "flash_attention at hymba's layer")
    err = float((lib().float() - fn().float()).abs().max())
    require(err <= SDPA_TOL, f"SDPA yardstick disagrees with flash_attention at "
            f"hymba's layer: {err:.3e}")
    bms, by = bound_attn(2 * (q.numel() + k.numel() + v.numel() + q.numel()),
                         4 * d * kept * b * h)
    rows = [dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
                 shape=f"B={b} H={h} Hkv={hkv} S={s} D={d} bf16 causal window={window} "
                       "(hymba-1.5b)",
                 **timed(fn, ref, lib, plain_reps=5), bound_ms=bms, bound_by=by,
                 launches=counts["flash_attention.wgmma_bf16"], also_listed=True)]
    del q, k, v
    b, kv, g, smax, n = 2, 5, 5, 2080, 2079
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    qd = torch.randn((b, kv, g, d), generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc = torch.randn((2, b, smax, kv, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    length = torch.full((b,), n, dtype=torch.int32, device="cuda")
    lo = n - window
    fn = lambda: grouped_decode_attention(qd, kc, vc, length, window=window)
    ref = lambda: decode_attention_ref(qd, kc, vc, length, window=window)
    lib = lambda: F.scaled_dot_product_attention(
        qd.reshape(b, kv * g, 1, d), kc[:, lo:n].transpose(1, 2),
        vc[:, lo:n].transpose(1, 2), enable_gqa=True)
    compare_attention("decode_attention", fn(),
                      decode_attention_ref(qd.float(), kc.float(), vc.float(), length,
                                           window=window),
                      "decode_attention at hymba's decode step")
    err = float((lib().reshape(b, kv, g, d).float() - fn().float()).abs().max())
    require(err <= SDPA_TOL, f"SDPA yardstick disagrees with decode_attention at "
            f"hymba's decode step: {err:.3e}")
    bms, by = bound_attn(2 * (2 * qd.numel() + 2 * b * window * kv * d) + 4 * b,
                         4 * d * g * kv * b * window)
    rows.append(dict(name="decode_attention", route="cuda",
                     source="src/repro_torch/csrc/decode_attention.cu",
                     replaces="src/repro/kernels/decode_attention/decode_attention.py:98",
                     shape=f"B={b} KV={kv} G={g} D={d} S={smax} len={n} bf16 "
                           f"window={window} (hymba-1.5b)",
                     **timed(fn, ref, lib, reps=50), bound_ms=bms, bound_by=by,
                     launches=counts["decode_attention"], also_listed=True))
    return rows


def _command_r_attention_rows(counts, timed):
    """K6 at command-r-35b's prefill layer (B=2 H=64 Hkv=8 S=2,048 D=128,
    causal, G = 8) and K7 at its decode step (B=2 KV=8 G=8 D=128, a
    2,080-row cache at length 2,079), each held to its float32 plain
    version first, then beside its bound, its plain version and SDPA; both
    go into the kernels line.  ``counts``: command-r's first serve's
    launches; ``timed``: time_attention's timer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      grouped_decode_attention)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     multi_head_attention)
    b, h, hkv, s, d = 2, 64, 8, 2048, 128
    q, k, v = attn_inputs(b, h, hkv, s, d, torch.bfloat16, seed=11, model_layout=True)
    kept = s * (s + 1) // 2
    fn = lambda: multi_head_attention(q, k, v, causal=True, window=0)
    ref = lambda: attention_ref(q, k, v, causal=True)
    lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    compare_attention("flash_attention", fn(),
                      attention_ref(q.float(), k.float(), v.float(), causal=True),
                      "flash_attention at command-r's layer")
    err = float((lib().float() - fn().float()).abs().max())
    require(err <= SDPA_TOL, f"SDPA yardstick disagrees with flash_attention at "
            f"command-r's layer: {err:.3e}")
    bms, by = bound_attn(2 * (q.numel() + k.numel() + v.numel() + q.numel()),
                         4 * d * kept * b * h)
    rows = [dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
                 shape=f"B={b} H={h} Hkv={hkv} S={s} D={d} bf16 causal window=0 "
                       "(command-r-35b)",
                 **timed(fn, ref, lib, plain_reps=3), bound_ms=bms, bound_by=by,
                 launches=counts["flash_attention.wgmma_bf16"], also_listed=True)]
    del q, k, v
    kv, g, smax, n = 8, 8, 2080, 2079
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    qd = torch.randn((b, kv, g, d), generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc = torch.randn((2, b, smax, kv, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    length = torch.full((b,), n, dtype=torch.int32, device="cuda")
    fn = lambda: grouped_decode_attention(qd, kc, vc, length)
    ref = lambda: decode_attention_ref(qd, kc, vc, length)
    lib = lambda: F.scaled_dot_product_attention(
        qd.reshape(b, kv * g, 1, d), kc[:, :n].transpose(1, 2),
        vc[:, :n].transpose(1, 2), enable_gqa=True)
    compare_attention("decode_attention", fn(),
                      decode_attention_ref(qd.float(), kc.float(), vc.float(), length),
                      "decode_attention at command-r's decode step")
    err = float((lib().reshape(b, kv, g, d).float() - fn().float()).abs().max())
    require(err <= SDPA_TOL, f"SDPA yardstick disagrees with decode_attention at "
            f"command-r's decode step: {err:.3e}")
    bms, by = bound_attn(2 * (2 * qd.numel() + 2 * b * n * kv * d) + 4 * b,
                         4 * d * g * kv * b * n)
    rows.append(dict(name="decode_attention", route="cuda",
                     source="src/repro_torch/csrc/decode_attention.cu",
                     replaces="src/repro/kernels/decode_attention/decode_attention.py:98",
                     shape=f"B={b} KV={kv} G={g} D={d} S={smax} len={n} bf16 "
                           "window=0 (command-r-35b)",
                     **timed(fn, ref, lib, reps=50), bound_ms=bms, bound_by=by,
                     launches=counts["decode_attention"], also_listed=True))
    return rows


def _slice_attention_rows(phi3_counts, whisper_counts, timed):
    """This slice's five rows of the kernels line, each held to its plain
    version first and beside its bound, its plain version and SDPA (the
    port never calls it): K6 at phi-3-vision's prefill layer (B=2 H=32
    S=2,048 D=96, causal), at whisper's encoder layer (B=8 H=8 S=1,500
    D=64, non-causal) and over its cross rows (B=8 H=8 S=4 Sk=1,500 D=64,
    the prompt's prefill); K7 at phi3's decode step (B=2 KV=32 G=1 D=96,
    length 2,079 of a 2,080-row cache) and over whisper's 1,500 cross rows
    (B=8 KV=8 G=1 D=64).  ``phi3_counts``: phi3's first serve's launches;
    ``whisper_counts``: whisper's, split by shape (``run_whisper_serving``);
    ``timed``: time_attention's timer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      grouped_decode_attention)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     multi_head_attention)
    rows = []
    # (label, B, H, S, Sk, D, causal, launches)
    for label, b, h, s, sk, d, causal, launches in (
            ("phi-3-vision-4.2b prefill", 2, 32, 2048, 2048, 96, True,
             phi3_counts["flash_attention.wgmma_bf16"]),
            ("whisper-base encoder", 8, 8, 1500, 1500, 64, False,
             whisper_counts["flash_attention.full"]),
            ("whisper-base cross, prompt", 8, 8, 4, 1500, 64, False,
             whisper_counts["flash_attention.cross"])):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(s + sk + d + 1)
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2) for _ in range(2))
        fn = lambda: multi_head_attention(q, k, v, causal=causal)
        ref = lambda: attention_ref(q, k, v, causal=causal)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        compare_attention("flash_attention", fn(),
                          attention_ref(q.float(), k.float(), v.float(), causal=causal),
                          f"flash_attention at {label}")
        err = float((lib().float() - fn().float()).abs().max())
        require(err <= SDPA_TOL, f"SDPA yardstick disagrees with flash_attention at "
                f"{label}: {err:.3e}")
        kept = s * (s + 1) // 2 if causal else s * sk
        bms, by = bound_attn(2 * (2 * q.numel() + k.numel() + v.numel()),
                             4 * d * kept * b * h)
        rows.append(dict(name="flash_attention", route="cuda",
                         source="src/repro_torch/csrc/flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention/flash_attention.py:110",
                         shape=f"B={b} H={h} Hkv={h} S={s} Sk={sk} D={d} bf16 "
                               f"{'causal' if causal else 'non-causal'} window=0 ({label})",
                         **timed(fn, ref, lib, plain_reps=5), bound_ms=bms, bound_by=by,
                         launches=launches, also_listed=True))
        del q, k, v
    # (label, B, KV, D, cache rows, length, launches)
    for label, b, kv, d, cache_rows, n, launches in (
            ("phi-3-vision-4.2b decode", 2, 32, 96, 2080, 2079,
             phi3_counts["decode_attention"]),
            ("whisper-base cross rows", 8, 8, 64, 1500, 1500,
             whisper_counts["decode_attention.rows=1500"])):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cache_rows + d + 1)
        qd = torch.randn((b, kv, 1, d), generator=gen, device="cuda").to(torch.bfloat16)
        kc, vc = torch.randn((2, b, cache_rows, kv, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        length = torch.full((b,), n, dtype=torch.int32, device="cuda")
        fn = lambda: grouped_decode_attention(qd, kc, vc, length)
        ref = lambda: decode_attention_ref(qd, kc, vc, length)
        lib = lambda: F.scaled_dot_product_attention(
            qd.reshape(b, kv, 1, d), kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2))
        compare_attention("decode_attention", fn(),
                          decode_attention_ref(qd.float(), kc.float(), vc.float(), length),
                          f"decode_attention at {label}")
        err = float((lib().reshape(b, kv, 1, d).float() - fn().float()).abs().max())
        require(err <= SDPA_TOL, f"SDPA yardstick disagrees with decode_attention at "
                f"{label}: {err:.3e}")
        bms, by = bound_attn(2 * (2 * qd.numel() + 2 * b * n * kv * d) + 4 * b,
                             4 * d * kv * b * n)
        rows.append(dict(name="decode_attention", route="cuda",
                         source="src/repro_torch/csrc/decode_attention.cu",
                         replaces="src/repro/kernels/decode_attention/decode_attention.py:98",
                         shape=f"B={b} KV={kv} G=1 D={d} S={cache_rows} len={n} bf16 "
                               f"window=0 ({label})",
                         **timed(fn, ref, lib, reps=50), bound_ms=bms, bound_by=by,
                         launches=launches, also_listed=True))
    return rows


def f32_instances(log):
    """(instance, registers, spill-store bytes) of K6's float32 kernels
    (the forward, flash_attention_bwd_ds_kernel and
    flash_attention_bwd_grad_kernel at each head size, capped or not) from
    the build's ptxas report."""
    import re
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(flash_attention_f32_kernel|"
                      r"flash_attention_bwd_ds_kernel|flash_attention_bwd_grad_kernel)"
                      r"ILi(\d+)E(Lb([01])E)?", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}" + (
                f", {'true' if m.group(4) == '1' else 'false'}>" if m.group(3) else ">")
            spills = None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


def main() -> int:
    t_start = time.perf_counter()
    sys.stdout.reconfigure(line_buffering=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.launch.kernel_timing import nvidia_smi

    smi = nvidia_smi("name,power.limit")
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    print(f"build: {'built' if info['built'] else 'loaded'} {info['path']} "
          f"from {info['sources']} in {time.perf_counter() - t0:.2f}s")
    for line in info["ptxas_log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")
    for name, regs, spills in f32_instances(info["ptxas_log"]):
        print(f"ptxas float32 K6: {name}: {regs} registers, {spills} bytes spill stores")

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        label = " ".join([fn.__name__] + [a for a in args if isinstance(a, str)])
        print(f"phase {label}: {time.perf_counter() - t:.1f}s")
        return out

    # the autotune cache of this run: empty (the kernels' rules) but while
    # run_autotune points it elsewhere; nothing is read from or written to
    # the user's own cache
    from repro_torch.launch.kerneltune import use_tables
    empty_cache = os.path.join(tempfile.mkdtemp(prefix="chip_smoke-"), "autotune.json")
    use_tables(empty_cache)

    phase(check_pair_kernels)
    phase(check_trimatrix)
    phase(check_partial_kernel)
    phase(check_popcount_support)
    launches = phase(run_end_to_end)
    phase(run_apriori, launches)
    launches["fused_intersect_partial"] = phase(run_mesh_mines, DATA)
    launches["popcount_support"] = 0
    stream_rec, _ = phase(run_streams, launches)
    phase(run_no_compaction, launches)
    phase(run_resilience, launches)
    phase(run_autotune, launches, empty_cache)
    phase(check_stream_pairs, stream_rec)
    miner = phase(check_miner_pairs)
    phase(run_staticcheck)
    phase(check_flash_attention)
    phase(check_decode_attention)
    phase(check_slice_attention)
    params, cfg, serve_counts = phase(run_serving)
    phase(check_decode_matches_prefill, params, cfg)
    del params
    torch.cuda.empty_cache()
    model_counts = {arch: phase(run_model_serving, arch) for arch in SERVED_ARCHS}
    model_counts["whisper-base"] = phase(run_whisper_serving)
    phase(check_reduced_models)
    phase(check_flash_attention_bwd)
    phase(run_training_reduced)
    bwd_launches = phase(run_training)
    grok_launches = phase(run_training_grok)
    phase(run_training_phi3)
    whisper_bwd = phase(run_training_whisper)
    hymba_bwd = phase(run_training_recurrent)
    mesh_launches = phase(run_mesh_training)
    rows = (phase(time_kernels, launches, miner, stream_rec) +
            phase(time_attention, serve_counts, model_counts,
                  mesh_launches.pop("f32 fwd")) +
            [phase(time_flash_attention_bwd, bwd_launches),
             phase(time_capped_flash_attention_bwd, grok_launches),
             phase(time_whisper_cross_bwd, whisper_bwd),
             phase(time_hymba_training_bwd, hymba_bwd)] +
            phase(time_f32_flash_attention_bwd, mesh_launches.pop("f32 bwd")) +
            phase(time_mesh_rank_attention, mesh_launches))
    kernels_line = [dict(name=r["name"], route=r["route"], source=r["source"],
                         replaces=r["replaces"], shape=r["shape"],
                         launches=r["launches"],
                         max_abs_err=MAX_ABS_ERR[r["name"]],
                         ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"])
                    for r in rows
                    if r["listed"] and (r["shape"] == REPORT_SHAPE[r["name"]] or
                                        r.get("also_listed"))]
    # one row per kernel at its report shape, K6's capped backward at
    # grok's layer, K6's float32 forward at a reduced MoE rank, K6 and
    # K7 at hymba's and command-r's prefill and decode shapes, K6 at phi3's prefill,
    # whisper's encoder and its cross rows, K7 at phi3's decode and over
    # whisper's cross rows, K6's backward at whisper's training cross and at
    # hymba's training layer, K6's float32 backward at F32_BWD_SHAPES, K6
    # forward and backward at the full-width mesh jobs' rank shapes
    require(len(kernels_line) == len(REPORT_SHAPE) + 13 + len(F32_BWD_SHAPES)
            + 2 * len(MESH_RANKS),
            "a kernel has no timing row")
    print(f"chip_smoke wall_s={time.perf_counter() - t_start:.1f} (build included)")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
