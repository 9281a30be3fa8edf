"""The H100's rates, and the cost models that order the tuner's candidates.

Rates: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit (a
card set lower runs slower under load).  ``chip_smoke.py`` computes every
kernel's bound from them.

The models below rank a kernel's tiles for ``kernels.autotune``: they
put the predicted winner first, so a truncated sweep keeps it.  They are
models of the launch's shape (bytes, waves of blocks over the SMs, the
sequential steps of one block), not predictions of its time; the tuner
measures.  The kernels' geometry is read from their bindings (imported
where it is used, so the rates load without them); no binding imports
this module.
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = ["HBM_BYTES_PER_S", "INT8_TENSOR_OPS_PER_S", "BF16_TENSOR_FLOPS",
           "FP32_FLOPS", "SMS", "SMEM_PER_SM", "THREADS_PER_SM", "Cost", "intersect_cost", "cooccurrence_cost"]

HBM_BYTES_PER_S = 3.35e12
SMEM_PER_SM = 228 * 1024          # shared memory of one SM
THREADS_PER_SM = 2048
INT8_TENSOR_OPS_PER_S = 1.979e15  # two operations per multiply-add
BF16_TENSOR_FLOPS = 9.89e14       # dense bf16, two per multiply-add
FP32_FLOPS = 6.7e13               # float32 outside the tensor cores
SMS = 132                         # streaming multiprocessors

# the time one dependent step of a block takes in the models: a round trip
# to L2 of the loads it has in flight, about a microsecond
STEP_S = 1e-6


class Cost(NamedTuple):
    """A candidate's modelled cost: ``bound_s`` the larger of the byte time
    (``nbytes`` over the memory rate) and the step time (``waves`` of
    blocks, each ``steps`` dependent steps long); ``model`` the quantity the
    kernel's own plan minimises, in its units."""
    bound_s: float
    nbytes: int
    waves: int
    steps: int
    model: int


def intersect_cost(q: int, w: int, lanes: int | None = None, *, plan=None) -> Cost:
    """K2 (gather + AND + popcount + compaction) for ``q`` pairs of
    ``w``-word rows at ``lanes`` lanes per pair; with ``plan`` (a
    ``WindowPlan``) instead, K1 or K3 under that plan.

    Bytes: the two rows each pair touches and its output row (the (Q, W)
    store), each once.  Steps: a block's groups take their pairs one after
    the other, each pair ``ceil(elements / (lanes x in flight))`` steps, and
    again for the output rows; the tiles run in waves of the resident
    blocks over the 132 SMs.  Wide lanes finish a pair in fewer steps but
    hold fewer pairs a block; narrow ones the opposite.

    K1/K3: a block of 256 threads takes a tile of ``plan.tile`` pairs at
    ``256 // tile`` lanes each; the blocks resident on an SM are those whose
    shared memory (the plan's and the 3 KB of static arrays) fits its 228 KB,
    at most 8; a tile is its chunks one after the other, each a wait for its
    stage (staged chunks) and ``ceil(elements / (lanes x 4 in flight))``
    steps of each lane."""
    from ..kernels.fused_intersect.fused_intersect import (
        COMPACT_BLOCKS_PER_SM, COMPACT_LANES, COMPACT_PAIRS_PER_GROUP,
        COMPACT_TILE_PAIRS, COMPACT_UNROLL, WINDOW_THREADS, elem_words)
    if plan is not None:
        q, w = max(int(q), 1), max(int(w), 1)
        tile, chunk = int(plan.tile), int(plan.chunk)
        lanes = WINDOW_THREADS // tile
        per_sm = max(1, min(THREADS_PER_SM // WINDOW_THREADS,
                            SMEM_PER_SM // (int(plan.smem) + 3 * 1024)))
        waves = -(-(-(-q // tile)) // (SMS * per_sm))
        n_chunks = 1 if chunk >= w else -(-w // chunk)
        width = min(chunk, w)
        per_chunk = -(-(width // elem_words(w) or 1) // (lanes * 4))
        steps = n_chunks * (per_chunk + (0 if chunk >= w else 1))
        nbytes = 3 * q * w * 4
        return Cost(max(nbytes / HBM_BYTES_PER_S, waves * steps * STEP_S),
                    nbytes, waves, steps, waves * steps)
    q, w, g = max(int(q), 1), max(int(w), 1), int(lanes)
    if g not in COMPACT_LANES:
        raise ValueError(f"lanes must be one of {COMPACT_LANES}, got {lanes!r}")
    tiles = -(-q // COMPACT_TILE_PAIRS[g])
    waves = -(-tiles // (SMS * COMPACT_BLOCKS_PER_SM[g]))
    per_pair = -(-(w // elem_words(w)) // (g * COMPACT_UNROLL[g]))
    steps = 2 * COMPACT_PAIRS_PER_GROUP[g] * per_pair
    nbytes = 3 * q * w * 4
    step_s = waves * steps * STEP_S
    return Cost(max(nbytes / HBM_BYTES_PER_S, step_s), nbytes, waves, steps,
                waves * steps)


def cooccurrence_cost(n: int, w: int, plan: tuple) -> Cost:
    """K4 (the (N, N) co-occurrence counts of N rows of ``w`` words) cut
    into ``plan = (splits, split_words)`` ranges of the word axis: one block
    per (output tile on or above the diagonal, range), in waves over the
    SMs, each ``split_words / 8`` stages plus 2 (its start and its store).
    ``model`` is that product, ``kernels.trimatrix.split_cost``, the
    quantity ``split_plan`` minimises.  Bytes: the words read once and the
    counts written once."""
    from ..kernels.trimatrix.trimatrix import STAGE_WORDS, split_cost, tile_count
    n, w = max(int(n), 1), max(int(w), 1)
    splits, split_words = int(plan[0]), int(plan[1])
    waves = -(-tile_count(n) * splits // SMS)
    steps = split_words // STAGE_WORDS + 2
    nbytes = n * w * 4 + n * n * 4
    ops = 2 * n * n * w * 32
    bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_TENSOR_OPS_PER_S,
                waves * steps * STEP_S)
    return Cost(bound, nbytes, waves, steps, split_cost(n, plan))
