"""Kernel timing at the miner's shapes, on the card:

    PYTHONPATH=src python3 src/repro_torch/launch/kernel_timing.py \
        --label new --out chiprun_out/kernel_timing.jsonl

Times the kernel entry points that every version of the port since the
mesh backends has (``fused_intersect`` with and without its (Q, W) store,
``fused_intersect_compact``, its given-mask front end ``compact_survivors``,
``fused_intersect_partial``, ``cooccurrence``) at the shapes of the main
path (and ``cooccurrence`` at the streaming miner's per-push shapes, with a
sweep of its word split against ``split_plan``'s pick), on two input
families: random pairs over a random frontier (the
readings PERF.md has kept since the first slice), and the miner's own pair
lists, recorded from the largest expansion of the port's fused mine of
chess and T10I4D100K on the card (``miner_inputs``; K3 on rank 0's word
slice at 4 word shards).  The miner's lists are class-ordered, which the
random ones are not.  It appends one JSON line per run to ``--out`` (the card's
``nvidia-smi`` name and power limit, the package that was timed, and per
kernel the device time per call, calls run back to back behind a sleep of
the card, beside the median and spread of CUDA-event times around each
call, which include the host's launch work).  Run as a
file, it times whichever ``repro_torch`` ``PYTHONPATH`` names, so two
checkouts are compared on one card by alternating processes (A, B, B, A).
``chip_smoke.py`` takes its inputs and its timer from here.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# main-path shapes (P, W, Q, n_valid): T10I4D100K level 3, chess level 5
PAIR_SHAPES = [(852, 3125, 4096, 3176), (60038, 100, 393216, 369616)]
# K3 shapes (P, Ws, Q) of the word-sharded mines at 4 word shards: the same
# levels
PARTIAL_SHAPES = [(60038, 25, 393216), (852, 782, 4096)]
# the mines whose largest expansion is recorded (dataset, min_sup, variant;
# data.generate(name, 1.0, 0)): T10I4D100K level 3, chess level 5
MINER_RUNS = [("T10I4D100K", 0.01, "v4"), ("chess", 0.7, "v4")]
# word shards of the K3 slices cut from the recorded frontiers
SLICE_SHARDS = 4
# Phase-2 shapes (N, W) that are timed: T10I4D100K, the tri-matrix item cap
TRI_TIMED_SHAPES = [(187, 3125), (4096, 3125)]
# the streaming miner's per-push K4 shapes (N = the universe's items, W = one
# block's words): T10I4D100K in 8,192-transaction blocks, chess in 512
SLIDE_SHAPES = [(870, 256), (75, 16)]
# word splits timed at the slide shapes, beside split_plan's pick
SWEEP_SPLITS = range(1, 9)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def event_times_ms(fn, reps: int = 20, warmup: int = 3) -> list:
    """Per-call times of ``fn`` in ms, each between two CUDA events, after
    ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    return statistics.median(event_times_ms(fn, reps, warmup))


# the SM clock is at most 1.98 GHz on an H100 SXM: sleeping this many
# cycles per second of host time outlasts it; a sleep is capped at 1 s
_SLEEP_CYCLES_PER_S = 2e9


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` in ms, the host's launch work left
    out: after ``warmup`` calls (the last one's host time measured), the
    card sleeps for twice the time the host needs to queue ``reps`` calls,
    the calls are queued behind the sleep, and CUDA events around them
    measure them run back to back, over ``reps``.  Unlike
    :func:`event_times_ms` it leaves out the host's time between launches,
    which is most of a call whose kernels take a few microseconds.  (A
    ``torch.profiler`` trace's kernel times read up to 30% low in a long
    process that had run NCCL ranks and serving; in a fresh process the
    two agree within 2%.)"""
    host = 0.0
    for _ in range(warmup):
        t = time.perf_counter()
        fn()
        host = time.perf_counter() - t
    torch.cuda.synchronize()
    sleep_s = min(1.0, 2.0 * host * reps + 1e-3)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * _SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _with_supports(bitmaps, left, right, n_valid):
    """The pairs' true left supports and min_sup at the median mode-0
    support of the first ``n_valid`` pairs, so about half of them survive."""
    from repro_torch.core.bitmap import support
    sup_left = support(bitmaps).index_select(0, left.long())
    sup0 = support(bitmaps.index_select(0, left[:n_valid].long())
                   & bitmaps.index_select(0, right[:n_valid].long()))
    min_sup = int(sup0.float().median().item()) if n_valid else 0
    return bitmaps, left, right, sup_left, min_sup


def pair_inputs(p, w, q, seed, device="cuda"):
    """Random frontier words, random pair lists and true left supports;
    min_sup at the median mode-0 support, so about half the pairs survive."""
    from repro_torch.device import words_from_numpy
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (p, w), dtype=np.uint32)
    bitmaps = words_from_numpy(words, device)
    left = torch.from_numpy(rng.integers(0, p, q).astype(np.int32)).to(device)
    right = torch.from_numpy(rng.integers(0, p, q).astype(np.int32)).to(device)
    return _with_supports(bitmaps, left, right, q)


def class_pair_inputs(p, w, q, n_valid, seed, sizes=None, device="cuda"):
    """Pairs as the miner orders them, over a (p, w) frontier of random
    words: the rows cut into contiguous classes (``sizes``, or random sizes
    of 1 to 25 rows), the classes' upper-triangle pairs in class
    order (``core.equivalence.segment_pairs``), the first ``n_valid`` of them
    followed by (0, 0) pad pairs up to ``q``, as ``PairBuffers.fill`` pads a
    rung.  Returns what :func:`pair_inputs` returns."""
    from repro_torch.core.equivalence import segment_pairs
    from repro_torch.device import words_from_numpy
    rng = np.random.default_rng(seed)
    if sizes is None:
        sizes = []
        while sum(sizes) < p:
            sizes.append(min(int(rng.integers(1, 26)), p - sum(sizes)))
    sizes = np.asarray(sizes, np.int64)
    if sizes.sum() > p:
        raise ValueError(f"classes of {int(sizes.sum())} rows exceed the {p}-row frontier")
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    left, right = segment_pairs(starts, sizes)
    if left.shape[0] < n_valid or n_valid > q:
        raise ValueError(f"{left.shape[0]} class pairs for n_valid={n_valid}, q={q}")
    lpad, rpad = np.zeros(q, np.int32), np.zeros(q, np.int32)
    lpad[:n_valid], rpad[:n_valid] = left[:n_valid], right[:n_valid]
    words = rng.integers(0, 2**32, (p, w), dtype=np.uint32)
    return _with_supports(words_from_numpy(words, device),
                          torch.from_numpy(lpad).to(device),
                          torch.from_numpy(rpad).to(device), n_valid)


def miner_inputs(txns, n_items, min_sup, variant="v4", device="cuda"):
    """The largest expansion of the port's own fused mine of ``txns`` (the
    one with the most padded pairs): a dict of the frontier ``bitmaps`` and
    the padded ``left``/``right``/``sup_left`` it was given, ``min_sup``,
    ``n_valid`` and ``mode``.  Recorded by a spy on
    ``FusedEngine._intersect_compact`` that is removed after the mine."""
    from repro_torch.core import EclatConfig, mine
    from repro_torch.core.engine import FusedEngine
    seen = {}
    original = FusedEngine._intersect_compact

    def spy(bitmaps, left, right, sup_left, min_sup, n_valid, *, mode):
        if not seen or left.shape[0] > seen["left"].shape[0]:
            seen.update(bitmaps=bitmaps.clone(), left=left.clone(),
                        right=right.clone(), sup_left=sup_left.clone(),
                        min_sup=int(min_sup), n_valid=int(n_valid), mode=mode)
        return original(bitmaps, left, right, sup_left, min_sup, n_valid, mode=mode)

    FusedEngine._intersect_compact = staticmethod(spy)
    try:
        mine(txns, n_items, EclatConfig(min_sup=min_sup, variant=variant,
                                        backend="fused"), device=device)
    finally:
        FusedEngine._intersect_compact = staticmethod(original)
    if not seen:
        raise ValueError("the mine made no expansion")
    return seen


def window_rows(left, right, tile, rows):
    """Frontier rows that K1/K3's windows stage for these pair lists, as
    the kernels choose them: per tile of ``tile`` consecutive pairs, rows
    ``[lo, hi]``, lo the tile's first left row and hi its largest operand
    row below ``lo + rows``, staged if at least as many operands as pairs
    lie there.  Returns ``(rows staged, largest window, operands read
    outside a staged window)``; the same pairs gathered row by row read
    ``2 * len(left)`` rows."""
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    staged = largest = outside = 0
    for q0 in range(0, left.shape[0], tile):
        ls, rs = left[q0:q0 + tile], right[q0:q0 + tile]
        lo = int(ls[0])
        ops = np.concatenate((ls, rs))
        inside = ops[(ops >= lo) & (ops < lo + rows)]
        if inside.size < ls.size:
            outside += ops.size
            continue
        n_rows = int(inside.max()) - lo + 1
        staged += n_rows
        largest = max(largest, n_rows)
        outside += int(((ops < lo) | (ops >= lo + n_rows)).sum())
    return staged, largest, outside


class _Rank0Mesh:
    """A one-axis mesh as ``dist.sharding`` reads it, seen from rank 0 of
    ``n`` ranks on ``data``: enough for ``shard_words`` without a process
    group."""
    mesh_dim_names = ("data",)

    def __init__(self, n):
        self.n = n

    def size(self, dim=None):
        return self.n

    def get_local_rank(self, axis=None):
        return 0


def rank0_slice(bitmaps, n_shards=SLICE_SHARDS):
    """Rank 0's word slice of a frontier at ``n_shards`` word shards, cut
    by ``dist.sharding.shard_words`` as the word-sharded backends cut it."""
    from repro_torch.dist.sharding import shard_words
    return shard_words(bitmaps, _Rank0Mesh(n_shards), "data")


def recorded_miner_inputs(data=None):
    """:func:`miner_inputs` of each of ``MINER_RUNS``, with the shape
    label its timing rows carry; ``data`` maps a dataset name to
    ``data.generate(name, 1.0, 0)``'s result (generated here if absent)."""
    from repro_torch.data import generate
    out = []
    for name, min_sup, variant in MINER_RUNS:
        txns, spec = (data or {}).get(name) or generate(name, 1.0, 0)
        rec = miner_inputs(txns, spec.n_items, min_sup, variant)
        p, w = rec["bitmaps"].shape
        rec["label"] = (f"{name} {min_sup} {variant} miner pairs: P={p} W={w} "
                        f"Q={rec['left'].shape[0]} valid={rec['n_valid']}")
        rec["name"] = name
        out.append(rec)
    return out


def tri_inputs(n, w, seed):
    from repro_torch.device import words_from_numpy
    rng = np.random.default_rng(seed)
    return words_from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32),
                            "cuda")


def unpacked_indicator(bm):
    """A function giving the (N, W) words' 0/1 indicator as an int8 (N', 32
    W) matrix, rows zero-padded to ``N' = max(17, ceil(N / 8) * 8)``: the
    operand ``torch._int_mm(d, d.t())`` needs to compute K4's counts, the
    library yardstick K4 is timed beside."""
    n, w = bm.shape
    npad = max(17, -(-n // 8) * 8)
    shifts = torch.arange(32, device=bm.device, dtype=torch.int32)

    def unpack():
        dense = ((bm[:, :, None] >> shifts) & 1).reshape(n, w * 32).to(torch.int8)
        return torch.nn.functional.pad(dense, (0, 0, 0, npad - n)).contiguous()
    return unpack


def split_sweep(bm, reps: int = 20) -> dict:
    """Device ms per call of K4 on ``bm`` under each distinct word split of
    ``SWEEP_SPLITS`` (``plan_for``), keyed by the plan ``(splits,
    split_words)``; split_plan's pick is among them or added."""
    from repro_torch.kernels.trimatrix import plan_for, split_plan, trimatrix
    n, w = bm.shape
    plans = sorted({plan_for(w, k) for k in SWEEP_SPLITS} | {split_plan(n, w)})
    return {plan: device_ms(lambda plan=plan: trimatrix(bm, plan), reps)
            for plan in plans}


def _pair_calls(inputs, bm, l, r, s, ms, nv, shape) -> list:
    """K1 with and without its store, K2 and its given-mask front end on one
    set of pair inputs."""
    from repro_torch.kernels.fused_intersect import (compact_survivors,
                                                     fused_intersect,
                                                     fused_intersect_compact,
                                                     fused_intersect_ref,
                                                     fused_support_pairs)
    flags = fused_intersect_ref(bm, l, r, s, ms, mode=0)[2]
    return [
        ("fused_intersect", inputs, shape,
         lambda: fused_intersect(bm, l, r, s, ms, mode=0)),
        ("fused_intersect without store", inputs, shape,
         lambda: fused_support_pairs(bm, l, r, s, ms, mode=0)),
        ("fused_intersect_compact", inputs, shape,
         lambda: fused_intersect_compact(bm, l, r, s, ms, nv, mode=0)),
        # rewrites flags to the valid-masked flags, the same on every call
        ("compact_survivors", inputs, shape,
         lambda: compact_survivors(bm, l, r, flags, nv, mode=0))]


def _partial_calls(inputs, bm, l, r, shape) -> list:
    """K3 without its store (as the word-sharded backends launch it) and
    with it."""
    from repro_torch.kernels.fused_intersect import fused_intersect_partial
    return [
        ("fused_intersect_partial", inputs, shape,
         lambda: fused_intersect_partial(bm, l, r, mode=0, store=False)),
        ("fused_intersect_partial with store", inputs, shape,
         lambda: fused_intersect_partial(bm, l, r, mode=0))]


def time_entry_points(reps: int) -> list:
    """One row per (kernel entry point, input family, shape): device ms per
    call, and the median, min and max of the per-call event times."""
    from repro_torch.kernels.trimatrix import cooccurrence
    calls = []
    for p, w, q, nv in PAIR_SHAPES:
        bm, l, r, s, ms = pair_inputs(p, w, q, seed=11)
        calls += _pair_calls("random", bm, l, r, s, ms, nv, f"P={p} W={w} Q={q}")
    for p, ws, q in PARTIAL_SHAPES:
        bm, l, r, _, _ = pair_inputs(p, ws, q, seed=13)
        calls += _partial_calls("random", bm, l, r, f"P={p} Ws={ws} Q={q}")
    for rec in recorded_miner_inputs():
        bm, l, r = rec["bitmaps"], rec["left"], rec["right"]
        calls += _pair_calls("miner", bm, l, r, rec["sup_left"], rec["min_sup"],
                             rec["n_valid"], rec["label"])
        part = rank0_slice(bm)
        calls += _partial_calls("miner", part, l, r,
                                f"{rec['label']} Ws={part.shape[1]}")
    for n, w in TRI_TIMED_SHAPES:
        bm = tri_inputs(n, w, seed=5)
        calls.append(("trimatrix", "random", f"N={n} W={w}",
                      lambda bm=bm: cooccurrence(bm)))
    for n, w in SLIDE_SHAPES:
        bm = tri_inputs(n, w, seed=6)
        calls.append(("trimatrix", "random", f"N={n} W={w} (slide)",
                      lambda bm=bm: cooccurrence(bm)))
    rows = []
    for name, inputs, shape, fn in calls:
        t = event_times_ms(fn, reps)
        rows.append(dict(kernel=name, inputs=inputs, shape=shape,
                         device_ms=device_ms(fn, reps), ms=statistics.median(t),
                         min_ms=min(t), max_ms=max(t), reps=reps))
    from repro_torch.kernels import trimatrix as tri
    if not hasattr(tri, "plan_for"):
        return rows     # a tree before the streaming slice: no forced splits
    for n, w in SLIDE_SHAPES:
        bm = tri_inputs(n, w, seed=6)
        dense = unpacked_indicator(bm)()
        sweep = split_sweep(bm, reps)
        rows.append(dict(kernel="trimatrix split sweep", inputs="random",
                         shape=f"N={n} W={w} (slide)",
                         split_plan=list(tri.split_plan(n, w)),
                         sweep=[[*plan, ms] for plan, ms in sweep.items()],
                         plain_ms=device_ms(lambda: tri.trimatrix_ref(bm), 3, 1),
                         int_mm_ms=device_ms(lambda: torch._int_mm(dense, dense.t()), reps),
                         reps=reps))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True,
                    help="name of the checkout being timed")
    ap.add_argument("--out", required=True, help="JSON-lines file to append to")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import _build
    _build.library()
    rec = dict(label=args.label, package=repro_torch.__file__,
               card=nvidia_smi("name,power.limit"),
               rows=time_entry_points(args.reps))
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    for row in rec["rows"]:
        if "sweep" in row:
            print(f"{args.label} {row['kernel']} {row['shape']}: device ms per "
                  f"call by (splits, split_words) {row['sweep']}; split_plan "
                  f"picks {row['split_plan']}; plain {row['plain_ms']:.5f} ms, "
                  f"torch._int_mm of the unpacked indicator {row['int_mm_ms']:.5f} ms")
            continue
        print(f"{args.label} {row['kernel']} ({row['inputs']} pairs) {row['shape']}: device "
              f"{row['device_ms']:.5f} ms per call; events median "
              f"{row['ms']:.5f} ms (min {row['min_ms']:.5f}, "
              f"max {row['max_ms']:.5f}, {row['reps']} calls)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
