"""Kernel timing at the miner's shapes, on the card:

    PYTHONPATH=src python3 src/repro_torch/launch/kernel_timing.py \
        --label new --out chiprun_out/kernel_timing.jsonl

Times the kernel entry points that every version of the port has
(``fused_intersect``, ``fused_intersect_compact``, ``cooccurrence``) with
CUDA events at the shapes of the main path, and appends one JSON line per
run to ``--out`` (the card's ``nvidia-smi`` name and power limit, the
package that was timed, the median and spread of each kernel).  Run as a
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

import numpy as np
import torch

# main-path shapes (P, W, Q, n_valid): T10I4D100K level 3, chess level 5
PAIR_SHAPES = [(852, 3125, 4096, 3176), (60038, 100, 393216, 369616)]
# Phase-2 shapes (N, W) that are timed: T10I4D100K, the tri-matrix item cap
TRI_TIMED_SHAPES = [(187, 3125), (4096, 3125)]


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


def pair_inputs(p, w, q, seed):
    """Random frontier words, pair lists and true left supports on the card;
    min_sup at the median mode-0 support, so about half the pairs survive."""
    from repro_torch.core.bitmap import support
    from repro_torch.device import words_from_numpy
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (p, w), dtype=np.uint32)
    bitmaps = words_from_numpy(words, "cuda")
    left = torch.from_numpy(rng.integers(0, p, q).astype(np.int32)).cuda()
    right = torch.from_numpy(rng.integers(0, p, q).astype(np.int32)).cuda()
    sup_left = support(bitmaps).index_select(0, left.long())
    sup0 = support(bitmaps.index_select(0, left.long())
                   & bitmaps.index_select(0, right.long()))
    min_sup = int(sup0.float().median().item()) if q else 0
    return bitmaps, left, right, sup_left, min_sup


def tri_inputs(n, w, seed):
    from repro_torch.device import words_from_numpy
    rng = np.random.default_rng(seed)
    return words_from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32),
                            "cuda")


def time_entry_points(reps: int) -> list:
    """One row per (kernel entry point, shape): median, min and max ms."""
    from repro_torch.kernels.fused_intersect import (fused_intersect,
                                                     fused_intersect_compact)
    from repro_torch.kernels.trimatrix import cooccurrence
    calls = []
    for p, w, q, nv in PAIR_SHAPES:
        bm, l, r, s, ms = pair_inputs(p, w, q, seed=11)
        shape = f"P={p} W={w} Q={q}"
        calls.append(("fused_intersect", shape,
                      lambda bm=bm, l=l, r=r, s=s, ms=ms:
                      fused_intersect(bm, l, r, s, ms, mode=0)))
        calls.append(("fused_intersect_compact", shape,
                      lambda bm=bm, l=l, r=r, s=s, ms=ms, nv=nv:
                      fused_intersect_compact(bm, l, r, s, ms, nv, mode=0)))
    for n, w in TRI_TIMED_SHAPES:
        bm = tri_inputs(n, w, seed=5)
        calls.append(("trimatrix", f"N={n} W={w}",
                      lambda bm=bm: cooccurrence(bm)))
    rows = []
    for name, shape, fn in calls:
        t = event_times_ms(fn, reps)
        rows.append(dict(kernel=name, shape=shape, ms=statistics.median(t),
                         min_ms=min(t), max_ms=max(t), reps=reps))
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
        print(f"{args.label} {row['kernel']} {row['shape']}: "
              f"median {row['ms']:.5f} ms (min {row['min_ms']:.5f}, "
              f"max {row['max_ms']:.5f}, {row['reps']} calls)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
