#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card:

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into the git-ignored
``build/``) and holds every kernel against its plain torch version on the
card at the shapes the main paths give it.  Then it drives both ported
paths end to end:

* the batch miner ``mine()`` on the paper's T10I4D100K and chess datasets
  at full scale, against the reference package's checksums;
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
* LM serving of gemma3-4b at full width and depth (bf16, random weights
  from a seeded generator): ``ServingEngine.serve`` of 8 requests, twice,
  with the flash- and decode-attention kernels' launch counts and
  identical greedy outputs required, decode-matches-prefill over all 34
  layers, and the model through the kernels against the same model with
  their plain versions in their place, in float32 and in bf16;

and times each kernel beside its bound, its plain version and, where one
exists, a PyTorch call that computes the same function (K4 also at the
streams' per-push shapes, with a sweep of its word split).  The pair kernels
(K1, K2, K3) are held and timed on random pair lists and on the pair lists
of the largest expansion of the fused mines of chess and T10I4D100K,
recorded on the card (class-ordered, as the miner makes them); the kernels
line reports K1 and K3 on the latter.

Output, in order: the device lines (``nvidia-smi`` name and power limit,
torch and CUDA versions, build time), one line per kernel check, one line
per end-to-end run, one line per timing, then a JSON line
``{"kernels": [...]}`` and last ``{"ok": true, "device": {...}}``.  Any
mismatch or failure exits non-zero before the last line.  With no CUDA
device, or outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import json
import os
import sys
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
# K5 shapes (M, W): the row pairs of T10I4D100K level 3 and of chess level
# 5, pre-gathered (no mining path calls K5)
PS_SHAPES = [(4096, 3125), (393216, 100)]

# Phase-2 shapes (N, W) that are checked: T10I4D100K, 1000 items, the
# tri-matrix item cap, chess (13 word ranges), and tile and word edges
TRI_SHAPES = [(187, 3125), (1000, 3125), (4096, 3125), (1, 1), (33, 7),
              (37, 100), (65, 7), (129, 3125)]

# H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1.979e15  # two operations per multiply-add
BF16_TENSOR_FLOPS = 9.89e14       # dense bf16, two per multiply-add
FP32_FLOPS = 6.7e13               # float32 outside the tensor cores


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
                "decode_attention": "B=2 KV=4 G=2 D=256 S=2080 len=2079 bf16 window=0"}
MINING_KERNELS = ("fused_intersect", "fused_intersect_compact", "trimatrix")
# the mining kernels the fused mines launch: K1's arithmetic runs inside
# K2's one pass, so a mine launches K1 (fused_intersect) no time
MAIN_PATH_MINING = ("fused_intersect_compact", "trimatrix")
# the kernels of one K2 call, as a profiler trace names them: one pass
# writes survivors and pad rows
COMPACT_KERNELS = ("compact_pairs_kernel",)

# largest |kernel - plain| seen by the checks, per kernel
MAX_ABS_ERR = {name: 0 for name in REPORT_SHAPE}

# the generated datasets, by name: (transactions, spec)
DATA = {}

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
    ``mine()`` of the window, to the ``ref`` stream and to the reference's
    pinned checksum, with the kernels' launches per push and per mine; then
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
        print(f"e2e stream generate {name}: {n_batches} batches of {block_txns} "
              f"txns in {time.perf_counter() - t0:.2f}s (host)")
    original = FusedEngine._intersect_compact
    for name, n_blocks, block_txns, min_sup, n_batches, drift in STREAMS:
        n_items = stream_spec(name).n_items
        pinned = STREAM_CHECKSUMS[name]
        sums = {}
        for backend in ("fused", "ref"):
            what = f"stream {name} {backend}"
            cfg = StreamConfig(min_sup=min_sup, n_blocks=n_blocks,
                               block_txns=block_txns, backend=backend)
            miner = StreamingMiner(n_items, cfg)
            ring = miner.ring.device
            seen = {}

            def spy(bitmaps, left, right, sup_left, min_sup_, n_valid, *, mode):
                # the level-2 expansion runs over the ring itself
                if (bitmaps.data_ptr() == ring.data_ptr() and
                        (not seen or left.shape[0] > seen["left"].shape[0])):
                    seen.update(bitmaps=bitmaps.clone(), left=left.clone(),
                                right=right.clone(), sup_left=sup_left.clone(),
                                min_sup=int(min_sup_), n_valid=int(n_valid))
                return original(bitmaps, left, right, sup_left, min_sup_,
                                n_valid, mode=mode)

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
                    kernels.reset_launch_counts()
                    t0 = time.perf_counter()
                    whole = mine(miner.window_transactions(), n_items,
                                 EclatConfig(min_sup=min_sup))
                    batch_s = time.perf_counter() - t0
                    batch_sum = support_checksum(whole.support_map())
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
                          f"batch_mine_s={batch_s:.4f} "
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
        _, n_blocks, block_txns, min_sup, n_batches, drift = next(
            st for st in STREAMS if st[0] == name)
        jobs.append(dict(kind="stream", stream=(name, block_txns, n_batches, 0, drift),
                         n_items=stream_spec(name).n_items, grid=grid,
                         label=label, name=name, n_blocks=n_blocks,
                         config=dict(min_sup=min_sup, n_blocks=n_blocks,
                                     block_txns=block_txns, backend=backend,
                                     shard=shard)))
    t0 = time.perf_counter()
    per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cuda",
                         args=(jobs,), timeout=600)
    print(f"e2e stream mesh gloo 4 ranks on one card: {len(jobs)} streams in "
          f"{time.perf_counter() - t0:.2f}s with spawn, each rank regenerating "
          f"the streams (a correctness topology: its times are no measure of "
          f"a 4-card mesh)")
    for j, job in enumerate(jobs):
        _check_mesh_stream(job, [r[j] for r in per_rank], times)
    return recorded, times


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


def bound(nbytes, products):
    """Least time in ms for work that moves ``nbytes`` and holds ``products``
    one-bit multiply-adds, and which of the two bounds it.  The fastest
    route the card has for bit products is the dense int8 tensor-core
    product of the 0/1 indicator; the packed kernels use the popcount pipe,
    which is slower, so this bound is below what they can reach."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 2 * products / INT8_TENSOR_OPS_PER_S * 1e3
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

    print(f"timing peaks (H100 SXM data sheet, dense, 700 W): HBM "
          f"{HBM_BYTES_PER_S:.3e} B/s; int8 tensor cores "
          f"{INT8_TENSOR_OPS_PER_S:.3e} op/s, two per one-bit product")

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
        # in the kernels line): K1 store-free (fused_support_pairs; since K2
        # runs its arithmetic inside its own pass, no main path launches
        # K1), K1 with its store (the op the reference package exports), K2,
        # and K2's given-mask front end (the word-sharded backends'
        # compaction after their all-reduce: it reads the mask, not
        # sup_left, and writes no supports)
        for name, fn, ref, replaces, nbytes, listed in (
                ("fused_intersect",
                 lambda: fused_support_pairs(bm, l, r, s, ms, mode=0),
                 lambda: fused_intersect_ref(bm, l, r, s, ms, mode=0)[1:],
                 f"{tpu_src}:244", in_bytes + 2 * q * 4, True),
                ("fused_intersect with (Q, W) store",
                 lambda: fused_intersect(bm, l, r, s, ms, mode=0),
                 lambda: fused_intersect_ref(bm, l, r, s, ms, mode=0),
                 f"{tpu_src}:244", in_bytes + q * w * 4 + 2 * q * 4, False),
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
          "call_ms CUDA events around each call; fused_intersect and "
          "fused_intersect_partial are timed store-free, as the compaction "
          "and the word-sharded backends use them; no main path launches "
          "fused_intersect on its own (its arithmetic runs inside "
          "fused_intersect_compact's pass); fused_intersect_partial "
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
    # (label, B, H, Hkv, S, D, causal, window, model layout)
    cases = [
        ("gemma3-4b global", 2, 8, 4, 2048, 256, True, 0, True),
        ("gemma3-4b local", 2, 8, 4, 2048, 256, True, 1024, True),
        ("ragged S=1000 local", 2, 8, 4, 1000, 256, True, 1024, False),
        ("ragged S=37 window 8", 1, 8, 4, 37, 256, True, 8, False),
        ("G=1", 1, 8, 8, 300, 256, True, 0, False),
        ("G=8 (gemma-2b MQA)", 1, 8, 1, 2048, 256, True, 0, True),
        ("non-causal window 100", 1, 4, 2, 333, 128, False, 100, False),
        ("D=16 (reduced configs)", 2, 4, 1, 50, 16, True, 8, True),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        limit = LIMIT_TEXT[str(dtype).split(".")[1]]
        name, variant = (("flash_attention", "wgmma_bf16") if dtype == torch.bfloat16
                         else ("flash_attention_f32", "fma_f32"))
        for label, b, h, hkv, s, d, causal, window, layout in cases:
            q, k, v = attn_inputs(b, h, hkv, s, d, dtype, seed=s + h + d, model_layout=layout)
            kernels.reset_launch_counts()
            got = multi_head_attention(q, k, v, causal=causal, window=window)
            again = multi_head_attention(q, k, v, causal=causal, window=window)
            counts = kernels.variant_counts()
            want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                 window=window or None)
            torch.cuda.synchronize()
            require(counts == {f"flash_attention.{x}": 2 if x == variant else 0
                               for x in ("wgmma_bf16", "fma_f32")},
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
                                            window=window or None)
                _, emu_ratio = compare_attention(name, got, emu,
                                                 f"flash_attention {label} {dtype} vs split-P")
                split = f"; vs the split-P emulation at {emu_ratio:.3f} x the limit"
            print(f"check flash_attention {label} B={b} H={h} Hkv={hkv} S={s} "
                  f"D={d} causal={causal} window={window} {dtype} ({variant}): max "
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
    # (B, KV, G, D, lengths)
    # lengths at the kernel's 64-row chunk edges (64, 65, 2,047, 2,080) with
    # every group size; windows of 1,024 start inside a chunk
    cases = [(2, 4, 2, 256, [1, 2080]), (2, 4, 2, 256, [2079, 1537]),
             (4, 1, 8, 256, [1, 777, 2079, 2080]), (3, 2, 4, 16, [5, 64, 65]),
             (2, 4, 1, 128, [1000, 3]), (2, 4, 2, 256, [64, 2047]),
             (4, 4, 1, 256, [64, 65, 2047, 2080]), (4, 2, 4, 256, [65, 64, 2080, 2047]),
             (4, 1, 8, 256, [2047, 65, 64, 2080])]
    s = 2080
    for dtype in (torch.bfloat16, torch.float32):
        limit = LIMIT_TEXT[str(dtype).split(".")[1]]
        for b, kv, g, d, lens in cases:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(b * 100 + g + d)
            q = torch.randn((b, kv, g, d), generator=gen, device="cuda").to(dtype)
            # the layer slice of a stacked per-stage cache, as the model has it
            cache = torch.randn((2, 2, b, s, kv, d), generator=gen,
                                device="cuda").to(dtype)
            k, v = cache[0, 1], cache[1, 1]
            length = torch.tensor(lens, dtype=torch.int32, device="cuda")
            for window in (0, 1024):
                got = grouped_decode_attention(q, k, v, length, window=window)
                again = grouped_decode_attention(q, k, v, length, window=window)
                want = decode_attention_ref(q.float(), k.float(), v.float(),
                                            length, window=window)
                torch.cuda.synchronize()
                require(torch.equal(got, again),
                        f"decode_attention B={b} KV={kv} G={g} len={lens} "
                        f"window={window} {dtype}: two calls differ")
                err, ratio = compare_attention(
                    "decode_attention", got, want,
                    f"decode_attention B={b} KV={kv} G={g} D={d} "
                    f"len={lens} window={window} {dtype}")
                print(f"check decode_attention B={b} KV={kv} G={g} D={d} S={s} "
                      f"lengths={lens} window={window} {dtype}: max abs err "
                      f"{err:.3e} from the plain output; error vs float32 at "
                      f"{ratio:.3f} x its limit ({limit}); two calls equal")


def serve_requests(vocab):
    import numpy as np
    from repro_torch.launch.serve_profile import SERVE_MAX_NEW, SERVE_PROMPTS
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=SERVE_MAX_NEW)
            for i, n in enumerate(SERVE_PROMPTS)]


def run_serving():
    """gemma3-4b at full width and depth, bf16, random weights from a seeded
    generator: ServingEngine.serve twice on the same requests.  Returns the
    params, the config and the launch counts of the first serve."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_profile import (ARCH, SERVE_BATCHES,
                                                  SERVE_MAX_NEW, SERVE_PROMPTS,
                                                  SERVE_S_MAX)
    from repro_torch.models import Model, init_params, stages_meta
    from repro_torch.serving import ServingEngine

    cfg = get_config(ARCH)
    n_layers = sum(c for _, c in stages_meta(cfg))
    require(n_layers == 34, f"gemma3-4b has {n_layers} layers, expected 34")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve init gemma3-4b: {n_params} parameters ({cfg.dtype}, "
          f"{n_params * 2 / 1e9:.2f} GB; config param_count "
          f"{cfg.param_count()}) in {time.perf_counter() - t0:.2f}s")
    # the config's analytic count leaves out the final norm's scale
    require(n_params == cfg.param_count() + cfg.d_model,
            "parameter count differs from the config's")
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
        print(f"serve run {run}: {len(results)} requests ({SERVE_PROMPTS} prompt "
              f"tokens, {SERVE_MAX_NEW} new each, {SERVE_BATCHES} batches -> "
              f"{n_sub} prefill sub-batches, {steps} decode steps) wall_s={wall:.4f} "
              f"prefill_s={stats['phase_s']['prefill']:.4f} "
              f"decode_s={stats['phase_s']['decode']:.4f} "
              f"decode_ms_per_step={stats['phase_s']['decode'] / steps * 1e3:.3f} "
              f"generated_tokens={n_tok} tokens_per_s={n_tok / wall:.2f} "
              f"answer_ms p50={lat['answer_ms']['p50']:.1f} p99={lat['answer_ms']['p99']:.1f} "
              f"pack_eff={stats['padding_efficiency']:.3f} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"launches={counts}")
        require(len(results) == len(reqs), "not every request was answered")
        for r in reqs:
            o = results[r.rid]
            require(o.shape == (SERVE_MAX_NEW,) and o.dtype == np.int32,
                    f"request {r.rid}: output {o.shape} {o.dtype}")
            require(bool(((o >= 0) & (o < cfg.vocab_size)).all()),
                    f"request {r.rid}: token out of the vocabulary")
        require(counts["flash_attention"] == n_layers * n_sub,
                f"flash_attention launched {counts['flash_attention']} times, "
                f"expected {n_layers} per prefill sub-batch x {n_sub}")
        require(counts["flash_attention.wgmma_bf16"] == n_layers * n_sub and
                counts["flash_attention.fma_f32"] == 0,
                f"the bf16 serve launched the flash_attention variants "
                f"wgmma_bf16 {counts['flash_attention.wgmma_bf16']} times and "
                f"fma_f32 {counts['flash_attention.fma_f32']} times, expected "
                f"{n_layers * n_sub} and 0")
        require(counts["decode_attention"] == n_layers * steps,
                f"decode_attention launched {counts['decode_attention']} times, "
                f"expected {n_layers} per decode step x {steps}")
        require(all(counts[k] == 0 for k in MINING_KERNELS),
                "serving launched a mining kernel")
        outputs.append(results)
        if first_counts is None:
            first_counts = counts
    for r in reqs:
        require(np.array_equal(outputs[0][r.rid], outputs[1][r.rid]),
                f"request {r.rid}: greedy outputs differ between two runs")
    print(f"serve: greedy outputs identical across two runs "
          f"(request 0 starts {outputs[0][0][:8].tolist()})")
    return params, cfg, first_counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_decode_matches_prefill(params, cfg):
    """Logits of the last prompt position, prefilled whole and prefilled to
    2,048 - K then decoded K steps, in float32 (the served weights, cast)
    and in bf16 (the served model); and in both dtypes the same two runs
    with the attention kernels' plain versions in their place."""
    import contextlib
    import dataclasses
    import numpy as np
    import torch
    import repro_torch.models.attention as attn_mod
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.launch.serve_profile import SERVE_S_MAX
    from repro_torch.models import Model

    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2048))).cuda()
    split = prompt.shape[1] - DECODE_K

    def both_paths(p, dtype):
        model = Model(dataclasses.replace(cfg, dtype=dtype))
        with torch.inference_mode():
            full, _ = model.prefill(p, {"tokens": prompt}, SERVE_S_MAX)
            logits, cache = model.prefill(p, {"tokens": prompt[:, :split]}, SERVE_S_MAX)
            for t in range(split, prompt.shape[1]):
                pos = torch.full((1,), t, dtype=torch.int32, device="cuda")
                logits, cache = model.decode_step(p, prompt[:, t:t + 1], cache, pos)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(full).all() and torch.isfinite(logits).all()),
                f"{dtype}: non-finite logits")
        return full, logits

    @contextlib.contextmanager
    def plain_attention():
        """The model with the kernels' plain versions in their place (a
        patch of this process only; the package has no switch for it)."""
        saved = attn_mod.multi_head_attention, attn_mod.grouped_decode_attention
        attn_mod.multi_head_attention = lambda q, k, v, *, causal, window, sm_scale: \
            attention_ref(q, k, v, causal=causal, window=window or None, sm_scale=sm_scale)
        attn_mod.grouped_decode_attention = decode_attention_ref
        kernels.reset_launch_counts()
        try:
            yield
        finally:
            attn_mod.multi_head_attention, attn_mod.grouped_decode_attention = saved
        require(not any(kernels.launch_counts().values()),
                "the plain-path run launched a kernel")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def variants_used(dtype, want):
        got = kernels.variant_counts()
        other = ({"wgmma_bf16", "fma_f32"} - {want}).pop()
        require(got[f"flash_attention.{want}"] > 0 and got[f"flash_attention.{other}"] == 0,
                f"{dtype} model runs launched flash_attention variants {got}")
        print(f"check {dtype} model runs: flash_attention variants {got}")

    p32 = _cast(params, torch.float32)
    kernels.reset_launch_counts()
    full32, dec32 = both_paths(p32, "float32")
    variants_used("float32", "fma_f32")
    with plain_attention():
        plain_full32, plain_dec32 = both_paths(p32, "float32")
    del p32
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    full16, dec16 = both_paths(params, "bfloat16")
    variants_used("bfloat16", "wgmma_bf16")
    with plain_attention():
        plain_full16, plain_dec16 = both_paths(params, "bfloat16")

    kp_full, kp_dec = rel(full32, plain_full32), rel(dec32, plain_dec32)
    print(f"check kernels vs plain path gemma3-4b float32 (all 34 layers): "
          f"prefill logits rel L2 err {kp_full:.3e}, after {DECODE_K} decode "
          f"steps {kp_dec:.3e}, both <= {DECODE_TOL_F32:.0e}")
    require(kp_full <= DECODE_TOL_F32 and kp_dec <= DECODE_TOL_F32,
            "the kernel path and the plain path differ at full width (float32)")
    kp16_full, kp16_dec = rel(full16, plain_full16), rel(dec16, plain_dec16)
    same = (bool(torch.equal(full16.argmax(-1), plain_full16.argmax(-1))) and
            bool(torch.equal(dec16.argmax(-1), plain_dec16.argmax(-1))))
    print(f"check kernels vs plain path gemma3-4b bfloat16 (all 34 layers): "
          f"prefill logits rel L2 err {kp16_full:.3e}, after {DECODE_K} decode "
          f"steps {kp16_dec:.3e}, both <= {KERNELS_VS_PLAIN_BF16:.0e}, same "
          f"argmax {same}; the plain path's own bf16 error vs float32 is "
          f"{rel(plain_full16, plain_full32):.3e} (prefill), "
          f"{rel(plain_dec16, plain_dec32):.3e} (decode)")
    require(kp16_full <= KERNELS_VS_PLAIN_BF16 and kp16_dec <= KERNELS_VS_PLAIN_BF16,
            "the kernel path and the plain path differ at full width (bfloat16)")

    r32, r16 = rel(dec32, full32), rel(dec16, full16)
    floor, dec_err = rel(full16, full32), rel(dec16, full32)
    top = {n: bool(torch.equal(a.argmax(-1), b.argmax(-1)))
           for n, (a, b) in {"float32": (dec32, full32),
                             "bfloat16": (dec16, full16)}.items()}
    print(f"check decode-matches-prefill gemma3-4b float32: prompt 2048, "
          f"prefill {split} + {DECODE_K} decode steps vs prefill 2048: rel L2 "
          f"err {r32:.3e} <= {DECODE_TOL_F32:.0e}, max abs err "
          f"{float((dec32 - full32).abs().max()):.3e} (logits max abs "
          f"{float(full32.abs().max()):.3f}), same argmax {top['float32']}")
    print(f"check decode-matches-prefill gemma3-4b bfloat16: rel L2 err "
          f"{r16:.3e} (max abs {float((dec16 - full16).abs().max()):.3e}, same "
          f"argmax {top['bfloat16']}); against float32 the prefill path is off "
          f"by {floor:.3e} and the decode path by {dec_err:.3e} <= "
          f"{DECODE_BF16_FACTOR} x {floor:.3e}")
    require(r32 <= DECODE_TOL_F32,
            f"decode does not match prefill in float32: rel err {r32:.3e}")
    require(dec_err <= DECODE_BF16_FACTOR * floor,
            f"bf16 decode path off float32 by {dec_err:.3e}, more than "
            f"{DECODE_BF16_FACTOR} x the prefill path's {floor:.3e}")


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def bound_attn(nbytes, flops, rate=BF16_TENSOR_FLOPS):
    """Least time in ms for work that moves ``nbytes`` and does ``flops``
    operations (two per multiply-add) at ``rate``: the dense bf16
    tensor-core rate for bf16 inputs, the float32 rate for float32."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_attention(counts):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      grouped_decode_attention)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     multi_head_attention)
    from repro_torch.launch.kernel_timing import device_ms, median_ms

    def timed(kernel, plain, library, reps=20, plain_reps=20):
        """ms, plain_ms, library_ms: device time per call (calls run back
        to back behind a sleep of the card); *_call_ms: CUDA events around
        each call, the host's launch work included."""
        out = {}
        for key, fn, n in (("ms", kernel, reps), ("plain_ms", plain, plain_reps),
                           ("library_ms", library, reps)):
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
            bms32, by32 = bound_attn(2 * nbytes, 4 * d * kept * b * h, FP32_FLOPS)
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
    for row in rows:
        row["listed"] = True
        print(f"timing {row['name']} {row['shape']}: ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}) library_ms={row['library_ms']:.5f} "
              f"launches_on_main_path={row['launches']}; per call with the host's "
              f"launch work: call_ms={row['call_ms']:.5f} "
              f"plain_call_ms={row['plain_call_ms']:.5f} "
              f"library_call_ms={row['library_call_ms']:.5f}")
        for key in ("ms", "plain_ms", "library_ms"):
            require(row["bound_ms"] <= row[key],
                    f"{row['name']} {row['shape']}: bound_ms "
                    f"{row['bound_ms']:.5f} exceeds {key} {row[key]:.5f}")
    print("timing note: attention bounds count the (row, column) pairs the "
          "masks keep, 4 D operations each, at the dense bf16 tensor-core "
          "rate (flash_attention_f32: the float32 rate, 6.7e13 FLOP/s, and 4-byte "
          "elements), and q, k, v, out (decode: the valid cache rows) read or "
          "written once; library_ms is torch scaled_dot_product_attention "
          "(enable_gqa; the windowed layer with a boolean mask), which the "
          "port never calls; launches are the first bf16 serve's, per variant "
          "(the float32 variant serves no bf16 model); ms, plain_ms and "
          "library_ms of the attention rows are device time per call "
          "(calls run back to back behind a sleep of the card), call_ms "
          "CUDA events around each call")
    return rows


def main() -> int:
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

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t:.1f}s")
        return out

    phase(check_pair_kernels)
    phase(check_trimatrix)
    phase(check_partial_kernel)
    phase(check_popcount_support)
    launches = phase(run_end_to_end)
    launches["fused_intersect_partial"] = phase(run_mesh_mines, DATA)
    launches["popcount_support"] = 0
    stream_rec, _ = phase(run_streams, launches)
    phase(check_stream_pairs, stream_rec)
    miner = phase(check_miner_pairs)
    phase(check_flash_attention)
    phase(check_decode_attention)
    params, cfg, serve_counts = phase(run_serving)
    phase(check_decode_matches_prefill, params, cfg)
    del params
    torch.cuda.empty_cache()
    rows = phase(time_kernels, launches, miner, stream_rec) + phase(time_attention, serve_counts)
    kernels_line = [dict(name=r["name"], route=r["route"], source=r["source"],
                         replaces=r["replaces"], shape=r["shape"],
                         launches=r["launches"],
                         max_abs_err=MAX_ABS_ERR[r["name"]],
                         ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"])
                    for r in rows
                    if r["listed"] and r["shape"] == REPORT_SHAPE[r["name"]]]
    require(len(kernels_line) == len(REPORT_SHAPE), "a kernel has no timing row")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
