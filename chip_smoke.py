#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card:

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into the git-ignored
``build/``), holds every kernel against its plain torch version on the card
at the shapes the miner gives it, drives the batch miner ``mine()`` end to
end on the paper's T10I4D100K and chess datasets at full scale, checks the
results against the reference package's checksums, and times each kernel.

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

# Phase-2 shapes (N, W) that are checked: T10I4D100K, 1000 items, the
# tri-matrix item cap, and two small edge cases
TRI_SHAPES = [(187, 3125), (1000, 3125), (4096, 3125), (1, 1), (33, 7)]

# H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1.979e15  # two operations per multiply-add


# the shape of each kernel's row in the "kernels" line: the largest call
# the main path makes (chess level 5; T10I4D100K Phase 2)
REPORT_SHAPE = {"fused_intersect": "P=60038 W=100 Q=393216",
                "fused_intersect_compact": "P=60038 W=100 Q=393216",
                "trimatrix": "N=187 W=3125"}

# largest |kernel - plain| seen by the checks, per kernel
MAX_ABS_ERR = {name: 0 for name in REPORT_SHAPE}


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
    from repro_torch.launch.kernel_timing import PAIR_SHAPES, pair_inputs

    cases = []
    for p, w, q, nv in PAIR_SHAPES:
        cases.append((f"P={p} W={w} Q={q} n_valid={nv}", p, w, q, nv, None))
    cases += [
        ("Q=1", 5, 9, 1, 1, None),
        ("W=1", 40, 1, 300, 300, None),
        ("W=7 (not a multiple of 4)", 40, 7, 300, 250, None),
        ("W=3125 Q=0", 8, 3125, 0, 0, None),
        ("no survivors", 64, 50, 500, 500, 10**9),
        ("all survivors", 64, 50, 500, 500, 0),
        ("n_valid < Q", 64, 50, 500, 123, None),
        ("Q=12289 n_valid=8200 (scan tiles of 4096)", 100, 33, 12289, 8200, None),
    ]
    for label, p, w, q, nv, ms_override in cases:
        for mode in (0, 1, 2):
            bm, l, r, s, ms = pair_inputs(p, w, q, seed=p * 7 + w + q + mode)
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
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = fused_intersect_compact_ref(bm, l, r, s, ms, nv, mode=mode)
            torch.cuda.synchronize()
            for g, e, what in zip(got, want, ("compact", "sup", "mask", "n_surv")):
                compare("fused_intersect_compact", g, e,
                        f"fused_intersect_compact {label} mode {mode}: {what}")
            n_surv = int(got[3])
            print(f"check fused_intersect (with and without store) + "
                  f"fused_intersect_compact {label} mode {mode}: "
                  f"equal to ref (exact), survivors {n_surv}/{q}, "
                  f"compact call clean under set_sync_debug_mode('error')")


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

    data = {}
    launches = {name: 0 for name in kernels.launch_counts()}
    for name, min_sup, variant, diffsets, expect in E2E_RUNS:
        if name not in data:
            t0 = time.perf_counter()
            data[name] = generate(name, scale=1.0, seed=0)
            print(f"e2e generate {name} scale=1.0 seed=0: "
                  f"{len(data[name][0])} txns in {time.perf_counter() - t0:.2f}s (host)")
        txns, spec = data[name]
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
                for k, v in counts.items():
                    require(v > 0, f"{name} {variant}: kernel {k} was not launched")
                    launches[k] += v
            else:
                require(all(v == 0 for v in counts.values()),
                        "the ref backend launched a CUDA kernel")
        require(sums["fused"] == expect,
                f"{name} {variant}: fused checksum {sums['fused']} != reference {expect}")
        require(sums["ref"] == expect,
                f"{name} {variant}: ref checksum {sums['ref']} != reference {expect}")
        print(f"e2e {name} {variant}: fused == ref == reference checksum {expect}")
    return launches


def bound(nbytes, products):
    """Least time in ms for work that moves ``nbytes`` and holds ``products``
    one-bit multiply-adds, and which of the two bounds it.  The fastest
    route the card has for bit products is the dense int8 tensor-core
    product of the 0/1 indicator; the packed kernels use the popcount pipe,
    which is slower, so this bound is below what they can reach."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 2 * products / INT8_TENSOR_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_kernels(launches):
    import torch
    from repro_torch.kernels.fused_intersect import (
        fused_intersect, fused_intersect_compact, fused_intersect_compact_ref,
        fused_intersect_ref, fused_support_pairs)
    from repro_torch.kernels.trimatrix import cooccurrence, trimatrix_ref
    from repro_torch.launch.kernel_timing import (
        PAIR_SHAPES, TRI_TIMED_SHAPES, median_ms, pair_inputs, tri_inputs)

    print(f"timing peaks (H100 SXM data sheet, dense, 700 W): HBM "
          f"{HBM_BYTES_PER_S:.3e} B/s; int8 tensor cores "
          f"{INT8_TENSOR_OPS_PER_S:.3e} op/s, two per one-bit product")

    rows = []
    pair_src = "src/repro_torch/csrc/fused_intersect.cu"
    tpu_src = "src/repro/kernels/fused_intersect/fused_intersect.py"
    for p, w, q, nv in PAIR_SHAPES:
        bm, l, r, s, ms = pair_inputs(p, w, q, seed=11)
        # frontier rows the pairs touch, each read once, plus left/right/sup_left
        rows_read = int(torch.unique(torch.cat((l, r))).numel())
        in_bytes = rows_read * w * 4 + 3 * q * 4
        products = q * w * 32
        # (name, function, plain version, TPU call site, bytes written, in
        # the kernels line): K1 as the main path launches it (no (Q, W)
        # store), K1 with its store (the op the reference package exports;
        # not on the main path), K2
        for name, fn, ref, replaces, out_bytes, listed in (
                ("fused_intersect",
                 lambda: fused_support_pairs(bm, l, r, s, ms, mode=0),
                 lambda: fused_intersect_ref(bm, l, r, s, ms, mode=0)[1:],
                 f"{tpu_src}:244", 2 * q * 4, True),
                ("fused_intersect with (Q, W) store",
                 lambda: fused_intersect(bm, l, r, s, ms, mode=0),
                 lambda: fused_intersect_ref(bm, l, r, s, ms, mode=0),
                 f"{tpu_src}:244", q * w * 4 + 2 * q * 4, False),
                ("fused_intersect_compact",
                 lambda: fused_intersect_compact(bm, l, r, s, ms, nv, mode=0),
                 lambda: fused_intersect_compact_ref(bm, l, r, s, ms, nv, mode=0),
                 f"{tpu_src}:314", q * w * 4 + 2 * q * 4 + 4, True)):
            bms, by = bound(in_bytes + out_bytes, products)
            rows.append(dict(name=name, listed=listed, route="cuda",
                             source=pair_src, replaces=replaces,
                             shape=f"P={p} W={w} Q={q}",
                             ms=median_ms(fn), plain_ms=median_ms(ref),
                             bound_ms=bms, bound_by=by, library_ms=None))
    for n, w in TRI_TIMED_SHAPES:
        bm = tri_inputs(n, w, seed=5)
        npad = max(17, -(-n // 8) * 8)
        shifts = torch.arange(32, device="cuda", dtype=torch.int32)
        dense = ((bm[:, :, None] >> shifts) & 1).reshape(n, w * 32).to(torch.int8)
        dense = torch.nn.functional.pad(dense, (0, 0, 0, npad - n)).contiguous()
        lib = lambda: torch._int_mm(dense, dense.t())
        got = lib()[:n, :n]
        require(torch.equal(got, cooccurrence(bm)),
                f"torch._int_mm yardstick disagrees with trimatrix at ({n}, {w})")
        bms, by = bound(n * w * 4 + n * n * 4, n * (n + 1) // 2 * w * 32)
        rows.append(dict(name="trimatrix", listed=True, route="cuda",
                         source="src/repro_torch/csrc/trimatrix.cu",
                         replaces="src/repro/kernels/trimatrix/trimatrix.py:71",
                         shape=f"N={n} W={w}",
                         ms=median_ms(lambda: cooccurrence(bm)),
                         plain_ms=median_ms(lambda: trimatrix_ref(bm), reps=10),
                         bound_ms=bms, bound_by=by, library_ms=median_ms(lib)))
    for row in rows:
        row["launches"] = launches[row["name"]] if row["listed"] else 0
        print(f"timing {row['name']} {row['shape']}: ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}) library_ms={row['library_ms']} "
              f"launches_on_main_path={row['launches']}")
        # a bound is a floor: nothing that computes the function may beat it
        for key in ("ms", "plain_ms", "library_ms"):
            if row[key] is not None:
                require(row["bound_ms"] <= row[key],
                        f"{row['name']} {row['shape']}: bound_ms "
                        f"{row['bound_ms']:.5f} exceeds {key} {row[key]:.5f}")
    print("timing note: fused_intersect is timed as the main path launches it, "
          "without the (Q, W) store; trimatrix library_ms is torch._int_mm "
          "over the unpacked 0/1 int8 indicator, rows padded to a multiple "
          "of 8; the unpack is not timed")
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

    check_pair_kernels()
    check_trimatrix()
    launches = run_end_to_end()
    rows = time_kernels(launches)
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
