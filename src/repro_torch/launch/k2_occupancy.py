"""K2's 16-lane tile under other register caps, on the card.

    PYTHONPATH=src python3 -m repro_torch.launch.k2_occupancy \
        [--caps 2,2 3,4 4,4] [--reps 20] [--out FILE]

``compact_pairs_kernel``'s occupancy is a compile-time ``__launch_bounds__``
value per front end; for 16 lanes a pair it is ``K2_G16_MIN_BLOCKS_FUSED``
and ``K2_G16_MIN_BLOCKS_GIVEN`` in ``csrc/fused_intersect.cu``.  For each
``fused,given`` pair of ``--caps`` this builds the kernel library with those
values (``-D`` flags; the library's file is named by a hash of its flags, so
each variant is a build of its own, all started together), then, one
variant at a time in a process of its own, times K2 at every lanes count
at ``launch.kerneltune.K2_SHAPES`` (chess level 5 on class-ordered pairs,
the others on random pairs, a 10% pad tail), both front ends, mode 0,
device ms (``kernel_timing.device_ms``).  The 8- and 32-lane tiles do not
depend on the caps: their times in every variant show the spread between
processes.  Each variant also reports the registers ``ptxas`` gave the
16-lane kernels.  Prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import List

__all__ = ["DEFAULT_CAPS", "main"]

DEFAULT_CAPS = ["2,2", "3,4", "4,4"]   # (4, 4) is the source's
_MODULE = "repro_torch.launch.k2_occupancy"
_TAG = "K2OCC "


def _flags(caps: str) -> List[str]:
    fused, given = (int(x) for x in caps.split(","))
    return [f"-DK2_G16_MIN_BLOCKS_FUSED={fused}",
            f"-DK2_G16_MIN_BLOCKS_GIVEN={given}"]


def _registers(ptxas_log: str) -> dict:
    """Registers of the mode-0, 16-byte-element kernels, by lanes and front
    end, from a ``ptxas -v`` log."""
    out = {}
    entry = None
    for line in ptxas_log.splitlines():
        m = re.search(r"compact_pairs_kernelILi0ELi4ELi(\d+)ELb([01])E", line)
        if "Compiling entry function" in line:
            entry = m
            continue
        r = re.search(r"Used (\d+) registers", line)
        if r and entry is not None:
            front = "fused" if entry.group(2) == "1" else "given"
            out[f"{entry.group(1)} lanes {front}"] = int(r.group(1))
            entry = None
    return out


def _child(caps: str, build_only: bool, reps: int) -> dict:
    from ..kernels import _build
    _build.NVCC_FLAGS.extend(_flags(caps))
    _build.library()
    info = _build.build_info()
    if build_only:
        return {"caps": caps, "built": info["built"], "seconds": info["seconds"]}
    import torch
    from ..kernels.fused_intersect import (COMPACT_LANES, compact_survivors_pairs,
                                           fused_intersect_compact_ref)
    from ..kernels.fused_intersect.fused_intersect import (cuda_compact_shape,
                                                           launch_compact)
    from .kernel_timing import class_pair_inputs, device_ms, pair_inputs
    from .kerneltune import K2_SHAPES
    rows = []
    for label, p, w, q in K2_SHAPES:
        nv = q - q // 10
        if "level 5" in label:
            bm, l, r, s, ms = class_pair_inputs(p, w, q, nv, seed=p + w + q)
        else:
            bm, l, r, s, ms = pair_inputs(p, w, q, seed=p + w + q)
        mask = fused_intersect_compact_ref(bm, l, r, s, ms, nv, mode=0)[2].clone()
        for g in COMPACT_LANES:
            fused = device_ms(lambda: launch_compact(bm, l, r, s, ms, nv, mode=0,
                                                     lanes=g), reps=reps)
            given = device_ms(lambda: compact_survivors_pairs(bm, l, r, mask, nv,
                                                              mode=0, lanes=g),
                              reps=reps)
            rows.append({"shape": label, "p": p, "w": w, "q": q, "lanes": g,
                         "fused_ms": fused, "given_ms": given})
        torch.cuda.synchronize()
    return {"caps": caps, "shape_of_16": list(cuda_compact_shape(16, 100)),
            "registers": _registers(info.get("ptxas_log", "")), "rows": rows}


def _run(args: List[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", _MODULE, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _result(proc: subprocess.Popen, what: str) -> dict:
    out, _ = proc.communicate()
    for line in out.splitlines():
        if line.startswith(_TAG):
            return json.loads(line[len(_TAG):])
    raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n{out[-4000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--caps", nargs="+", default=DEFAULT_CAPS,
                    help="fused,given blocks per SM of the 16-lane tile")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(_TAG + json.dumps(_child(args.child, args.build_only, args.reps)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2_occupancy: no CUDA device is available")
    from .kernel_timing import nvidia_smi
    builds = [(c, _run(["--child", c, "--build-only"])) for c in args.caps]
    built = [_result(p, f"build {c}") for c, p in builds]
    variants = [_result(_run(["--child", c, "--reps", str(args.reps)]), f"variant {c}")
                for c in args.caps]
    report = {"nvidia_smi": nvidia_smi("name,power.limit"), "builds": built,
              "variants": variants}
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
