"""K6's bf16 backward under every split of a query group, on the card:

    PYTHONPATH=src python3 -m repro_torch.launch.bwd_splits [--reps 20]

The dK/dV kernel of ``csrc/flash_attention_bwd.cu`` sums ``heads_per_block``
query heads of a KV head's group inside a block and leaves the other
``G / heads_per_block`` splits to float32 partials that a reduction kernel
sums in split order; ``kernels.flash_attention.bwd_plan`` picks the split
from the shape alone.  For each shape below (gemma-2b's training layer,
gemma3-4b's local and global layers, and MQA at other batch sizes and
lengths) this times the backward with every divisor of G as
``heads_per_block`` (device ms per call, the least of three
``kernel_timing.device_ms`` readings) and names the rule's pick and the
fastest.  Then, at gemma-2b's layer under the rule, the device time of
each of its kernels from a ``torch.profiler`` trace of 10 calls.  Prints
the card's name and power limit first and one JSON object last.  Needs a
card; with none it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

import torch

# (B, H, Hkv, S, D, window): the shapes of the table in the rule's note
SHAPES = [(4, 8, 1, 1024, 256, 0), (2, 8, 4, 2048, 256, 1024),
          (2, 8, 4, 2048, 256, 0), (1, 8, 1, 1024, 256, 0),
          (8, 8, 1, 1024, 256, 0), (4, 8, 1, 2048, 256, 0)]


def _inputs(b, h, hkv, s, d, window):
    from ..kernels.flash_attention import flash_attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(s + b)

    def draw(n):   # (B, H, S, D) views of (B, S, H, D), as the model passes
        return torch.randn((b, s, n, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
    q, k, v, dout = draw(h), draw(hkv), draw(hkv), draw(h)
    out, lse = flash_attention(q, k, v, causal=True, window=window, return_lse=True)
    return q, k, v, out, dout, lse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_splits: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from ..kernels.flash_attention import bwd_plan
    from ..kernels.flash_attention.flash_attention import _bwd
    from .kernel_timing import device_ms, nvidia_smi
    from .serve_profile import kernel_times
    print(nvidia_smi("name,power.limit"))
    rows = []
    for b, h, hkv, s, d, window in SHAPES:
        q, k, v, out, dout, lse = _inputs(b, h, hkv, s, d, window)
        group = h // hkv
        times = {}
        for hpb in (x for x in range(1, group + 1) if group % x == 0):
            fn = lambda: _bwd(q, k, v, out, dout, lse, True, window, None, 0.0, hpb)
            times[hpb] = min(device_ms(fn, reps=args.reps) for _ in range(3))
        rule = bwd_plan(b, h, hkv, s, d, window).heads_per_block
        best = min(times, key=times.get)
        shape = f"B={b} H={h} Hkv={hkv} S={s} D={d} window={window}"
        print(f"splits {shape}: " + "; ".join(
            f"{hpb} head(s) per block ({bwd_plan(b, h, hkv, s, d, window, hpb).dkdv_blocks} "
            f"blocks) {ms:.5f} ms" for hpb, ms in times.items())
            + f"; the rule takes {rule}, the fastest is {best}")
        rows.append(dict(shape=shape, ms=times, rule=rule, fastest=best))
        del q, k, v, out, dout, lse
    q, k, v, out, dout, lse = _inputs(*SHAPES[0])
    fn = lambda: _bwd(q, k, v, out, dout, lse, True, 0, None, 0.0, 0)
    fn()
    torch.cuda.synchronize()
    # CPU and CUDA activities, as launch/train_profile.py traces: a trace of
    # the CUDA activity alone read these kernels 2-3.5x low on an H100
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for name, (ms, _) in kernel_times(prof).items():
        found = re.search(r"\w+_kernel(?:<[^>]*>)?", name)
        key = found.group(0) if found else name[:60]
        kernels[key] = kernels.get(key, 0.0) + ms / 10
    total = sum(kernels.values())
    print(f"kernels at gemma-2b's layer (device ms per call, torch.profiler, 10 "
          f"calls; {total:.5f} in all): " + ", ".join(
              f"{n} {ms:.5f} ({ms / total:.1%})" for n, ms in kernels.items()))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "splits": rows,
                      "kernels_ms": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
