#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card:

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into the git-ignored
``build/``) and holds every kernel against its plain torch version on the
card at the shapes the main paths give it.  Then it drives both ported
paths end to end:

* the batch miner ``mine()`` on the paper's T10I4D100K and chess datasets
  at full scale, against the reference package's checksums;
* LM serving of gemma3-4b at full width and depth (bf16, random weights
  from a seeded generator): ``ServingEngine.serve`` of 8 requests, twice,
  with the flash- and decode-attention kernels' launch counts and
  identical greedy outputs required, decode-matches-prefill over all 34
  layers, and the model through the kernels against the same model with
  their plain versions in their place, in float32 and in bf16;

and times each kernel beside its bound, its plain version and, where one
exists, a PyTorch call that computes the same function.

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
BF16_TENSOR_FLOPS = 9.89e14       # dense bf16, two per multiply-add


# the shape of each kernel's row in the "kernels" line: the largest call
# the main path makes (chess level 5; T10I4D100K Phase 2; a gemma3-4b
# global layer's prefill and its last decode step)
REPORT_SHAPE = {"fused_intersect": "P=60038 W=100 Q=393216",
                "fused_intersect_compact": "P=60038 W=100 Q=393216",
                "trimatrix": "N=187 W=3125",
                "flash_attention": "B=2 H=8 Hkv=4 S=2048 D=256 bf16 causal window=0",
                "decode_attention": "B=2 KV=4 G=2 D=256 S=2080 len=2079 bf16 window=0"}
MINING_KERNELS = ("fused_intersect", "fused_intersect_compact", "trimatrix")

# largest |kernel - plain| seen by the checks, per kernel
MAX_ABS_ERR = {name: 0 for name in REPORT_SHAPE}

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
    launches = {name: 0 for name in MINING_KERNELS}
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
                for k in MINING_KERNELS:
                    require(counts[k] > 0, f"{name} {variant}: kernel {k} was not launched")
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
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
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
        for label, b, h, hkv, s, d, causal, window, layout in cases:
            q, k, v = attn_inputs(b, h, hkv, s, d, dtype, seed=s + h + d, model_layout=layout)
            got = multi_head_attention(q, k, v, causal=causal, window=window)
            want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                 window=window or None)
            torch.cuda.synchronize()
            err, ratio = compare_attention("flash_attention", got, want,
                                           f"flash_attention {label} {dtype}")
            print(f"check flash_attention {label} B={b} H={h} Hkv={hkv} S={s} "
                  f"D={d} causal={causal} window={window} {dtype}: max abs err "
                  f"{err:.3e} from the plain output; error vs float32 at "
                  f"{ratio:.3f} x its limit ({limit})")
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
    cases = [(2, 4, 2, 256, [1, 2080]), (2, 4, 2, 256, [2079, 1537]),
             (4, 1, 8, 256, [1, 777, 2079, 2080]), (3, 2, 4, 16, [5, 64, 65]),
             (2, 4, 1, 128, [1000, 3])]
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
                want = decode_attention_ref(q.float(), k.float(), v.float(),
                                            length, window=window)
                torch.cuda.synchronize()
                err, ratio = compare_attention(
                    "decode_attention", got, want,
                    f"decode_attention B={b} KV={kv} G={g} D={d} "
                    f"len={lens} window={window} {dtype}")
                print(f"check decode_attention B={b} KV={kv} G={g} D={d} S={s} "
                      f"lengths={lens} window={window} {dtype}: max abs err "
                      f"{err:.3e} from the plain output; error vs float32 at "
                      f"{ratio:.3f} x its limit ({limit})")


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

    p32 = _cast(params, torch.float32)
    full32, dec32 = both_paths(p32, "float32")
    with plain_attention():
        plain_full32, plain_dec32 = both_paths(p32, "float32")
    del p32
    torch.cuda.empty_cache()
    full16, dec16 = both_paths(params, "bfloat16")
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


def bound_attn(nbytes, flops):
    """Least time in ms for work that moves ``nbytes`` and does ``flops``
    bf16 operations (two per multiply-add) at the dense tensor-core rate."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / BF16_TENSOR_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_attention(counts):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      grouped_decode_attention)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     multi_head_attention)
    from repro_torch.launch.kernel_timing import median_ms

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
                         ms=median_ms(fn), plain_ms=median_ms(ref, reps=5),
                         bound_ms=bms, bound_by=by, library_ms=median_ms(lib)))
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
                         ms=median_ms(fn, reps=50), plain_ms=median_ms(ref),
                         bound_ms=bms, bound_by=by, library_ms=median_ms(lib, reps=50)))
    for row in rows:
        row["listed"] = True
        row["launches"] = counts[row["name"]]
        print(f"timing {row['name']} {row['shape']}: ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}) library_ms={row['library_ms']:.5f} "
              f"launches_on_main_path={row['launches']}")
        for key in ("ms", "plain_ms", "library_ms"):
            require(row["bound_ms"] <= row[key],
                    f"{row['name']} {row['shape']}: bound_ms "
                    f"{row['bound_ms']:.5f} exceeds {key} {row[key]:.5f}")
    print("timing note: attention bounds count the (row, column) pairs the "
          "masks keep, 4 D operations each, at the dense bf16 tensor-core "
          "rate, and q, k, v, out (decode: the valid cache rows) read or "
          "written once; library_ms is torch scaled_dot_product_attention "
          "(enable_gqa; the windowed layer with a boolean mask), which the "
          "port never calls")
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
    check_flash_attention()
    check_decode_attention()
    params, cfg, serve_counts = run_serving()
    check_decode_matches_prefill(params, cfg)
    del params
    torch.cuda.empty_cache()
    rows = time_kernels(launches) + time_attention(serve_counts)
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
