"""Where the time of LM serving goes, on the card:

    PYTHONPATH=src python3 -m repro_torch.launch.serve_profile

Builds gemma3-4b at full width (bf16, random weights from a seeded
``torch.Generator``), warms up, then traces one prefill of the serving
traffic's largest sub-batch (2 prompts of 2,048 tokens) and 16 decode
steps with ``torch.profiler``, each phase in its own window, and prints for
each: the host wall time (ending in ``torch.cuda.synchronize()``), the
device busy time (the sum of kernel times; one stream, so kernels do not
overlap), the device's idle share, the attention kernels' share, and the
kernels that take the most device time.  The last line is one JSON object
with the same numbers.  Needs a card; with none it exits non-zero.

The serving traffic is defined here and ``chip_smoke.py`` serves it.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


# the serving traffic of gemma3-4b: 8 seeded requests, 4 of 2,048 and 4 of
# 1,536 prompt tokens (both past the 1,024 window of the local layers), 32
# new tokens each, greedy, packed into 2 batches, a 2,080-row cache
ARCH = "gemma3-4b"
SERVE_PROMPTS = (2048,) * 4 + (1536,) * 4
SERVE_MAX_NEW = 32
SERVE_BATCHES = 2
SERVE_S_MAX = 2080
# the profile's prefill: the engine splits each batch by prompt length, so
# the largest sub-batch is 2 prompts of 2,048; then this many decode steps
PROFILE_BATCH = SERVE_PROMPTS.count(max(SERVE_PROMPTS)) // SERVE_BATCHES
PROFILE_PROMPT = max(SERVE_PROMPTS)
PROFILE_STEPS = 16
TOP_KERNELS = 12
# the attention kernels' names in the trace: K6's bf16 variant (the served
# model's) and K7
ATTENTION_KERNELS = ("flash_attention_wgmma_kernel", "decode_attention_split_kernel")


def _kernel_times(prof) -> dict:
    """Device time in ms per kernel name (CUDA events of the trace)."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms = evt.self_device_time_total / 1e3
            if ms > 0:
                out[evt.key] = (out.get(evt.key, (0.0, 0))[0] + ms, evt.count)
    return out


def _window(label, fn):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    times = _kernel_times(prof)
    busy = sum(ms for ms, _ in times.values())
    attn = {name: sum(ms for k, (ms, _) in times.items() if name in k)
            for name in ATTENTION_KERNELS}
    print(f"{label}: wall_ms={wall_ms:.3f} (profiled) device_busy_ms={busy:.3f} "
          f"idle_share={1 - busy / wall_ms:.4f} "
          + " ".join(f"{k}_ms={v:.3f} ({v / busy:.1%} of busy)"
                     for k, v in attn.items()))
    ranked = sorted(times.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    for name, (ms, n) in ranked:
        print(f"  {ms:10.3f} ms  {n:6d} calls  {name[:110]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "attention_ms": attn,
            "top": [[name, ms, n] for name, (ms, n) in ranked]}


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from ..configs import get_config
    from ..models import Model, init_params

    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    model = Model(cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (PROFILE_BATCH, PROFILE_PROMPT))).cuda()
    state = {}

    def prefill():
        logits, state["cache"] = model.prefill(params, {"tokens": toks}, SERVE_S_MAX)
        state["tok"] = logits[:, -1].argmax(-1)

    def decode():
        for t in range(PROFILE_STEPS):
            pos = torch.full((PROFILE_BATCH,), PROFILE_PROMPT + t,
                             dtype=torch.int32, device="cuda")
            logits, state["cache"] = model.decode_step(
                params, state["tok"][:, None], state["cache"], pos)
            state["tok"] = logits[:, -1].argmax(-1)
            state["tok"].tolist()       # the engine reads every step's tokens

    with torch.inference_mode():
        prefill()
        decode()                        # warm-up: cuBLAS plans, allocator
        head = (f"{cfg.name} bf16 B={PROFILE_BATCH} prompt={PROFILE_PROMPT} "
                f"decode_steps={PROFILE_STEPS}")
        res = {"config": head, "device": torch.cuda.get_device_name(0),
               "prefill": _window(f"prefill {head}", prefill),
               "decode": _window(f"decode {head}", decode)}
    res["decode"]["ms_per_step"] = res["decode"]["wall_ms"] / PROFILE_STEPS
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
