"""Where the time of LM serving goes, on the card:

    PYTHONPATH=src python3 -m repro_torch.launch.serve_profile [--arch ARCH]

Builds the served model of ``--arch`` at full width (default gemma3-4b;
bf16, random weights from a seeded ``torch.Generator``; depth as
:data:`SERVE_LAYERS` cuts it to fit one card), warms up, then traces one
prefill of the serving
traffic's largest sub-batch (2 prompts of 2,048 tokens) and 16 decode
steps with ``torch.profiler``, each phase in its own window, and prints for
each: the host wall time (ending in ``torch.cuda.synchronize()``), the
device busy time (the sum of kernel times; one stream, so kernels do not
overlap), the device's idle share, the attention kernels' share (a model
with no attention layer, xlstm, says so), and the kernels that take the
most device time.  Then, untraced, each phase once more with the host
waiting for the card after every stage of layers (``Model.on_stage``):
the wall time of each
layer kind (``stage_ms``; xlstm's sLSTM loop, hymba's hybrid layers),
which the traced windows do not split.  The last line is one JSON object
with the same numbers.  Needs a card; with none it exits non-zero.

The serving traffic and the served depths are defined here and
``chip_smoke.py`` serves them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch


# the serving traffic of gemma3-4b: 8 seeded requests, 4 of 2,048 and 4 of
# 1,536 prompt tokens (both past the 1,024 window of the local layers), 32
# new tokens each, greedy, packed into 2 batches, a 2,080-row cache; the
# other served models take the same traffic
ARCH = "gemma3-4b"
# the layers each served model runs on one 80 GB card, at full width, bf16:
# gemma3-4b and internlm2-20b whole (7.8 and 39.7 GB of weights); grok-1
# cut to 4 of its 64 layers (41.0 GB: all 314 G parameters take 628 GB)
# and llama4-maverick to 2 of its 48, one dense and one MoE (36.9 GB);
# hymba-1.5b and xlstm-1.3b whole (3.18 and 3.63 GB)
SERVE_LAYERS = {"gemma3-4b": 34, "internlm2-20b": 48, "grok-1-314b": 4,
                "llama4-maverick-400b-a17b": 2, "hymba-1.5b": 32,
                "xlstm-1.3b": 48}
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


def served_config(arch: str):
    """The config of ``arch`` at full width, cut to its served depth."""
    from ..configs import get_config
    cfg = get_config(arch)
    if arch not in SERVE_LAYERS:
        raise ValueError(f"no served depth for {arch!r}; served: {sorted(SERVE_LAYERS)}")
    return dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])


def kernel_times(prof) -> dict:
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
    times = kernel_times(prof)
    busy = sum(ms for ms, _ in times.values())
    attn = {name: sum(ms for k, (ms, _) in times.items() if name in k)
            for name in ATTENTION_KERNELS}
    share = (" ".join(f"{k}_ms={v:.3f} ({v / busy:.1%} of busy)"
                      for k, v in attn.items()) if any(attn.values())
             else "no attention kernel launched; its top kernels:")
    print(f"{label}: wall_ms={wall_ms:.3f} (profiled) device_busy_ms={busy:.3f} "
          f"idle_share={1 - busy / wall_ms:.4f} " + share)
    ranked = sorted(times.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    for name, (ms, n) in ranked:
        print(f"  {ms:10.3f} ms  {n:6d} calls  {name[:110]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "attention_ms": attn,
            "top": [[name, ms, n] for name, (ms, n) in ranked]}


def stage_times(model, fn) -> dict:
    """Host ms of each layer kind of ``model`` in one call of ``fn``,
    untraced: the host waits for the card after every stage (the model's
    ``on_stage`` hook, set for this call only), so a kind's time holds its
    kernels and the host's launch work between them.  Raises if a kind of
    the model ran no stage."""
    from ..models import stages_meta
    out = {}

    @contextlib.contextmanager
    def timed(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        out[kind] = out.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3

    model.on_stage = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        model.on_stage = None
    missing = {k for k, _ in stages_meta(model.cfg)} - set(out)
    if missing:
        raise RuntimeError(f"stage_times: no stage of the kinds {sorted(missing)} ran")
    return {**out, "total": total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH, choices=sorted(SERVE_LAYERS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from ..models import Model, init_params

    cfg = served_config(args.arch)
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
        head = (f"{cfg.name} ({cfg.n_layers} layers) bf16 B={PROFILE_BATCH} "
                f"prompt={PROFILE_PROMPT} decode_steps={PROFILE_STEPS}")
        res = {"config": head, "device": torch.cuda.get_device_name(0),
               "prefill": _window(f"prefill {head}", prefill),
               "decode": _window(f"decode {head}", decode)}
        for phase, fn in (("prefill", prefill), ("decode", decode)):
            res[phase]["stage_ms"] = stage_times(model, fn)
            print(f"{phase} by layer kind (host ms, a sync after each stage): "
                  + " ".join(f"{k}={v:.3f}" for k, v in res[phase]["stage_ms"].items()))
    res["decode"]["ms_per_step"] = res["decode"]["wall_ms"] / PROFILE_STEPS
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
