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

whisper-base, an encoder-decoder, takes its own traffic (8 clips of
1,500 frame embeddings, a 4-token start-of-transcript prompt, 224 greedy
tokens; :func:`transcribe`): its prefill window holds the encoder and the
cross K/V too (``encode`` -> ``cross_kv`` once, then ``prefill``), as the
reference's dry run lowers its serve step.

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
# hymba-1.5b and xlstm-1.3b whole (3.18 and 3.63 GB); phi-3-vision-4.2b
# and whisper-base whole (7.64 GB; whisper's 6 decoder layers, and its 6
# encoder layers with them, 0.14 GB); command-r-35b whole (60.6 GB)
SERVE_LAYERS = {"gemma3-4b": 34, "internlm2-20b": 48, "command-r-35b": 40,
                "grok-1-314b": 4, "llama4-maverick-400b-a17b": 2, "hymba-1.5b": 32,
                "xlstm-1.3b": 48, "phi-3-vision-4.2b": 32, "whisper-base": 6}
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
# whisper-base's serving traffic: CLIPS clips of 30 s audio, each its
# encoder_len = 1,500 frame embeddings (the stubbed audio front end's
# output, drawn from a torch.Generator seeded 0, times 0.05 as the
# reference's decode test draws them); the 4-token prompt of whisper's
# tokenizer, <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>;
# TRANSCRIBE_NEW greedy tokens (whisper's default sample_len, half its
# 448-token text context); a cache of the prompt and the new tokens
CLIPS = 8
TRANSCRIBE_PROMPT = (50258, 50259, 50359, 50363)
TRANSCRIBE_NEW = 224
TRANSCRIBE_S_MAX = len(TRANSCRIBE_PROMPT) + TRANSCRIBE_NEW


def served_config(arch: str):
    """The config of ``arch`` at full width, cut to its served depth."""
    from ..configs import get_config
    cfg = get_config(arch)
    if arch not in SERVE_LAYERS:
        raise ValueError(f"no served depth for {arch!r}; served: {sorted(SERVE_LAYERS)}")
    return dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])


def clip_embeds(cfg, n: int, device) -> torch.Tensor:
    """(n, encoder_len, d_model) frame embeddings in the config's dtype:
    normal draws of a ``torch.Generator`` seeded 0 on ``device``, times
    0.05."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.randn((n, cfg.encoder_len, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=device) * 0.05
    return x.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def encoder_kv(model, params, enc_embeds):
    """An encoder-decoder's (whisper's) cross K/V of ``enc_embeds``: its
    ``encode`` then its ``cross_kv``, made once for the whole decode."""
    return model.cross_kv(params, model.encode(params, enc_embeds))


def begin(model, params, prompt, s_max: int, enc=None) -> dict:
    """Prefill of the prompt (B, P) into a cache of ``s_max`` rows, over the
    cross K/V ``enc`` (:func:`encoder_kv`; None for a decoder-only model).
    Returns the decoding state: ``enc``, the cache, each sequence's greedy
    next token (on the card) and the position it goes to."""
    logits, cache = model.prefill(params, {"tokens": prompt}, s_max, enc_out=enc)
    return {"enc": enc, "cache": cache, "tok": logits[:, -1].argmax(-1),
            "pos": prompt.shape[1]}


def decode(model, params, state: dict, n: int) -> list:
    """``n`` greedy decode steps from ``state`` (:func:`begin`), which they
    advance, each step's tokens read to the host as the serving engine
    reads them.  Returns the ``n`` lists of tokens."""
    b, out = state["tok"].shape[0], []
    for _ in range(n):
        pos = torch.full((b,), state["pos"], dtype=torch.int32,
                         device=state["tok"].device)
        logits, state["cache"] = model.decode_step(
            params, state["tok"][:, None], state["cache"], pos, enc_out=state["enc"])
        state["tok"] = logits[:, -1].argmax(-1)
        state["pos"] += 1
        out.append(state["tok"].tolist())
    return out


def transcribe(model, params, enc_embeds, prompt, n_new: int, s_max: int):
    """Greedy decoding of an encoder-decoder (whisper), as the reference's
    dry run lowers its serve step: :func:`encoder_kv` once, then the
    prefill of the prompt (B, P) over those cross K/V (:func:`begin`), then
    ``n_new - 1`` decode steps (:func:`decode`).  Returns ``(tokens,
    stats)``: (B, n_new) int32 numpy, and the host seconds of the encoder
    (with the cross K/V), of the prefill and of the decode steps, and the
    steps taken."""
    with torch.inference_mode():
        t0 = time.perf_counter()
        enc = encoder_kv(model, params, enc_embeds)
        if prompt.is_cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = begin(model, params, prompt, s_max, enc)
        out = [state["tok"].tolist()]   # the host waits for the prefill here
        t2 = time.perf_counter()
        out += decode(model, params, state, n_new - 1)
        t3 = time.perf_counter()
    stats = {"decode_steps": n_new - 1, "encode_s": t1 - t0,
             "prefill_s": t2 - t1, "decode_s": t3 - t2}
    return np.asarray(out, dtype=np.int32).T, stats


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
    frames = None
    if cfg.n_encoder_layers:
        # whisper's traffic: the prefill window holds the encoder too
        b, s_max = CLIPS, TRANSCRIBE_S_MAX
        frames = clip_embeds(cfg, CLIPS, "cuda")
        toks = torch.tensor([TRANSCRIBE_PROMPT] * CLIPS, device="cuda")
    else:
        b, s_max = PROFILE_BATCH, SERVE_S_MAX
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (b, PROFILE_PROMPT))).cuda()
    state = {}

    def prefill():
        enc = None if frames is None else encoder_kv(model, params, frames)
        state.update(begin(model, params, toks, s_max, enc))

    def steps():
        decode(model, params, state, PROFILE_STEPS)

    with torch.inference_mode():
        prefill()
        steps()                         # warm-up: cuBLAS plans, allocator
        head = (f"{cfg.name} ({cfg.n_layers} layers) bf16 B={b} "
                f"prompt={toks.shape[1]}"
                + (f" frames={cfg.encoder_len}" if frames is not None else "")
                + f" decode_steps={PROFILE_STEPS}")
        res = {"config": head, "device": torch.cuda.get_device_name(0),
               "prefill": _window(f"prefill {head}", prefill),
               "decode": _window(f"decode {head}", steps)}
        for phase, fn in (("prefill", prefill), ("decode", steps)):
            res[phase]["stage_ms"] = stage_times(model, fn)
            print(f"{phase} by layer kind (host ms, a sync after each stage): "
                  + " ".join(f"{k}={v:.3f}" for k, v in res[phase]["stage_ms"].items()))
    res["decode"]["ms_per_step"] = res["decode"]["wall_ms"] / PROFILE_STEPS
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
