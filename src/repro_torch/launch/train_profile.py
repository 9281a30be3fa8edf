"""Where the time of an LM training step goes, on the card:

    PYTHONPATH=src python3 -m repro_torch.launch.train_profile [--remat none]

Builds gemma-2b at full width and depth (bf16, random weights from a
``torch.Generator`` seeded 0; AdamW with float32 moments), takes one batch
of 4 x 1,024 tokens from ``data.TokenPipeline`` (seed 0), warms up with one
whole train step, then traces the parts of a step with ``torch.profiler``,
each in its own window: the forward pass with the loss, the backward pass,
the clipping and AdamW update, and the chunked float32 loss alone (forward
and backward on the final hidden states).  For each it prints the host wall
time (ending in ``torch.cuda.synchronize()``), the device busy time (the sum
of kernel times; one stream, so kernels do not overlap), the idle share and
the device time by kind of kernel: K6's forward
(``flash_attention_wgmma_kernel``), K6's backward (the
``flash_attention_bwd_*`` kernels), matrix products (cuBLAS and CUTLASS
kernels) and the rest (elementwise, reductions, copies).  The last line is
one JSON object with the same numbers.  Needs a card; with none it exits
non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .serve_profile import kernel_times

ARCH = "gemma-2b"
BATCH, SEQ = 4, 1024
TOP_KERNELS = 10
# kinds of kernel by name; the first that matches a name takes it
KINDS = (("k6_forward", ("flash_attention_wgmma_kernel", "flash_attention_f32_kernel")),
         ("k6_backward", ("flash_attention_bwd",)),
         ("matmul", ("gemm", "cutlass", "nvjet", "sm90_xmma", "Kernel2")))


def _kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


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
    kinds = {kind: 0.0 for kind, _ in KINDS}
    kinds["other"] = 0.0
    for name, (ms, _) in times.items():
        kinds[_kind(name)] += ms
    print(f"{label}: wall_ms={wall_ms:.3f} (profiled) device_busy_ms={busy:.3f} "
          f"idle_share={1 - busy / wall_ms:.4f} "
          + " ".join(f"{k}_ms={v:.3f}" for k, v in kinds.items()))
    ranked = sorted(times.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    for name, (ms, n) in ranked:
        print(f"  {ms:10.3f} ms  {n:6d} calls  {name[:110]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "by_kind_ms": kinds,
            "top": [[name, ms, n] for name, (ms, n) in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from ..configs import TrainConfig, get_config
    from ..data import TokenPipeline
    from ..models import Model, init_params
    from ..training import (adamw_init, adamw_update, clip_by_global_norm_,
                            lr_schedule, make_train_step)
    from ..training.optimizer import tree_leaves, tree_unflatten

    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    opt = adamw_init(params)
    model = Model(cfg)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                       remat=args.remat)
    tokens = torch.from_numpy(TokenPipeline(cfg.vocab_size, batch=BATCH,
                                            seq_len=SEQ, seed=0).batch_at(0)["tokens"])
    batch = {"tokens": tokens.cuda()}
    params, opt, _ = make_train_step(model, tcfg)(params, opt, batch)   # warm-up
    torch.cuda.synchronize()
    st = {}

    def forward():
        st["leaves"] = [p.detach().requires_grad_() for p in tree_leaves(params)]
        st["loss"] = model.loss(tree_unflatten(params, st["leaves"]), batch,
                                remat=args.remat)

    def backward():
        st["grads"] = tree_unflatten(params, torch.autograd.grad(st["loss"], st["leaves"]))

    def update():
        grads, _ = clip_by_global_norm_(st.pop("grads"), tcfg.grad_clip)
        lr = lr_schedule(opt["step"], tcfg.learning_rate, tcfg.warmup_steps,
                         tcfg.total_steps)
        st["new"] = adamw_update(params, grads, opt, lr=lr, b1=tcfg.b1,
                                 b2=tcfg.b2, weight_decay=tcfg.weight_decay)

    def loss_alone():
        h = torch.randn((BATCH, SEQ, cfg.d_model), device="cuda",
                        dtype=torch.bfloat16, requires_grad=True)
        targets = torch.cat([batch["tokens"][:, 1:], batch["tokens"][:, -1:]], 1)
        mask = torch.ones(targets.shape, device="cuda")
        w = params["embed"].detach().requires_grad_()
        total, _ = model.unembed_chunked({**params, "embed": w}, h, targets, mask)
        torch.autograd.grad(total, (h, w))

    head = f"{cfg.name} bf16 B={BATCH} S={SEQ} remat={args.remat}"
    res = {"config": head, "device": torch.cuda.get_device_name(0),
           "forward": _window(f"forward+loss {head}", forward),
           "backward": _window(f"backward {head}", backward),
           "update": _window(f"clip+adamw {head}", update),
           "loss_alone": _window(f"chunked loss fwd+bwd {head}", loss_alone),
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
