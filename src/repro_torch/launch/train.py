"""Training driver: model, train step and the fault-tolerant runner on one
device (the port of the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --steps 50 --ckpt-dir DIR [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 6 --batch 4 --seq 1024          # full width, on the card

Random weights from a ``torch.Generator`` seeded 0, batches from
``data.TokenPipeline`` (batch ``i`` a pure function of the seed and ``i``),
checkpoints every ``--ckpt-every`` steps; a run in a directory that holds a
checkpoint resumes from it.  The default device is CUDA, and with no card it
raises rather than fall back.  It prints the reference's ``[train]`` line
and, on the card, a second one with the median step time (steps after the
first), tokens/s and peak memory.  ``--mesh`` (mesh training) waits for
ROADMAP item 12.
"""
from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time

import torch

from ..configs import TrainConfig, get_config
from ..configs.reduced import reduced_config
from ..data import TokenPipeline
from ..device import resolve_device
from ..models import Model, init_params
from ..models.transformer import REMAT_MODES
from ..training import (RunnerConfig, TrainingRunner, adamw_init, latest_step,
                        make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--mesh", default=None,
                    help="single|multi|tiny: mesh training is not ported yet")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced-width config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=list(REMAT_MODES))
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: cuda)")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        raise NotImplementedError(
            "--mesh: mesh training (sharded params, ZeRO-1, compressed "
            "all-reduce in the step) is not ported yet (ROADMAP item 12)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    tcfg = TrainConfig(total_steps=args.steps, microbatches=args.microbatches,
                       remat=args.remat)
    step = make_train_step(model, tcfg)
    step_s = []

    def timed_step(p, s, b):
        t0 = time.perf_counter()
        out = step(p, s, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        return out

    pipe = TokenPipeline(cfg.vocab_size, batch=args.batch, seq_len=args.seq,
                         seed=tcfg.seed)
    runner = TrainingRunner(
        RunnerConfig(args.ckpt_dir, checkpoint_every=args.ckpt_every),
        timed_step, params, adamw_init(params), pipe.batch_at)
    del params   # the runner holds the params; the first step replaces them
    resumed = latest_step(args.ckpt_dir) or 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    final = runner.run(args.steps)
    dt = time.perf_counter() - t0
    losses = [m["loss"] for m in runner.metrics_log]
    print(f"[train] {cfg.name} steps {resumed}->{final} in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}" if losses else "no steps")
    if device.type == "cuda" and step_s:
        ms = statistics.median(step_s[1:] or step_s) * 1e3
        print(f"[train] {torch.cuda.get_device_name(device)}: step_ms "
              f"{ms:.1f} (median of steps 2-{len(step_s)}), tokens_per_s "
              f"{args.batch * args.seq / ms * 1e3:.0f}, peak_mem_GB "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f}")


if __name__ == "__main__":
    main()
