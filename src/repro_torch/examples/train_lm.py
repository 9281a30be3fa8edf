"""End-to-end training example: train a reduced-config LM with
checkpoint/restart, the whole training path (data pipeline -> train step ->
async checkpoints -> resume).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch gemma-2b \
        --steps 60 [--device cpu]
    # ~100M-param config (slower):
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch gemma-2b \
        --preset 100m --steps 200

The reference's ``examples/train_lm.py`` on the port, with its ``tiny`` and
``100m`` presets.  The weights are random from a ``torch.Generator``
seeded 0, so the losses are not the reference's; the lines are.  Runs on
the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import TrainConfig, get_config
from ..configs.reduced import reduced_config
from ..data import TokenPipeline
from ..device import resolve_device
from ..models import Model, init_params
from ..training import (RunnerConfig, TrainingRunner, adamw_init, latest_step,
                        make_train_step)
from ..training.optimizer import tree_leaves


def preset_cfg(arch: str, preset: str):
    base = get_config(arch)
    if preset == "tiny":
        return reduced_config(base, d_model=128, vocab=2048)
    if preset == "100m":   # ~100M params
        return dataclasses.replace(
            reduced_config(base, d_model=768, vocab=32768),
            n_layers=12, n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048)
    raise ValueError(preset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "torch paths on the host)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = preset_cfg(args.arch, args.preset)
    model = Model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name} [{args.preset}]: {n_params/1e6:.1f}M params")

    pipe = TokenPipeline(cfg.vocab_size, batch=args.batch, seq_len=args.seq, seed=0)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=20,
                       total_steps=args.steps, remat="none")
    runner = TrainingRunner(
        RunnerConfig(args.ckpt_dir, checkpoint_every=25),
        make_train_step(model, tcfg), params, adamw_init(params), pipe.batch_at)
    resumed = latest_step(args.ckpt_dir)
    if resumed:
        print(f"resumed from checkpoint at step {resumed}")

    t0 = time.perf_counter()
    runner.run(args.steps)
    dt = time.perf_counter() - t0
    losses = [m["loss"] for m in runner.metrics_log]
    if losses:
        k = max(1, len(losses) // 10)
        print(f"{len(losses)} steps in {dt:.1f}s "
              f"({dt/len(losses):.2f}s/step): "
              f"loss {sum(losses[:k])/k:.3f} -> {sum(losses[-k:])/k:.3f}")
        if sum(losses[-k:]) / k >= sum(losses[:k]) / k:
            raise RuntimeError(f"loss did not drop: {sum(losses[:k]) / k:.3f} -> "
                               f"{sum(losses[-k:]) / k:.3f}")
    print("training example OK (checkpoints in", args.ckpt_dir + ")")


if __name__ == "__main__":
    main()
