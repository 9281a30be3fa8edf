"""Training driver: model, train step and the fault-tolerant runner, on one
device or on a mesh of ranks (the port of the reference's
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --steps 50 --ckpt-dir DIR [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 6 --batch 4 --seq 1024          # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --mesh tiny --dist-backend gloo [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --mesh tiny --dist-backend gloo --seq-parallel --mlp-dp

Random weights from a ``torch.Generator`` seeded 0, batches from
``data.TokenPipeline`` (batch ``i`` a pure function of the seed and ``i``;
a vision config's image embeddings and an encoder-decoder's frame
embeddings beside the tokens, :func:`step_embeds`), checkpoints every ``--ckpt-every`` steps; a run in a directory that holds a
checkpoint resumes from it.  The default device is CUDA, and with no card it
raises rather than fall back.  It prints the reference's ``[train]`` line
and, on the card, a second one with the median step time (steps after the
first), tokens/s and peak memory.

``--mesh NAME`` (``tiny``: (2, 2) over ``("data", "model")``; ``single``,
``multi``, ``pipeline`` as in the reference) starts as many ranks as the
mesh has (``launch.mesh.run_ranks``, process-group backend
``--dist-backend``: ``nccl`` for ranks on distinct cards, ``gloo`` for
ranks on the host or sharing one card, which NCCL refuses).  Every rank
makes the same weights from the seed and the same global batch, and keeps
its block of both, so the mesh trains the model a single device trains;
the lead rank prints the lines.  A mixture of experts trains on a mesh too
(its routing groups per data shard and the expert all-to-all,
``models.moe``), and so do the recurrent and hybrid kinds (xlstm's mLSTM
and sLSTM, hymba's SSM beside attention: each block tensor-parallel over
``model``, ``models.xlstm``, ``models.ssm``), whisper-base's encoder and
cross-attention, and phi-3-vision-4.2b's image prefix.  What the model
axis does not divide the ranks run whole, as the reference replicates it:
hymba-1.5b's 25 heads and vocabulary of 32,001 and whisper's 51,865 on
``tiny``, and a d_ff, projection or block the axis does not split.
``--seq-parallel`` and ``--mlp-dp`` set the config's ``seq_parallel``
(the residual's sequence split over ``model``) and ``mlp_dp`` (the dense
FFN replicated, run on the rank's rows); without a mesh they change
nothing.  xlstm-1.3b and hymba-1.5b train on one card at full width under
``--remat full``, as ``chip_smoke.py`` runs them.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import statistics
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from .. import kernels
from ..configs import TrainConfig, get_config
from ..configs.reduced import reduced_config
from ..data import TokenPipeline
from ..device import resolve_device
from ..dist import collectives as coll
from ..dist.sharding import gather_tree, is_lead_rank, shard_tree
from ..models import Model, init_params, params_from_numpy
from ..models.transformer import REMAT_MODES, check_mesh
from ..training import (RunnerConfig, TrainingRunner, adamw_init, latest_step,
                        make_eval_step, make_train_step)
from ..training.fault_tolerance import batch_block

__all__ = ["train_run", "train_line", "moe_calls", "step_embeds", "main"]


def _config(job: dict):
    cfg = get_config(job["arch"])
    if job.get("reduced"):
        cfg = reduced_config(cfg)
    if job.get("cfg"):
        import dataclasses
        cfg = dataclasses.replace(cfg, **job["cfg"])
    return cfg


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@contextlib.contextmanager
def moe_calls():
    """Yields a list that gets each MoE layer call's ``(dropped_frac,
    expert_load)`` tensors (detached; global on a mesh) while the block
    runs, in call order: the model's ``moe`` is wrapped in this process
    meanwhile."""
    from ..models import transformer
    seen, real = [], transformer.moe

    def recorded(*args, **kwargs):
        out, aux = real(*args, **kwargs)
        seen.append((aux["dropped_frac"].detach(), aux["expert_load"].detach()))
        return out, aux
    transformer.moe = recorded
    try:
        yield seen
    finally:
        transformer.moe = real


def step_embeds(cfg, step: int, batch: int, device) -> dict:
    """Step ``step``'s stubbed front-end outputs for a global batch of
    ``batch`` rows, made on ``device`` from a ``torch.Generator`` seeded with
    the step, in the model's dtype: a vision config's ``img_embeds`` (B,
    ``frontend_len``, D), normal draws; an encoder-decoder's ``enc_embeds``
    (B, ``encoder_len``, D), normal draws x 0.05 (the scale of the serve's
    frames).  ``{}`` for a tokens-only config."""
    images = cfg.frontend_len if cfg.frontend == "vision" else 0
    frames = cfg.encoder_len if cfg.n_encoder_layers else 0
    if not (images or frames):
        return {}
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(step)
    if images:
        return {"img_embeds": torch.randn((batch, images, cfg.d_model), generator=gen,
                                          device=device).to(dtype)}
    return {"enc_embeds": (torch.randn((batch, frames, cfg.d_model), generator=gen,
                                       device=device) * 0.05).to(dtype)}


def train_run(job: dict, device: torch.device, mesh=None) -> dict:
    """One training run on ``device`` (this rank's, on a mesh).  ``job``:

    ``arch``, ``reduced``, ``cfg`` (config fields to replace, e.g. a cut
    ``n_layers``), ``steps``, ``batch``, ``seq``, ``microbatches``,
    ``remat``, ``tcfg`` (``TrainConfig`` fields, over those); ``ckpt_dir``
    and ``ckpt_every``: a ``TrainingRunner`` checkpointing there (with no
    ``ckpt_dir`` the steps run alone and write nothing); the weights from
    ``seed`` (default 0) or ``params`` (the reference's tree as numpy);
    ``then``: steps run on afterwards, in memory; ``gather``: return the
    final params whole (as float32 numpy, on the lead rank); ``embeds``:
    each step's image or frame embeddings (a list of dicts of numpy arrays
    of the global batch; default :func:`step_embeds`); ``eval``:
    return ``eval_loss``, the eval step's loss of the starting weights on
    the first batch; ``fail = (rank, step)``: the runner's step ``step``
    fails on that rank alone (``RunnerConfig.fail_injector``);
    ``moe_stats``: record each step's MoE calls (:func:`moe_calls`) as
    ``moe`` in its record.

    Returns the ``[train]`` line's numbers (``name``, ``resumed``,
    ``final``, ``dt``, ``losses``), ``grad_norms``, and per step its
    seconds, kernel launches (``kernels.launch_counts``, ``variant_counts``
    and ``shape_counts``), collectives and the host seconds inside them by
    axis (``collective_s``); on the card the peak memory."""
    cfg = _config(job)
    model = Model(cfg, mesh=mesh)
    tcfg = TrainConfig(**{"total_steps": job["steps"],
                          "microbatches": job.get("microbatches", 1),
                          "remat": job.get("remat", "none"),
                          **job.get("tcfg", {})})
    if job.get("params") is not None:
        params = params_from_numpy(job["params"], cfg, device, mesh)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(job.get("seed", 0))
        params = init_params(cfg, gen, device)
        if mesh is not None:
            params = shard_tree(params, mesh, model.specs)
    opt = adamw_init(params)
    step = make_train_step(model, tcfg)
    records = []

    def timed_step(p, s, b):
        kernels.reset_launch_counts()
        before, coll_s = coll.collective_counts(), coll.collective_seconds()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with (moe_calls() if job.get("moe_stats") else contextlib.nullcontext()) as calls:
            out = step(p, s, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        counts = kernels.launch_counts()
        counts.update(kernels.variant_counts())
        counts.update(kernels.shape_counts())
        after = coll.collective_seconds()
        records.append({"s": time.perf_counter() - t0, "launches": counts,
                        "collectives": coll.counts_since(before),
                        "collective_s": {a: sum(sec - coll_s.get(a, {}).get(op, 0.0)
                                                for op, sec in ops.items())
                                         for a, ops in after.items()}})
        if calls is not None:
            records[-1]["moe"] = [(float(d), load.tolist()) for d, load in calls]
        return out

    pipe = TokenPipeline(cfg.vocab_size, batch=job["batch"], seq_len=job["seq"],
                         seed=tcfg.seed)

    def batch_at(i):
        """Step ``i``'s global batch (every rank makes the same one)."""
        extra = (job["embeds"][i] if job.get("embeds") is not None
                 else step_embeds(cfg, i, job["batch"], device))
        return {**pipe.batch_at(i), **extra}
    ckpt_dir = job.get("ckpt_dir")
    eval_loss = None
    if job.get("eval"):
        eval_loss = float(make_eval_step(model)(
            params, batch_block(batch_at(0), device, mesh)))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if ckpt_dir is None:
        # no runner, no checkpoint: the steps alone
        resumed, log, t0 = 0, [], time.perf_counter()
        for i in range(job["steps"]):
            params, opt, m = timed_step(params, opt,
                                        batch_block(batch_at(i), device, mesh))
            log.append({k: float(v) for k, v in m.items()})
        final, dt = job["steps"], time.perf_counter() - t0
    else:
        fail, rank = job.get("fail"), 0 if mesh is None else dist.get_rank()
        injector = (None if fail is None or fail[0] != rank
                    else lambda i: i == fail[1])
        runner = TrainingRunner(
            RunnerConfig(ckpt_dir, checkpoint_every=job.get("ckpt_every", 25),
                         fail_injector=injector),
            timed_step, params, opt, batch_at, mesh=mesh, specs=model.specs)
        del params, opt   # the runner holds them; the first step replaces them
        resumed = latest_step(ckpt_dir) or 0
        t0 = time.perf_counter()
        final = runner.run(job["steps"])
        dt = time.perf_counter() - t0
        log = list(runner.metrics_log)
        params, opt = runner.params, runner.opt_state
        del runner
    for i in range(final, final + job.get("then", 0)):
        params, opt, m = timed_step(params, opt,
                                    batch_block(batch_at(i), device, mesh))
        log.append({k: float(v) for k, v in m.items()})
    out = dict(name=cfg.name, resumed=resumed, final=final, dt=dt,
               losses=[m["loss"] for m in log],
               grad_norms=[m["grad_norm"] for m in log], records=records,
               lead=is_lead_rank(mesh), device=str(device))
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if eval_loss is not None:
        out["eval_loss"] = eval_loss
    if job.get("gather"):
        whole = (params if mesh is None else
                 gather_tree(params, mesh, model.specs))
        out["params"] = _to_numpy(whole) if out["lead"] else None
    return out


def train_line(res: dict) -> str:
    """The reference driver's ``[train]`` line of a :func:`train_run`."""
    losses = res["losses"]
    if not losses:
        return "no steps"
    return (f"[train] {res['name']} steps {res['resumed']}->{res['final']} in "
            f"{res['dt']:.1f}s; loss {losses[0]:.3f} -> {losses[-1]:.3f}")


def _timing_line(res: dict, batch: int, seq: int, ranks: int) -> Optional[str]:
    step_s = [r["s"] for r in res["records"]]
    if "peak_bytes" not in res or not step_s:
        return None
    ms = statistics.median(step_s[1:] or step_s) * 1e3
    where = f" (rank 0 of {ranks})" if ranks > 1 else ""
    return (f"[train] {torch.cuda.get_device_name(torch.device(res['device']))}"
            f"{where}: step_ms {ms:.1f} (median of steps 2-{len(step_s)}), "
            f"tokens_per_s {batch * seq / ms * 1e3:.0f}, peak_mem_GB "
            f"{res['peak_bytes'] / 1e9:.2f}")


def main(argv=None):
    from .mesh import DIST_BACKENDS, NAMED_MESHES, named_mesh_layout, run_ranks
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--mesh", default=None,
                    help="single|multi|tiny|pipeline: train on that mesh of "
                         "ranks (tiny: 4 ranks, (data, model) = (2, 2)); "
                         "default: no mesh (1 device)")
    ap.add_argument("--dist-backend", default="nccl", choices=list(DIST_BACKENDS),
                    help="process-group backend of a --mesh run: nccl (ranks "
                         "on distinct cards) or gloo (ranks on the host or "
                         "sharing one card)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced-width config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=list(REMAT_MODES))
    ap.add_argument("--seq-parallel", action="store_true",
                    help="the config's seq_parallel: on a mesh, the residual's "
                         "sequence split over its model axis")
    ap.add_argument("--mlp-dp", action="store_true",
                    help="the config's mlp_dp: on a mesh, the dense FFN "
                         "replicated over its model axis and run on the "
                         "rank's rows of the sequence")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    flags = {k: True for k, on in (("seq_parallel", args.seq_parallel),
                                   ("mlp_dp", args.mlp_dp)) if on}
    job = dict(kind="train", arch=args.arch, reduced=args.reduced, cfg=flags,
               steps=args.steps, batch=args.batch, seq=args.seq,
               microbatches=args.microbatches, remat=args.remat,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    ranks = 1
    if args.mesh is not None:
        # refuse here what every rank would refuse
        check_mesh(_config(job), named_mesh_layout(args.mesh))
        from .mesh_runs import run_jobs
        ranks = math.prod(NAMED_MESHES[args.mesh][0])
        per_rank = run_ranks(run_jobs, ranks, backend=args.dist_backend,
                             device=device.type,
                             args=([dict(job, mesh=args.mesh)],))
        res = per_rank[0][0]
        if "error" in res:
            raise RuntimeError(f"--mesh {args.mesh}: {res['error']}")
    else:
        res = train_run(job, device)
    print(train_line(res))
    timing = _timing_line(res, args.batch, args.seq, ranks)
    if timing:
        print(timing)


if __name__ == "__main__":
    main()
