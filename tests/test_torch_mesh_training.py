"""The port's mesh training (``launch.train --mesh``, ``dist.sharding``'s
placement rules, the tensor- and data-parallel model, the train step,
``TrainingRunner`` and checkpoints on a mesh) against the JAX package, on
the CPU.

One module-scoped start of 4 gloo ranks (``launch.mesh.run_ranks``) runs
every mesh job (``launch.mesh_runs``' ``train`` kind) on the reference's
``tiny`` mesh, ``("data", "model") = (2, 2)``; the reference runs the same
training under its GSPMD placements on the conftest's 4 host devices, from
the same weights (the reference's ``init_params``, carried over as numpy).
Tolerances, each with its reason:

* each step's loss within 1e-5 relative: float32 sums taken in other
  orders (a row-parallel product's partial sums, the vocab-split
  log-sum-exp, the data ranks' gradients);
* the gathered parameters after 3 steps within 1e-4 absolute: the same
  sums, carried through AdamW at a rate of 1e-3;
* each recurrent block (mLSTM, sLSTM, SSM), and attention with heads the
  axis does not divide, on 2 ranks of one model axis against the same
  block alone, outputs and gradients within 1e-5 absolute: float32 sums in
  another order in one layer;
* placements, checkpoints, collective counts and refusals exactly.

The configs are the dense and MoE decoders, the recurrent ones
(xlstm-1.3b's mLSTM and sLSTM, hymba-1.5b's SSM beside attention), whose
blocks are tensor-parallel over ``model``, whisper-base's encoder-decoder
(its frame embeddings, and phi-3-vision-4.2b's image prefix, drawn with
numpy from a seed and given to both packages), and the leaves the model
axis does not divide, which the reference replicates: a vocabulary of 257
and hymba's attention with 5 heads (every head on every rank).  Then
``seq_parallel`` (the residual's sequence split over ``model``; the
parallel block, the hybrid under remat="full", the encoder-decoder, a
sequence of 15 the axis does not divide, two microbatches, and a model axis
of one rank, where it changes nothing bit for bit), ``mlp_dp`` with and
without it, and the parts of a layer the model axis does not split, which
run whole on every rank: a d_ff of 129, whisper's cross-attention with 5
heads and with one KV head, the mLSTM's head width of 33, 15-wide heads
(attention) and 65 SSM channels.  Each of these is held to the reference
with the tolerances above; its collectives to the count
:func:`_declared_counts` works out from the config, exactly.  On one
process the flags leave the loss and the gradients bit-equal.
"""

import dataclasses
import multiprocessing as mp
import os
import re
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.configs.reduced import reduced_config as j_reduced
from repro.data import TokenPipeline as JTokenPipeline
from repro.dist import sharding as j_sharding
from repro.dist.compat import make_mesh as j_make_mesh
from repro.launch.mesh import make_mesh_named as j_make_mesh_named
from repro.models import Model as JModel
from repro.models import init_params as j_init_params
from repro.training import RunnerConfig as JRunnerConfig
from repro.training import TrainingRunner as JTrainingRunner
from repro.training import adamw_init as j_adamw_init
from repro.training import make_train_step as j_make_train_step
from repro.training.optimizer import zero1_spec_tree as j_zero1
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.dist import sharding
from repro_torch.launch import train
from repro_torch.launch.mesh import named_mesh_layout, run_ranks
from repro_torch.launch.mesh_runs import run_jobs
from repro_torch.models.attention import attention, head_split, init_attention
from repro_torch.models import stages_meta
from repro_torch.models.convert import param_shapes
from repro_torch.models.ssm import init_ssm, ssm_block
from repro_torch.models.xlstm import (init_mlstm, init_slstm, mlstm_block,
                                      slstm_block)
from repro_torch.training import zero1_spec_tree

DENSE = ["gemma-2b", "gemma3-4b", "internlm2-20b", "command-r-35b"]
# the recurrent (mLSTM, sLSTM) and hybrid (attention beside the SSM) kinds
RECURRENT = ["xlstm-1.3b", "hymba-1.5b"]
# the encoder-decoder and the vision prefix
FRONTENDS = ["whisper-base", "phi-3-vision-4.2b"]
PORTED = DENSE + ["grok-1-314b", "llama4-maverick-400b-a17b"] + RECURRENT + FRONTENDS
STEPS, SEQ = 3, 16
# the rate the comparisons train at: warmup 1 so steps 2 and 3 move the
# weights (the default schedule's first 3 steps move them by < 1e-5)
TCFG = dict(learning_rate=1e-3, warmup_steps=1)
# (label, arch, batch, microbatches): every dense config, then a batch the
# data axis does not divide and two microbatches, then the recurrent ones
CASES = [(a, a, 4, 1) for a in DENSE] + [("gemma-2b batch 3", "gemma-2b", 3, 1),
                                         ("gemma-2b microbatches 2", "gemma-2b", 4, 2)] + \
    [(a, a, 4, 1) for a in RECURRENT] + [(a, a, 4, 1) for a in FRONTENDS] + \
    [("whisper-base vocab 257", "whisper-base", 4, 1),
     ("hymba-1.5b 5 heads", "hymba-1.5b", 4, 1),
     ("gemma-2b pod data", "gemma-2b", 4, 1),
     ("gemma-2b pod data microbatches 2", "gemma-2b", 8, 2)]
# sequence parallelism, mlp_dp and the leaves the model axis does not split
# (replicated, their layers run whole on every rank), each against the
# reference's run of the same config on its tiny mesh
SP = {"seq_parallel": True}
SP_CASES = [
    ("gemma-2b seq_parallel", "gemma-2b", SP),
    ("gemma-2b seq_parallel mlp_dp", "gemma-2b", dict(SP, mlp_dp=True)),
    ("gemma-2b mlp_dp", "gemma-2b", {"mlp_dp": True}),
    ("gemma-2b d_ff 129", "gemma-2b", {"d_ff": 129}),
    ("gemma-2b seq_parallel seq 15", "gemma-2b", SP),
    ("gemma-2b seq_parallel microbatches 2", "gemma-2b", SP),
    ("gemma-2b seq_parallel pod data", "gemma-2b", SP),
    ("command-r-35b seq_parallel", "command-r-35b", SP),
    ("hymba-1.5b seq_parallel", "hymba-1.5b", SP),
    ("whisper-base seq_parallel", "whisper-base", SP),
    ("whisper-base 5 heads", "whisper-base", {"n_heads": 5, "n_kv_heads": 5}),
    ("whisper-base 1 KV head", "whisper-base", {"n_kv_heads": 1}),
    ("whisper-base 1 KV head seq_parallel", "whisper-base", dict(SP, n_kv_heads=1)),
    ("xlstm-1.3b d_model 66", "xlstm-1.3b", {"d_model": 66}),
    ("xlstm-1.3b d_model 66 seq_parallel", "xlstm-1.3b", dict(SP, d_model=66)),
    # 15-wide heads without RoPE: the axis splits wq's 60 columns but not
    # the one KV head's 15, so attention runs whole on every rank
    ("gemma-2b 15-wide heads", "gemma-2b", {"rope_theta": 0.0, "d_head": 15}),
    ("gemma-2b 15-wide heads seq_parallel", "gemma-2b",
     dict(SP, rope_theta=0.0, d_head=15)),
    # 65 SSM channels: the SSM runs whole on every rank
    ("hymba-1.5b 65 SSM channels seq_parallel", "hymba-1.5b",
     dict(SP, d_model=65, ssm_expand=1))]
CASES += [(label, arch, 4, 2 if "microbatches" in label else 1)
          for label, arch, _ in SP_CASES]
# the cases on a mesh of two data axes, (pod, data, model) = (2, 2, 1), as a
# train job names it (the others run on tiny): the dense control of the path
# the mixture of experts takes there (test_torch_moe_mesh.py)
POD = ((2, 2, 1), ("pod", "data", "model"))
MESHES = {"gemma-2b pod data": POD, "gemma-2b pod data microbatches 2": POD,
          "gemma-2b seq_parallel pod data": POD}
# a sequence the model axis does not divide (padded to 16 and cut back)
SEQS = {"gemma-2b seq_parallel seq 15": 15}
# hymba with sequence parallelism under remat="full", as the card trains it
# (the reference's run, remat="none", computes the same numbers)
REMATS = {"hymba-1.5b seq_parallel": "full"}
# the reduced config's fields a case replaces: a vocabulary the model axis
# does not divide (replicated), and 5 heads of 16 over 5 KV heads (the
# axis cuts wq's 80 columns mid-head: every head on every rank)
OVERRIDES = {"whisper-base vocab 257": {"vocab_size": 257},
             "hymba-1.5b 5 heads": {"n_heads": 5, "n_kv_heads": 5, "d_head": 16,
                                    "vocab_size": 257}}
# every case's fields replaced
CHANGES = {**OVERRIDES, **{label: changes for label, _, changes in SP_CASES}}
# the recurrent blocks, each alone on 2 ranks of one model axis:
# (block, arch whose reduced config it takes, its init)
BLOCKS = [("mlstm", "xlstm-1.3b", init_mlstm), ("slstm", "xlstm-1.3b", init_slstm),
          ("ssm", "hymba-1.5b", init_ssm)]
# hymba's attention layer (window 8) with heads the model axis does not
# divide, alone on 2 ranks of one model axis: (label, the reduced config's
# fields it replaces)
ATTENTION_BLOCKS = [("attention 5 heads", {"n_heads": 5, "n_kv_heads": 5, "d_head": 16}),
                    ("attention 5 heads 1 KV head",
                     {"n_heads": 5, "n_kv_heads": 1, "d_head": 16})]


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakeMesh4:
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 4}


class FakeDataMesh:
    axis_names = ("data",)
    shape = {"data": 4}


class PodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 4, "model": 4}


def _ref_params(arch, seed=0, label=None):
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)),
                               **CHANGES.get(label, {}))
    return jcfg, j_init_params(jax.random.PRNGKey(seed), jcfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _embeds(jcfg, batch):
    """Each step's image (normal) or frame (normal x 0.05) embeddings of
    the global batch, float32, from a numpy seed; None for a tokens-only
    config."""
    images = jcfg.frontend_len if jcfg.frontend == "vision" else 0
    frames = jcfg.encoder_len if jcfg.n_encoder_layers else 0
    if not (images or frames):
        return None
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(100 + i)
        if images:
            out.append({"img_embeds": rng.normal(
                size=(batch, images, jcfg.d_model)).astype(np.float32)})
        else:
            out.append({"enc_embeds": (rng.normal(
                size=(batch, frames, jcfg.d_model)) * 0.05).astype(np.float32)})
    return out


def _batch_fn(jcfg, batch, seq=SEQ):
    pipe = JTokenPipeline(jcfg.vocab_size, batch=batch, seq_len=seq, seed=0)
    embeds = _embeds(jcfg, batch)
    return lambda i: {k: jnp.asarray(v) for k, v in
                      {**pipe.batch_at(i), **(embeds[i] if embeds else {})}.items()}


def _ref_mesh(label):
    """The reference's mesh of a case: tiny, or (shape, axes) in MESHES."""
    spec = MESHES.get(label, "tiny")
    return j_make_mesh_named(spec) if isinstance(spec, str) else j_make_mesh(*spec)


def _ref_mesh_step(jcfg, microbatches, label=None):
    """The reference launcher's jitted step under its mesh placements
    (``launch/train.py``; ``mlp_dp`` passed on, as ``launch/specs.py`` and
    the port place it), and the placements."""
    mesh = _ref_mesh(label)
    tcfg = JTrainConfig(total_steps=STEPS, microbatches=microbatches,
                        remat="none", **TCFG)
    step = j_make_train_step(JModel(jcfg), tcfg)
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    pshard = j_sharding.sharding_tree(shapes, mesh, jcfg.expert_sharding,
                                      jcfg.mlp_dp)
    return jax.jit(step, in_shardings=(pshard, None, None),
                   out_shardings=(pshard, None, None)), pshard


def _ref_mesh_run(label, arch, batch, microbatches):
    """3 steps of the reference on its mesh: (losses, final params)."""
    jcfg, jp = _ref_params(arch, label=label)
    j_sharding.set_mesh(_ref_mesh(label))
    try:
        step, pshard = _ref_mesh_step(jcfg, microbatches, label)
        params, opt = jax.device_put(jp, pshard), j_adamw_init(jp)
        fn, losses = _batch_fn(jcfg, batch, SEQS.get(label, SEQ)), []
        for i in range(STEPS):
            params, opt, m = step(params, opt, fn(i))
            losses.append(float(m["loss"]))
        return losses, _np(params)
    finally:
        j_sharding.reset_mesh()


# the reference's mesh runs by the label of their case, made by the
# fixture in worker processes (their compiles take most of this file's time)
_REF = {}


def _ref(label):
    return _REF[label]


def _job(arch, batch, microbatches, ckpt_dir, label=None, **kw):
    jcfg, jp = _ref_params(arch, label=label)
    job = dict(kind="train", mesh=MESHES.get(label, "tiny"), arch=arch, reduced=True,
               cfg=CHANGES.get(label, {}), steps=STEPS, batch=batch,
               seq=SEQS.get(label, SEQ), microbatches=microbatches,
               remat=REMATS.get(label, "none"), tcfg=TCFG, params=_np(jp),
               embeds=_embeds(jcfg, batch), ckpt_dir=str(ckpt_dir), gather=True)
    job.update(kw)
    return job


def _block_job(block, arch, init, changes=None):
    """One recurrent block (or attention layer) of the reduced ``arch``
    with ``changes`` to its fields, its weights from the port's init (seed
    0, a stack of one), x and the output weights from a numpy seed: B = 2,
    S = 20 (one ragged mLSTM chunk at its default width)."""
    import torch
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **(changes or {}))
    layer = init(torch.Generator().manual_seed(0), cfg, torch.float32, stacked=1)
    rng = np.random.default_rng(1)
    x, dout = rng.normal(size=(2, 2, 20, cfg.d_model)).astype(np.float32)
    return dict(kind="block", arch=arch, reduced=True, cfg=changes or {}, block=block,
                layer={k: v.numpy() for k, v in layer.items()}, x=x, dout=dout)


def _attention_job(changes):
    return _block_job("attention", "hymba-1.5b", init_attention, changes)


CLI_FLAGS = ["--arch", "gemma-2b", "--reduced", "--mesh", "tiny", "--steps", "3",
             "--batch", "4", "--seq", "16"]


def _recurrent_flags(arch):
    """The command-line flags for a recurrent config: CLI_FLAGS' run under
    ``remat="full"``, as the card trains them."""
    return ["--arch", arch, *CLI_FLAGS[2:], "--remat", "full"]


def _cli(module, ckpt_dir, *extra, flags=CLI_FLAGS):
    """``python -m <module> flags`` started in the background (the
    reference's on 4 XLA host devices)."""
    env = {**os.environ, "PYTHONPATH": "src",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    return subprocess.Popen([sys.executable, "-m", module, *flags,
                             "--ckpt-dir", str(ckpt_dir), *extra],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _failed_run(job):
    """The error of a start of 4 gloo ranks running ``job`` (None if every
    rank finished)."""
    try:
        run_ranks(run_jobs, 4, backend="gloo", device="cpu", args=([job],),
                  timeout=300)
    except RuntimeError as e:
        return str(e)
    return None


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every mesh job in one start of 4 gloo ranks, beside the two drivers'
    ``--mesh tiny`` runs (subprocesses) and the reference's mesh runs (this
    process), all at once; returns (jobs by label, per-rank results by
    label, the drivers' ``(returncode, stdout, stderr)`` by package)."""
    root = tmp_path_factory.mktemp("mesh_training")
    clis = {"port": _cli("repro_torch.launch.train", root / "cli_t", "--device",
                         "cpu", "--dist-backend", "gloo"),
            "port flags": _cli("repro_torch.launch.train", root / "cli_t_flags",
                               "--device", "cpu", "--dist-backend", "gloo",
                               "--seq-parallel", "--mlp-dp"),
            "reference": _cli("repro.launch.train", root / "cli_j")}
    for arch in RECURRENT:
        clis[f"port {arch}"] = _cli("repro_torch.launch.train", root / f"cli_t_{arch}",
                                    "--device", "cpu", "--dist-backend", "gloo",
                                    flags=_recurrent_flags(arch))
        clis[f"reference {arch}"] = _cli("repro.launch.train", root / f"cli_j_{arch}",
                                         flags=_recurrent_flags(arch))
    for arch in FRONTENDS:
        clis[f"port {arch}"] = _cli("repro_torch.launch.train", root / f"cli_t_{arch}",
                                    "--device", "cpu", "--dist-backend", "gloo",
                                    flags=["--arch", arch, *CLI_FLAGS[2:]])
    # the reference's mesh runs, meanwhile, in 3 processes (spawned: they
    # inherit the 4 host devices' flag and import this module)
    pool = ProcessPoolExecutor(3, mp_context=mp.get_context("spawn"))
    threads = ThreadPoolExecutor(2)
    keys = [label for label, _, _, _ in CASES]
    refs = [pool.submit(_ref_mesh_run, *case) for case in CASES]
    try:
        # a reference checkpoint at step 2, written without a mesh, which a
        # mesh job restores
        jcfg, jp = _ref_params("gemma-2b")
        jtcfg = JTrainConfig(total_steps=STEPS, remat="none", **TCFG)
        jrunner = JTrainingRunner(
            JRunnerConfig(str(root / "jax"), checkpoint_every=2),
            jax.jit(j_make_train_step(JModel(jcfg), jtcfg)), jp,
            j_adamw_init(jp), _batch_fn(jcfg, 4))
        jrunner.run(2)
        jobs = {label: _job(arch, b, mb, root / label.replace(" ", "_"), label=label,
                            eval=True)
                for label, arch, b, mb in CASES}
        # hymba's 5 heads under remat="full", as the card trains it (the
        # collectives of its recompute)
        jobs[REMAT_LABEL] = _job("hymba-1.5b", 4, 1, root / "remat",
                                 label="hymba-1.5b 5 heads", remat="full")
        whole = dict(TCFG, total_steps=STEPS)   # the 3-step schedule
        # 2 steps with a checkpoint at 2, then step 3 in memory
        jobs["ckpt"] = _job("gemma-2b", 4, 1, root / "torch", steps=2,
                            ckpt_every=2, then=1, tcfg=whole)
        # the reference's directory restored on the mesh, then step 3
        jobs["restore"] = _job("gemma-2b", 4, 1, root / "jax", steps=1,
                               params=None, seed=5, tcfg=whole)
        # what the mesh refuses: a mesh of more ranks than the group has
        refused = dict(_job("gemma-2b", 4, 2, root / "refused"), params=None)
        jobs["single"] = dict(refused, mesh="single")
        labels = list(jobs)
        # a run whose step 1 fails on rank 1 alone, in 4 ranks of its own
        # meanwhile (the failure ends that start)
        failing = threads.submit(_failed_run, _job(
            "gemma-2b", 4, 1, root / "fail", ckpt_every=1, fail=(1, 1)))
        # each recurrent block alone on 2 ranks of one model axis, meanwhile
        blocks = threads.submit(run_ranks, run_jobs, 2, backend="gloo", device="cpu",
                                args=([_block_job(*b) for b in BLOCKS] +
                                      [_attention_job(c) for _, c in ATTENTION_BLOCKS],),
                                timeout=300)
        per_rank = run_ranks(run_jobs, 4, backend="gloo", device="cpu",
                             args=([jobs[k] for k in labels],), timeout=300)
        _REF.update(zip(keys, (f.result() for f in refs)))
        failed = failing.result()
        per_block = blocks.result()
    except BaseException:
        for proc in clis.values():
            proc.kill()
        raise
    finally:
        pool.shutdown(cancel_futures=True)
        threads.shutdown()
    results = {k: [r[i] for r in per_rank] for i, k in enumerate(labels)}
    results["one rank fails"] = failed
    for i, name in enumerate([b[0] for b in BLOCKS] +
                             [label for label, _ in ATTENTION_BLOCKS]):
        results[f"block {name}"] = [r[i] for r in per_block]
    drivers = {}
    for name, proc in clis.items():
        stdout, stderr = proc.communicate(timeout=600)
        drivers[name] = (proc.returncode, stdout, stderr)
    return jobs, results, drivers


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def _ref_shapes(arch):
    cfg = j_get_config(arch)
    return cfg, jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), cfg))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("mesh_name", ["tiny", "single", "multi"])
@pytest.mark.parametrize("arch", PORTED)
def test_placements_equal_the_references_on_every_leaf(arch, mesh_name):
    """spec_tree, zero1_spec_tree and batch_spec of the port equal the
    reference's on every leaf of the config at full shapes."""
    jcfg, shapes = _ref_shapes(arch)
    mesh = named_mesh_layout(mesh_name)
    want = dict(_flat(j_sharding.spec_tree(shapes, mesh, jcfg.expert_sharding)))
    got = dict(_flat(sharding.spec_tree(param_shapes(get_config(arch)), mesh,
                                        jcfg.expert_sharding)))
    shape_of = dict(_flat(jax.tree.map(lambda s: s.shape, shapes)))
    assert sorted(got) == sorted(want)
    widen, jwiden = zero1_spec_tree(got, mesh), j_zero1(want, mesh)
    for path in want:
        assert got[path] == tuple(want[path]), path
        assert widen(got[path], shape_of[path]) == tuple(
            jwiden(want[path], shape_of[path])), path
    for b in (1, 2, 3, 4, 8, 16, 32, 64, 256, 512):
        assert sharding.batch_spec(b, mesh) == tuple(j_sharding.batch_spec(b, mesh))


# the rule cases of the reference's tests (test_sharding_rules.py,
# test_dist_sharding.py), on their meshes
RULE_CASES = [
    (FakeMesh, "stages/s0/stk_wq", (48, 6144, 6144), P(None, None, "model")),
    (FakeMesh, "stages/s0/stk_wo", (48, 6144, 6144), P(None, "model", None)),
    (FakeMesh, "stages/s0/stk_w_up", (48, 6144, 16384), P(None, None, "model")),
    (FakeMesh, "stages/s0/stk_w_down", (48, 16384, 6144), P(None, "model", None)),
    (FakeMesh, "embed", (256000, 2048), P("model", None)),
    (FakeMesh, "embed", (51865, 512), P(None, None)),
    (FakeMesh, "lm_head", (6144, 92544), P(None, "model")),
    (FakeMesh, "stages/s0/stk_norm1_scale", (48, 6144), P(None, None)),
    (FakeMesh, "stages/s0/stk_experts_up", (24, 128, 5120, 8192),
     P(None, "data", None, "model")),
    (FakeMesh, "stages/s0/stk_experts_down", (24, 128, 8192, 5120),
     P(None, "data", "model", None)),
    (FakeMesh, "stages/s0/stk_router", (24, 5120, 128), P(None, None, None)),
    (FakeMesh4, "stages/s0/stk_wq", (8, 64, 64), P(None, None, "model")),
    (FakeMesh4, "stages/s0/stk_w_gate", (8, 64, 256), P(None, None, "model")),
    (FakeMesh4, "stages/s0/stk_ssm_in_proj", (8, 64, 256), P(None, None, "model")),
    (FakeMesh4, "stages/s0/stk_m_in_proj", (8, 64, 256), P(None, None, "model")),
    (FakeMesh4, "stages/s0/stk_wo", (8, 64, 64), P(None, "model", None)),
    (FakeMesh4, "stages/s0/stk_ssm_out_proj", (8, 128, 64), P(None, "model", None)),
    (FakeMesh4, "stages/s0/stk_m_out_proj", (8, 128, 64), P(None, "model", None)),
    (FakeMesh4, "stages/s0/stk_norm1_scale", (8, 64), P(None, None)),
    (FakeMesh4, "final_norm/scale", (64,), P(None)),
    (FakeMesh4, "stages/s0/stk_router", (8, 64, 16), P(None, None, None)),
    (FakeMesh4, "stages/s0/stk_ssm_conv", (8, 4, 128), P(None, None, None)),
    (FakeMesh4, "stages/s0/stk_ssm_a_log", (8, 128, 16), P(None, None, None)),
    (FakeMesh4, "enc_pos", (1500, 64), P(None, None)),
    (FakeMesh4, "embed", (1024, 64), P("model", None)),
    (FakeMesh4, "embed", (1023, 64), P(None, None)),
    (FakeMesh4, "lm_head", (64, 1024), P(None, "model")),
    (FakeMesh4, "lm_head", (64, 1023), P(None, None)),
    (FakeMesh4, "stages/s0/stk_experts_up", (8, 16, 64, 256),
     P(None, "data", None, "model")),
    (FakeMesh4, "stages/s0/stk_experts_down", (8, 16, 256, 64),
     P(None, "data", "model", None)),
    (FakeMesh4, "stages/s0/stk_experts_up", (8, 6, 64, 256),
     P(None, None, None, "model")),
    (FakeDataMesh, "stages/s0/stk_wq", (8, 64, 64), P(None, None, None)),
    (FakeDataMesh, "embed", (1024, 64), P(None, None)),
]


@pytest.mark.parametrize("mesh_cls,path,shape,expect", RULE_CASES)
def test_param_spec_rule_cases(mesh_cls, path, shape, expect):
    got = sharding.param_spec(path, shape, mesh_cls())
    assert got == tuple(expect) == tuple(j_sharding.param_spec(path, shape, mesh_cls()))


@pytest.mark.parametrize("kw,path,shape", [
    (dict(mlp_dp=True), "stages/s0/stk_w_up", (8, 64, 256)),
    (dict(mlp_dp=True), "stages/s0/stk_w_down", (8, 256, 64)),
    (dict(mlp_dp=True), "stages/s0/stk_wq", (8, 64, 64)),
    (dict(expert_sharding="tp2d"), "stages/s0/stk_experts_up", (8, 6, 64, 256)),
    (dict(expert_sharding="tp2d"), "stages/s0/stk_experts_down", (8, 6, 256, 64)),
    (dict(expert_sharding="tp2d"), "stages/s0/stk_experts_up", (64, 8, 6144, 32768)),
])
def test_param_spec_flag_rules(kw, path, shape):
    for mesh in (FakeMesh(), FakeMesh4(), PodMesh()):
        assert sharding.param_spec(path, shape, mesh, **kw) == tuple(
            j_sharding.param_spec(path, shape, mesh, **kw))


def test_dp_axes_and_batch_spec_rule_cases():
    for mesh in (FakeMesh4(), FakeDataMesh(), PodMesh()):
        assert sharding.dp_axes(mesh) == j_sharding.dp_axes(mesh)
        for b in (1, 3, 6, 8, 16):
            assert sharding.batch_spec(b, mesh) == tuple(j_sharding.batch_spec(b, mesh))
    assert sharding.dp_axes(None) == ("data",)
    assert sharding.batch_spec(8, None) == (None,)
    assert sharding.batch_spec(8, FakeMesh4()) == ("data",)
    assert sharding.batch_spec(6, FakeMesh4()) == (None,)
    assert sharding.batch_spec(16, PodMesh()) == (("pod", "data"),)


@pytest.mark.parametrize("name", ["tiny", "single", "single_pod", "16x16", "multi",
                                  "multi_pod", "2x16x16", "pipeline"])
def test_named_meshes_are_the_references(name, monkeypatch):
    """Each named mesh has the reference's shape and axis names (the
    reference's mesh constructor recorded instead of called: the large
    meshes need 256 and 512 devices)."""
    from repro.launch import mesh as jm
    monkeypatch.setattr(jm, "make_mesh", lambda shape, axes, **kw: (tuple(shape),
                                                                    tuple(axes)))
    d = named_mesh_layout(name)
    shape = tuple(d.shape[a] for a in d.axis_names)
    assert (shape, d.axis_names) == jm.make_mesh_named(name)


def test_an_unknown_mesh_name_raises():
    with pytest.raises(ValueError, match="unknown mesh"):
        named_mesh_layout("nope")


def test_shard_and_gather_trees_round_trip_without_ranks():
    """shard_tree's blocks, laid side by side in mesh order, are the leaf
    (a one-rank mesh stand-in: coordinates and sizes only)."""
    import torch

    class Stub:
        mesh_dim_names = ("data", "model")

        def __init__(self, d, m):
            self.coord = {"data": d, "model": m}

        def size(self, i):
            return 2

        def get_local_rank(self, axis):
            return self.coord[axis]

    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    spec = {"w": (None, "model", ("data", "model"))}
    blocks = {(d, m): sharding.shard_tree({"w": x}, Stub(d, m), spec)["w"]
              for d in range(2) for m in range(2)}
    for (d, m), blk in blocks.items():
        assert blk.shape == (4, 3, 2) and blk.is_contiguous()
        assert torch.equal(blk, x[:, m * 3:(m + 1) * 3, (d * 2 + m) * 2:(d * 2 + m + 1) * 2])
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_tree({"w": x[:, :5]}, Stub(0, 0), spec)


# ---------------------------------------------------------------------------
# training against the reference's tiny mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label,arch,batch,microbatches", CASES)
def test_mesh_training_matches_the_references_mesh(mesh_runs, label, arch, batch,
                                                   microbatches):
    _, results, _ = mesh_runs
    want_losses, want_params = _ref(label)
    per_rank = results[label]
    for res in per_rank:
        assert "error" not in res, res
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-5)
        assert res["losses"] == per_rank[0]["losses"]
    lead = [r for r in per_rank if r["lead"]]
    assert len(lead) == 1 and all(r["params"] is None for r in per_rank if not r["lead"])
    got = dict(_flat(lead[0]["params"]))
    want = dict(_flat(want_params))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path].astype(np.float32),
                                   rtol=0, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("label,arch,batch,microbatches", CASES)
def test_the_eval_step_on_a_mesh_gives_the_global_loss(mesh_runs, label, arch,
                                                       batch, microbatches):
    """make_eval_step of the model on the mesh gives, on every rank, the
    global loss of the whole batch: the reference mesh's first step's loss
    at the same weights (a replicated batch and two microbatches too)."""
    _, results, _ = mesh_runs
    want_losses, _ = _ref(label)
    for res in results[label]:
        np.testing.assert_allclose(res["eval_loss"], want_losses[0], rtol=1e-5)


def test_a_step_failing_on_one_rank_fails_every_rank(mesh_runs):
    """A step that raises on one rank of the mesh is not retried there (the
    other ranks are inside its collectives): the run fails, naming it."""
    _, results, _ = mesh_runs
    err = results["one rank fails"]
    assert err is not None, "the run finished although rank 1 failed"
    assert re.search(r"rank 1 failed:[\s\S]*injected failure at step 1", err), err


def _per_step_counts(cfg_layers, mqa, microbatches, n_leaves, chunks=1):
    """The collectives of one step on a rank of the tiny mesh (the count
    chip_smoke.py declares): per microbatch the embedding's, two per layer
    forward and backward, the loss's (the max and the sums a chunk, h's
    gradient), the gathers of an MQA layer; per step the global norm's; on
    ``data`` the mask count and the loss a microbatch, and every leaf, and
    with two microbatches or more the gather of the batch's tokens (each
    microbatch is the reference's global rows)."""
    model = {"all_reduce": microbatches * (1 + 4 * cfg_layers + chunks + 1) + 1,
             "all_reduce_max": microbatches * chunks}
    if mqa:
        model.update(all_gather=microbatches * cfg_layers,
                     reduce_scatter=microbatches * cfg_layers)
    data = {"all_reduce": 2 * microbatches + n_leaves}
    if microbatches > 1:
        data["all_gather"] = 1
    return {"data": data, "model": model}


@pytest.mark.parametrize("label", ["gemma-2b", "gemma3-4b", "gemma-2b microbatches 2"])
def test_mesh_step_collectives_are_the_declared_count(mesh_runs, label):
    jobs, results, _ = mesh_runs
    job = jobs[label]
    cfg = j_reduced(j_get_config(job["arch"]))
    n_leaves = len(jax.tree.leaves(job["params"]))
    want = _per_step_counts(cfg.n_layers, cfg.n_kv_heads % 2 != 0,
                            job["microbatches"], n_leaves)
    for res in results[label]:
        for rec in res["records"]:
            got = {a: {op: c["calls"] for op, c in ops.items()}
                   for a, ops in rec["collectives"].items()}
            assert got == want


# the collectives over ``model`` a layer of each recurrent kind makes per
# microbatch: (all_reduce, all_gather, reduce_scatter).  mLSTM: the
# in-projection, q/k/v and the gates gathered (their gradients
# reduce-scattered), the output all-reduced, the input's gradient summed;
# sLSTM: the one in-projection gathered; hybrid: attention's and the MLP's
# two all-reduces each, the SSM's output and input, and the gradients of
# its three replicated leaves (conv, bc_proj, a_log) summed, and its
# in-projection gathered
RECURRENT_LAYER_COLLECTIVES = {"mlstm": (2, 3, 3), "slstm": (2, 1, 1),
                               "hybrid": (9, 1, 1)}


def _recurrent_step_counts(cfg, n_leaves, chunks=1):
    """The collectives of one step of a recurrent config on a rank of the
    tiny mesh (one microbatch): the layers' (above), the embedding's, the
    loss's and the global norm's on ``model``; the mask count, the loss and
    every leaf on ``data``."""
    from repro_torch.models import stages_meta
    per_kind = [tuple(c * n for n in RECURRENT_LAYER_COLLECTIVES[k])
                for k, c in stages_meta(cfg)]
    reduces, gathers, scatters = (sum(col) for col in zip(*per_kind))
    return {"data": {"all_reduce": 2 + n_leaves},
            "model": {"all_reduce": 1 + reduces + chunks + 1 + 1,
                      "all_reduce_max": chunks, "all_gather": gathers,
                      "reduce_scatter": scatters}}


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_step_collectives_are_the_declared_count(mesh_runs, arch):
    jobs, results, _ = mesh_runs
    cfg = reduced_config(get_config(arch))
    want = _recurrent_step_counts(cfg, len(jax.tree.leaves(jobs[arch]["params"])))
    for res in results[arch]:
        for rec in res["records"]:
            got = {a: {op: c["calls"] for op, c in ops.items()}
                   for a, ops in rec["collectives"].items()}
            assert got == want


@pytest.mark.parametrize("block,arch,init", BLOCKS)
def test_recurrent_block_on_a_model_axis_equals_the_block_alone(mesh_runs, block,
                                                                arch, init):
    """Each recurrent block tensor-parallel on 2 ranks of one model axis
    (the reference's placements: column-split projections gathered, the
    recurrence on the rank's heads or channels, the row-parallel output
    all-reduced) against the same block without a mesh: the output, the
    input's gradient and every weight's gradient within 1e-5 absolute
    (float32 sums in another order), the gradients of the replicated
    leaves equal on both ranks (summed over the model axis), and the
    declared collectives."""
    import torch
    _, results, _ = mesh_runs
    job = _block_job(block, arch, init)
    cfg = reduced_config(get_config(arch))
    forward = {"mlstm": mlstm_block, "slstm": slstm_block, "ssm": ssm_block}[block]
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in job["layer"].items()}
    x = torch.from_numpy(job["x"]).requires_grad_()
    out, _ = forward({k[4:]: v[0] for k, v in p.items()}, x, cfg)
    *gp, gx = torch.autograd.grad((out * torch.from_numpy(job["dout"])).sum(),
                                  list(p.values()) + [x])
    want = dict(zip(p, (g.numpy() for g in gp)))
    kind = {"ssm": "hybrid"}.get(block, block)
    reduces, gathers, scatters = RECURRENT_LAYER_COLLECTIVES[kind]
    if kind == "hybrid":
        reduces -= 4                   # attention's and the MLP's, not the block's
    per_rank = results[f"block {block}"]
    assert sorted(r["lead"] for r in per_rank) == [False, True]
    for res in per_rank:
        assert "error" not in res, res
        np.testing.assert_allclose(res["out"], out.detach().numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["dx"], gx.numpy(), rtol=0, atol=1e-5)
        assert res["collectives"] == {"model": {
            "all_reduce": reduces, "all_gather": gathers, "reduce_scatter": scatters}}
        for k, spec in res["specs"].items():
            if all(e is None for e in spec):
                np.testing.assert_allclose(res["local"][k], want[k], rtol=0, atol=1e-5,
                                           err_msg=k)
        if res["lead"]:
            assert sorted(res["grads"]) == sorted(want)
            for k in want:
                np.testing.assert_allclose(res["grads"][k], want[k], rtol=0, atol=1e-5,
                                           err_msg=k)
    split = {k for k, spec in per_rank[0]["specs"].items() if any(spec)}
    assert split == {k for k in want if not k.endswith(("conv", "bc_proj", "a_log"))}


@pytest.mark.parametrize("label,changes", ATTENTION_BLOCKS)
def test_attention_with_heads_the_axis_does_not_divide_equals_the_layer_alone(
        mesh_runs, label, changes):
    """hymba's attention layer (window 8) with 5 heads of 16 on 2 ranks of
    one model axis, whose placement cuts wq's 80 columns at 40, mid-head
    (the reference's): each rank's q, k, v column products are gathered in
    one all-gather, every head runs on every rank, and each rank takes the
    output columns of its rows of wo before the all-reduce.  Against the
    layer alone: the output, the input's gradient and every weight's
    gradient within 1e-5 absolute; one all-gather and the output's
    all-reduce forward, one reduce-scatter and the input's all-reduce
    backward."""
    import torch
    _, results, _ = mesh_runs
    job = _attention_job(changes)
    cfg = dataclasses.replace(reduced_config(get_config("hymba-1.5b")), **changes)
    assert head_split(cfg, 2) == "all"
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in job["layer"].items()}
    x = torch.from_numpy(job["x"]).requires_grad_()
    out, _ = attention({k[4:]: v[0] for k, v in p.items()}, x, cfg, window=cfg.window)
    *gp, gx = torch.autograd.grad((out * torch.from_numpy(job["dout"])).sum(),
                                  list(p.values()) + [x])
    want = dict(zip(p, (g.numpy() for g in gp)))
    per_rank = results[f"block {label}"]
    assert sorted(r["lead"] for r in per_rank) == [False, True]
    for res in per_rank:
        assert "error" not in res, res
        np.testing.assert_allclose(res["out"], out.detach().numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["dx"], gx.numpy(), rtol=0, atol=1e-5)
        assert res["collectives"] == {"model": {
            "all_reduce": 2, "all_gather": 1, "reduce_scatter": 1}}
        assert all(any(spec) for spec in res["specs"].values())
        if res["lead"]:
            for k in want:
                np.testing.assert_allclose(res["grads"][k], want[k], rtol=0, atol=1e-5,
                                           err_msg=k)


# the collectives over ``model`` a layer of each kind makes per microbatch
# when the axis gives each rank its own heads: (all-reduces forward,
# all-reduces backward, gathers; a gather is one all_gather forward and
# one reduce_scatter backward).  attn, local, enc: the attention's and the
# MLP's outputs forward, their inputs' gradients backward; xdec: the
# cross-attention's two on top; the hybrid's, mLSTM's and sLSTM's as
# RECURRENT_LAYER_COLLECTIVES counts them
LAYER_COLLECTIVES = {"attn": (2, 2, 0), "local": (2, 2, 0), "enc": (2, 2, 0),
                     "xdec": (3, 3, 0), "hybrid": (3, 6, 1), "mlstm": (1, 1, 3),
                     "slstm": (1, 1, 1)}


def _step_counts(cfg, n_leaves, remat="none", chunks=1):
    """The collectives of one step on a rank of the tiny mesh (one
    microbatch, no MoE): on ``model`` each layer's (LAYER_COLLECTIVES, and
    one more gather of q, k, v when the axis does not divide the heads:
    ``head_split``), under ``remat="full"`` each decoder layer's forward
    ones again but the last (the recompute stops after the last tensor the
    backward reads, before the MLP's all-reduce), the sum of the encoder
    output's gradient, the vocab-parallel embedding's and loss's (none for
    a replicated vocabulary), and the global norm's; on ``data`` the mask
    count, the loss and every leaf."""
    from repro_torch.models import stages_meta
    reduces = gathers = again = 0
    # the gather of q, k, v, or of the one KV head (MQA), a layer
    heads = int(head_split(cfg, 2) != "heads")
    enc = [("enc", cfg.n_encoder_layers)] if cfg.n_encoder_layers else []
    for kind, count in stages_meta(cfg) + enc:
        f, b, g = LAYER_COLLECTIVES[kind.split("+")[0]]
        g += heads if kind not in ("mlstm", "slstm") else 0
        reduces, gathers = reduces + count * (f + b), gathers + count * g
        if remat == "full" and kind != "enc":
            reduces, again = reduces + count * (f - 1), again + count * g
    split_vocab = cfg.vocab_size % 2 == 0
    model = {"all_reduce": reduces + len(enc) + (2 + chunks if split_vocab else 0) + 1}
    if split_vocab:
        model["all_reduce_max"] = chunks
    if gathers:
        model.update(all_gather=gathers + again, reduce_scatter=gathers)
    return {"data": {"all_reduce": 2 + n_leaves}, "model": model}


REMAT_LABEL = "hymba-1.5b 5 heads remat full"


@pytest.mark.parametrize("label", FRONTENDS + list(OVERRIDES) + [REMAT_LABEL])
def test_frontend_and_replicated_step_collectives_are_the_declared_count(mesh_runs,
                                                                         label):
    """whisper-base (its encoder, cross-attention and the sum of the
    encoder output's gradient), phi-3-vision-4.2b, a replicated vocabulary
    (no collective for the embedding or the loss) and hymba's 5 heads (one
    gather a layer; under remat="full" the recompute's too): every step of
    every rank makes the declared count."""
    jobs, results, _ = mesh_runs
    job = jobs[label]
    cfg = dataclasses.replace(reduced_config(get_config(job["arch"])), **job["cfg"])
    want = _step_counts(cfg, len(jax.tree.leaves(job["params"])),
                        remat=job.get("remat", "none"))
    for res in results[label]:
        for rec in res["records"]:
            got = {a: {op: c["calls"] for op, c in ops.items()}
                   for a, ops in rec["collectives"].items()}
            assert got == want


# the collectives over ``model`` of the parts of a layer, each a (forward,
# backward) pair of op lists: a tensor-parallel part enters by a copy (its
# gradient all-reduced) or, under sequence parallelism, a gather of the
# sequence (all-gather, its gradient reduce-scattered), and leaves by an
# all-reduce or a reduce-scatter (its gradient all-gathered); a part run
# whole on every rank gathers its split weights (all-gather, no backward)
# and, under sequence parallelism, the sequence (all-gather) and cuts its
# output back to the rank's rows (its gradient all-gathered)
ENTER = {False: ([], ["all_reduce"]), True: (["all_gather"], ["reduce_scatter"])}
LEAVE = {False: (["all_reduce"], []), True: (["reduce_scatter"], ["all_gather"])}
GATHER = (["all_gather"], ["reduce_scatter"])
COPY = ([], ["all_reduce"])
UNSPLIT = (["all_gather"], [])
SPLIT = ([], ["all_gather"])


def _stage_of(cfg, kind, tree):
    """The stacked leaves of a layer of ``kind`` in ``tree`` (the
    parameter tree's shape, or its placements)."""
    if kind == "enc":
        return tree["enc_stages"]["e0"]
    return tree["stages"][next(f"s{i}" for i, (k, _) in enumerate(stages_meta(cfg))
                               if k.split("+")[0] == kind)]


def _split_leaves(cfg, names, kind):
    """How many of a layer's ``names`` the tiny mesh's placement splits
    over ``model`` (the port's rules, held to the reference's by the
    placement tests)."""
    specs = _stage_of(cfg, kind, sharding.spec_tree(
        param_shapes(cfg), named_mesh_layout("tiny"), cfg.expert_sharding, cfg.mlp_dp))
    return sum(any(e == "model" for e in specs[f"stk_{n}"])
               for n in names if f"stk_{n}" in specs)


def _whole(sp, n_weights):
    return ([UNSPLIT] + [UNSPLIT] * n_weights + [SPLIT]) if sp else [UNSPLIT] * n_weights


def _parts(cfg, kind, sp):
    """The model-axis parts of one layer of ``kind`` in forward order, and
    whether its last op is the output of a tensor-parallel part (which the
    recompute of remat="full" stops before)."""
    from repro_torch.models.mlp import mlp_split
    from repro_torch.models.ssm import ssm_split
    from repro_torch.models.xlstm import mlstm_split, slstm_split
    tp = (cfg.n_kv_heads * cfg.head_dim) % 2 == 0
    form = head_split(cfg, 2)

    def tp_part(*inner):
        return [ENTER[sp], *inner, LEAVE[sp]]

    attn = (tp_part(*([GATHER] if form != "heads" else [])) if tp else
            _whole(sp, _split_leaves(cfg, ("wq", "wk", "wv", "wo"), kind)))
    cross = (tp_part(*([GATHER] if form == "all" else [])) if tp else
             _whole(sp, _split_leaves(cfg, ("xwq", "xwo"), kind)))
    if mlp_split(cfg, 2):
        ffn = tp_part()
    else:
        ffn = [SPLIT, UNSPLIT] if cfg.mlp_dp and not sp else []
    blocks = {"hybrid": (ssm_split, "ssm_", [GATHER, COPY, COPY, COPY]),
              "mlstm": (mlstm_split, "m_", [GATHER] * 3),
              "slstm": (slstm_split, "s_", [GATHER])}
    block = []
    if kind in blocks:
        split, prefix, inner = blocks[kind]
        names = [k[4:] for k in _stage_of(cfg, kind, param_shapes(cfg))
                 if k.startswith("stk_" + prefix)]
        block = tp_part(*inner) if split(cfg, 2) else _whole(sp, _split_leaves(
            cfg, names, kind))
    parts = {"attn": attn + ffn, "local": attn + ffn, "enc": attn + ffn,
             "xdec": attn + cross + ffn, "hybrid": attn + block + ffn,
             "mlstm": block, "slstm": block}[kind]
    last_leaves = (ffn if kind not in ("mlstm", "slstm") else block)[-1:] == [LEAVE[sp]]
    return parts, last_leaves


def _declared_counts(cfg, n_leaves, microbatches=1, remat="none", chunks=1):
    """The collectives of one step on a rank of the tiny mesh of a dense,
    recurrent, hybrid, vision or encoder-decoder config, with or without
    ``seq_parallel`` and ``mlp_dp``, whatever the model axis splits: per
    microbatch on ``model`` the layers' parts (:func:`_parts`; under
    remat="full" each decoder layer's forward ops again, but a last
    tensor-parallel output), the embedding's (an all-reduce of the
    vocab-parallel lookup, a reduce-scatter under sequence parallelism, or
    the cut of a replicated lookup to the rank's rows), the encoder's
    frames cut to the rank's rows, the cross K/V's input and their gathers
    (an MQA or every-head form), and the loss's (the hidden state's
    gradient summed, or its rows gathered whole, and a chunk's max and
    sums); per step the global norm's and one all-reduce of every leaf a
    rank computes with on its own rows (the norms' under sequence
    parallelism, a replicated FFN's under it or ``mlp_dp``); on ``data``
    the mask count and the loss a microbatch, every leaf, and the batch's
    gather with two microbatches."""
    from repro_torch.models.mlp import mlp_split
    sp = cfg.seq_parallel
    ops: dict = {}

    def add(pairs, times=1, fwd_only=False):
        for f, b in pairs:
            for op in f + ([] if fwd_only else b):
                ops[op] = ops.get(op, 0) + times

    split_vocab = cfg.vocab_size % 2 == 0
    per_mb = []
    if split_vocab:
        per_mb.append((["reduce_scatter"], ["all_gather"]) if sp else (["all_reduce"], []))
        per_mb.append(GATHER if sp else COPY)
        per_mb += [(["all_reduce_max", "all_reduce"], [])] * chunks
    elif sp:
        per_mb += [SPLIT, UNSPLIT]
    stages = stages_meta(cfg)
    if cfg.n_encoder_layers:
        stages = stages + [("enc", cfg.n_encoder_layers)]
        tp = (cfg.n_kv_heads * cfg.head_dim) % 2 == 0
        per_mb += [SPLIT] if sp else []
        per_mb += ([ENTER[sp]] if tp else [UNSPLIT] if sp else [])
        if tp and head_split(cfg, 2) != "heads":
            per_mb += [GATHER] * sum(1 for k, _ in stages_meta(cfg) if k == "xdec")
    add(per_mb, microbatches)
    for kind, count in stages:
        parts, last_leaves = _parts(cfg, kind.split("+")[0], sp)
        add(parts, count * microbatches)
        if remat == "full" and kind != "enc":
            again = [op for f, _ in parts for op in f]
            if last_leaves:
                again = again[:-1]
            add([(again, [])], count * microbatches)
    sums = 0
    for path, _ in _flat(param_shapes(cfg)):
        name = path.split("/")[-1].removeprefix("stk_")
        ffn = name in ("w_up", "w_gate", "w_down") and not mlp_split(cfg, 2)
        sums += (sp and ("norm" in path or ffn)) or (cfg.mlp_dp and ffn)
    ops["all_reduce"] = ops.get("all_reduce", 0) + 1 + sums
    data = {"all_reduce": 2 * microbatches + n_leaves}
    if microbatches > 1:
        data["all_gather"] = 1
    return {"data": data, "model": ops}


SP_COUNTED = [label for label, _, _ in SP_CASES if label not in MESHES]


@pytest.mark.parametrize("label", SP_COUNTED)
def test_sequence_parallel_and_replicated_step_collectives_are_the_declared_count(
        mesh_runs, label):
    """Every step of every rank of the sequence-parallel, mlp_dp and
    replicated-fallback cases makes the collectives
    :func:`_declared_counts` works out from the config."""
    jobs, results, _ = mesh_runs
    job = jobs[label]
    cfg = dataclasses.replace(reduced_config(get_config(job["arch"])), **job["cfg"])
    want = _declared_counts(cfg, len(jax.tree.leaves(job["params"])),
                            job["microbatches"], job["remat"])
    for res in results[label]:
        for rec in res["records"]:
            got = {a: {op: c["calls"] for op, c in ops.items()}
                   for a, ops in rec["collectives"].items()}
            assert got == want


@pytest.mark.parametrize("label", ["gemma-2b", "gemma3-4b", "gemma-2b microbatches 2",
                                   *RECURRENT, *FRONTENDS, *OVERRIDES, REMAT_LABEL])
def test_the_declared_count_covers_the_earlier_cases(mesh_runs, label):
    """:func:`_declared_counts` gives the earlier cases, without the
    flags, the counts their steps make (and the earlier declarations
    give)."""
    jobs, results, _ = mesh_runs
    job = jobs[label]
    cfg = dataclasses.replace(reduced_config(get_config(job["arch"])), **job["cfg"])
    want = _declared_counts(cfg, len(jax.tree.leaves(job["params"])),
                            job["microbatches"], job["remat"])
    for res in results[label]:
        got = {a: {op: c["calls"] for op, c in ops.items()}
               for a, ops in res["records"][0]["collectives"].items()}
        assert got == want


def test_seq_parallel_on_a_model_axis_of_one_rank_changes_nothing(mesh_runs):
    """On (pod, data, model) = (2, 2, 1) ``seq_parallel`` splits nothing:
    the losses, the collectives and the final parameters are those of the
    run without it, bit for bit."""
    _, results, _ = mesh_runs
    for res, plain in zip(results["gemma-2b seq_parallel pod data"],
                          results["gemma-2b pod data"]):
        assert res["losses"] == plain["losses"]
        assert [r["collectives"] for r in res["records"]] == \
            [r["collectives"] for r in plain["records"]]
        if res["lead"]:
            for (path, a), (_, b) in zip(_flat(res["params"]), _flat(plain["params"])):
                assert np.array_equal(a, b), path


@pytest.mark.parametrize("arch,changes", [
    ("gemma-2b", dict(SP, mlp_dp=True)), ("command-r-35b", SP),
    ("hymba-1.5b", dict(SP, mlp_dp=True)), ("whisper-base", dict(SP, mlp_dp=True)),
    ("xlstm-1.3b", SP), ("phi-3-vision-4.2b", dict(SP, mlp_dp=True)),
    ("grok-1-314b", dict(SP, mlp_dp=True))])
def test_the_flags_change_nothing_without_a_mesh(arch, changes):
    """On one process (no mesh) ``seq_parallel`` and ``mlp_dp`` leave the
    loss and every gradient bit-equal to a run without them, as the
    reference's ``constrain`` without a mesh is the identity."""
    import torch
    from repro_torch.launch.train import step_embeds
    from repro_torch.models import Model, init_params
    from repro_torch.training.train_step import value_and_grad
    cfg = reduced_config(get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16))).int()
    batch = {"tokens": tokens, **step_embeds(cfg, 0, 2, "cpu")}
    got = [value_and_grad(Model(c).loss, params, batch)
           for c in (cfg, dataclasses.replace(cfg, **changes))]
    assert torch.equal(got[0][0], got[1][0])
    for (path, a), (_, b) in zip(_flat(got[0][1]), _flat(got[1][1])):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("mesh_name", ["tiny", "multi"])
@pytest.mark.parametrize("arch", PORTED)
def test_mlp_dp_placements_equal_the_references_on_every_leaf(arch, mesh_name):
    """spec_tree with ``mlp_dp`` (the dense FFN replicated over ``model``)
    equals the reference's on every leaf of the config at full shapes."""
    jcfg, shapes = _ref_shapes(arch)
    mesh = named_mesh_layout(mesh_name)
    want = dict(_flat(j_sharding.spec_tree(shapes, mesh, jcfg.expert_sharding,
                                           mlp_dp=True)))
    got = dict(_flat(sharding.spec_tree(param_shapes(get_config(arch)), mesh,
                                        jcfg.expert_sharding, mlp_dp=True)))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path] == tuple(want[path]), path


class FakeMesh2:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}


class FakePodMesh1:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 2, "model": 1}


@pytest.mark.parametrize("changes,mesh_cls,want", [
    # no flag: only the data axes, as before
    ({}, FakeMesh2, {"final_norm/scale": ("data",),
                     "stages/s0/stk_norm1_scale": ("data",),
                     "stages/s0/stk_w_up": ("data",), "stages/s0/stk_wq": ("data",),
                     "embed": ("data",)}),
    # seq_parallel: the norms also over model; the split FFN and
    # projections, and the embedding, whole already
    (SP, FakeMesh2, {"final_norm/scale": ("data", "model"),
                     "stages/s0/stk_norm1_scale": ("data", "model"),
                     "stages/s0/stk_norm2_scale": ("data", "model"),
                     "stages/s0/stk_w_up": ("data",), "stages/s0/stk_wq": ("data",),
                     "embed": ("data",)}),
    # mlp_dp alone: the replicated FFN over model, the norms not
    ({"mlp_dp": True}, FakeMesh2, {"final_norm/scale": ("data",),
                                   "stages/s0/stk_w_up": ("data", "model"),
                                   "stages/s0/stk_w_gate": ("data", "model"),
                                   "stages/s0/stk_w_down": ("data", "model"),
                                   "stages/s0/stk_wq": ("data",)}),
    (dict(SP, mlp_dp=True), FakeMesh2, {"final_norm/scale": ("data", "model"),
                                        "stages/s0/stk_w_down": ("data", "model"),
                                        "stages/s0/stk_wo": ("data",)}),
    # a d_ff the axis does not divide: whole without seq_parallel, the
    # rank's rows with it
    ({"d_ff": 129}, FakeMesh2, {"stages/s0/stk_w_up": ("data",),
                                "stages/s0/stk_norm1_scale": ("data",)}),
    (dict(SP, d_ff=129), FakeMesh2, {"stages/s0/stk_w_up": ("data", "model"),
                                     "stages/s0/stk_norm1_scale": ("data", "model")}),
    # a model axis of one rank: the flags sum nothing over it
    (dict(SP, mlp_dp=True), FakePodMesh1, {
        "final_norm/scale": ("pod", "data"), "stages/s0/stk_w_up": ("pod", "data")}),
])
def test_grad_sum_axes_follow_the_placement_and_the_flags(changes, mesh_cls, want):
    """The axes each gradient leaf is summed over before the clip
    (``training.train_step.grad_sum_axes``), from the placement and the
    config on meshes with no ranks: the data axes a leaf is not split over,
    and ``model`` for a replicated leaf a rank computes with on its own rows
    only."""
    from repro_torch.training.train_step import grad_sum_axes, _leaf_paths
    cfg = dataclasses.replace(reduced_config(get_config("gemma-2b")), **changes)
    mesh = mesh_cls()
    specs = sharding.spec_tree(param_shapes(cfg), mesh, cfg.expert_sharding, cfg.mlp_dp)
    got = dict(zip(_leaf_paths(specs), grad_sum_axes(cfg, specs, mesh)))
    assert sorted(got) == sorted(p for p, _ in _flat(specs))
    for path, axes in want.items():
        assert got[path] == axes, path


# ---------------------------------------------------------------------------
# checkpoints, refusals, the driver
# ---------------------------------------------------------------------------

def test_a_mesh_checkpoint_restores_in_the_reference_without_a_mesh(mesh_runs):
    """The lead rank writes the global arrays at step 2; the reference,
    without a mesh, restores them and its step 3 gives the mesh's loss."""
    jobs, results, _ = mesh_runs
    lead = next(r for r in results["ckpt"] if r["lead"])
    jcfg, jp = _ref_params("gemma-2b", seed=3)       # other weights
    jtcfg = JTrainConfig(total_steps=STEPS, remat="none", **TCFG)
    ref = JTrainingRunner(JRunnerConfig(jobs["ckpt"]["ckpt_dir"], checkpoint_every=100),
                          jax.jit(j_make_train_step(JModel(jcfg), jtcfg)), jp,
                          j_adamw_init(jp), _batch_fn(jcfg, 4))
    assert ref.maybe_restore() == 2
    ref.run(1)
    np.testing.assert_allclose(ref.metrics_log[0]["loss"], lead["losses"][2], rtol=1e-5)
    want, _ = _ref("gemma-2b")
    np.testing.assert_allclose(lead["losses"], want, rtol=1e-5)


def test_the_references_checkpoint_restores_on_the_mesh(mesh_runs):
    """A checkpoint the reference wrote without a mesh restores on the mesh
    (each rank its blocks) and step 3 follows as on the reference's mesh."""
    _, results, _ = mesh_runs
    want_losses, want_params = _ref("gemma-2b")
    for res in results["restore"]:
        assert res["resumed"] == 2 and res["final"] == 3
        np.testing.assert_allclose(res["losses"], want_losses[2:], rtol=1e-5)
    lead = next(r for r in results["restore"] if r["lead"])
    for path, want in _flat(want_params):
        np.testing.assert_allclose(dict(_flat(lead["params"]))[path],
                                   want.astype(np.float32), atol=1e-4, err_msg=path)


@pytest.mark.parametrize("label,match", [
    ("single", r"ValueError: mesh 'single' \(16, 16\) needs 256 ranks; the "
               r"process group has 4"),
])
def test_mesh_refusals(mesh_runs, label, match):
    _, results, _ = mesh_runs
    for res in results[label]:
        assert re.search(match, res["error"]), res


def _masked(text):
    """A launcher's output with the times and losses left out (each package
    draws its own random weights)."""
    text = re.sub(r"in \d+\.\ds", "in Ts", text)
    return re.sub(r"loss \d+\.\d+ -> \d+\.\d+", "loss A -> B", text).splitlines()


@pytest.mark.parametrize("arch", RECURRENT)
def test_launch_train_mesh_trains_the_recurrent_kinds(mesh_runs, arch):
    """``launch.train --arch <recurrent> --reduced --mesh tiny --remat full``
    on 4 gloo ranks prints the reference launcher's ``[train]`` line (the
    reference's run on its tiny mesh of 4 host devices)."""
    _, _, drivers = mesh_runs
    for name in (f"port {arch}", f"reference {arch}"):
        assert drivers[name][0] == 0, (name, drivers[name][2][-2000:])
    assert _masked(drivers[f"port {arch}"][1]) == \
        _masked(drivers[f"reference {arch}"][1]) == [
            f"[train] {arch} steps 0->3 in Ts; loss A -> B"]


def test_launch_train_flags_give_the_same_training(mesh_runs):
    """``launch.train --mesh tiny --seq-parallel --mlp-dp`` trains the same
    model from the same seed as the run without the flags: the ``[train]``
    line is the same, losses included (to their printed 3 decimals)."""
    _, _, drivers = mesh_runs
    rc, out, err = drivers["port flags"]
    assert rc == 0, err[-2000:]
    assert re.sub(r"in \d+\.\ds", "in Ts", out) == \
        re.sub(r"in \d+\.\ds", "in Ts", drivers["port"][1])


@pytest.mark.parametrize("arch", FRONTENDS)
def test_launch_train_mesh_trains_the_frontends(mesh_runs, arch):
    """``launch.train --arch whisper-base|phi-3-vision-4.2b --reduced --mesh
    tiny`` on 4 gloo ranks trains with each step's frame or image
    embeddings (``launch.train.step_embeds``) and prints the ``[train]``
    line (the reference's launcher feeds tokens only, so there is no line
    of its to compare)."""
    _, _, drivers = mesh_runs
    rc, out, err = drivers[f"port {arch}"]
    assert rc == 0, err[-2000:]
    assert _masked(out) == [f"[train] {arch} steps 0->3 in Ts; loss A -> B"]


def test_launch_train_mesh_prints_the_references_line(mesh_runs, tmp_path,
                                                     monkeypatch):
    """``launch.train --mesh tiny --dist-backend gloo --device cpu`` on 4
    ranks prints the reference driver's ``[train]`` line (times and losses
    left out: each package draws its own random weights); a MoE config on
    a mesh of two data axes is taken and asks for the mesh's ranks (the
    multi-pod mesh's 512: the start of the ranks is stubbed here)."""
    from repro_torch.launch import mesh as port_mesh
    _, _, drivers = mesh_runs
    for name, (rc, _, err) in drivers.items():
        assert rc == 0, (name, err[-2000:])
    assert _masked(drivers["port"][1]) == _masked(drivers["reference"][1]) == [
        "[train] gemma-2b steps 0->3 in Ts; loss A -> B"]
    asked = []

    def no_ranks(fn, world, **kw):
        asked.append((world, kw["args"][0][0]["mesh"]))
        raise RuntimeError("not started")
    monkeypatch.setattr(port_mesh, "run_ranks", no_ranks)
    with pytest.raises(RuntimeError, match="not started"):
        train.main(["--arch", "grok-1-314b", "--reduced", "--mesh", "multi",
                    "--device", "cpu", "--dist-backend", "gloo",
                    "--ckpt-dir", str(tmp_path / "g")])
    assert asked == [(512, "multi")]
