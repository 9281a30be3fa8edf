"""The port's mixture of experts on the reference's ``tiny`` mesh,
``("data", "model") = (2, 2)``, and on a mesh of two data axes,
``("pod", "data", "model") = (2, 2, 1)``, against the JAX package's GSPMD
runs, on the CPU: grok-1 (``expert_sharding="tp2d"``: every expert on every rank,
d_ff over (data, model)) and llama4-maverick (``"ep"``: experts over
``data``, d_ff over ``model``, greedy placement), both at ``reduced_config``
width in float32.

One module-scoped start of 4 gloo ranks (``launch.mesh.run_ranks``) runs
every job (``launch.mesh_runs``' ``train`` and ``moe`` kinds); the
reference's runs go meanwhile to a pool of spawned processes on the
conftest's 4 host devices, from the same weights (the reference's
``init_params``, carried over as numpy).  Cases: a batch the data axis
splits (one routing group a data rank, the all-to-all), a batch it does not
split with an even token count (each data rank holds every group: 2) and
an odd one (the group count halves to 1), and ``moe_dispatch="global"``;
then two microbatches (each the reference's global rows, split over the
data ranks, or whole on each when they do not divide it: B = 6), the
(2, 2, 1) mesh (4 groups: a split batch, a whole one and ``global``),
both together, and ``seq_parallel`` (grok; llama4 with ``mlp_dp`` too).  Each of those new cases can tell groupings apart: the
reference drops entries in at least one of its layers (grok at a capacity
factor of 0.5), so another grouping gives other drops, and the port's top-1
counts and dropped shares of every MoE call equal the reference's.
Tolerances, each with its reason:

* each step's loss within 1e-5 relative, the gathered parameters after 3
  steps within 1e-4 absolute: float32 sums in other orders, carried
  through AdamW at a rate of 1e-3 (as ``test_torch_mesh_training.py``);
* one MoE layer's output and its input's gradient within 1e-5 absolute,
  its weights' gradients within 1e-5 relative and absolute (float32
  products and sums in other orders; the router's sums over every token
  reach 21), its aux loss within 1e-6 relative;
* each layer's ``expert_load`` and ``dropped_frac`` from the same routing
  of the same groups: the top-1 counts (``expert_load`` times the token
  count) exactly, the shares within 1e-7 (XLA divides by a token count
  as a product with its float32 reciprocal);
* checkpoints that cross between the packages give the other's next loss
  within 1e-5 relative.
"""

import contextlib
import dataclasses
import multiprocessing as mp
import shutil
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.configs.reduced import reduced_config as j_reduced
from repro.data import TokenPipeline as JTokenPipeline
from repro.dist import sharding as j_sharding
from repro.dist.compat import make_mesh as j_make_mesh
from repro.launch.mesh import make_mesh_named as j_make_mesh_named
from repro.models import Model as JModel
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro.models import transformer as j_transformer
from repro.training import RunnerConfig as JRunnerConfig
from repro.training import TrainingRunner as JTrainingRunner
from repro.training import adamw_init as j_adamw_init
from repro.training import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.launch.mesh import mesh_layout, named_mesh_layout, run_ranks
from repro_torch.launch.mesh_runs import run_jobs
from repro_torch.models import Model
from repro_torch.models.convert import param_shapes
from repro_torch.models.moe import _n_groups
from repro_torch.models.transformer import check_mesh, stages_meta
from repro_torch.training.optimizer import tree_leaves

GROK, LLAMA4 = "grok-1-314b", "llama4-maverick-400b-a17b"
STEPS = 3
TCFG = dict(learning_rate=1e-3, warmup_steps=1)
# (label, arch, batch, seq, config changes)
TRAIN_CASES = [("grok tp2d", GROK, 4, 16, {}),
               ("llama4 ep", LLAMA4, 4, 16, {}),
               ("llama4 global", LLAMA4, 4, 16, {"moe_dispatch": "global"}),
               ("grok global", GROK, 4, 16, {"moe_dispatch": "global"}),
               ("grok batch 3 seq 15 (1 group)", GROK, 3, 15, {}),
               ("llama4 batch 3 seq 16 (2 groups)", LLAMA4, 3, 16, {})]
# the mesh of two data axes, (pod, data, model) = (2, 2, 1), as a train or
# moe job names it
POD = ((2, 2, 1), ("pod", "data", "model"))
# grok drops too little at its own capacity factor for every grouping to show
LOW = {"capacity_factor": 0.5}
# (label, arch, batch, seq, config changes, microbatches, mesh): the cases
# of microbatches and of two data axes, each of which must tell groupings
# apart
GROUPED_CASES = [
    ("grok microbatches 2", GROK, 4, 16, LOW, 2, "tiny"),
    ("llama4 microbatches 2", LLAMA4, 4, 16, {}, 2, "tiny"),
    ("grok microbatches 2 batch 6 (whole)", GROK, 6, 16, LOW, 2, "tiny"),
    ("llama4 microbatches 2 batch 6 (whole)", LLAMA4, 6, 16, {}, 2, "tiny"),
    ("grok pod data", GROK, 4, 16, LOW, 1, POD),
    ("llama4 pod data", LLAMA4, 4, 16, {}, 1, POD),
    ("grok pod data batch 6 (whole)", GROK, 6, 16, LOW, 1, POD),
    ("llama4 pod data batch 6 (whole)", LLAMA4, 6, 16, {}, 1, POD),
    ("grok pod data global", GROK, 4, 16, dict(LOW, moe_dispatch="global"), 1, POD),
    ("llama4 pod data global", LLAMA4, 4, 16, {"moe_dispatch": "global"}, 1, POD),
    ("llama4 pod data microbatches 2", LLAMA4, 8, 16, {}, 2, POD),
    # sequence parallelism: each MoE layer gathers its data shard's
    # sequence whole, so the groups (and the drops) are the plain mesh's
    ("grok seq_parallel", GROK, 4, 16, dict(LOW, seq_parallel=True), 1, "tiny"),
    ("llama4 seq_parallel mlp_dp", LLAMA4, 4, 16,
     {"seq_parallel": True, "mlp_dp": True}, 1, "tiny")]
TRAIN_CASES += [c[:5] for c in GROUPED_CASES]
MICRO = {c[0]: c[5] for c in GROUPED_CASES}
MESH = {c[0]: c[6] for c in GROUPED_CASES}
# (label, arch, MoE layer, batch, seq, config changes): every MoE layer of
# both configs on a split batch, then the whole-batch and global cases
LAYER_CASES = ([(f"{a} layer {i}", a, i, 4, 16, {})
                for a, n in ((GROK, 4), (LLAMA4, 2)) for i in range(n)] +
               [(f"{a} {label}", a, 0, b, s, ch)
                for a in (GROK, LLAMA4)
                for label, b, s, ch in (("batch 3 seq 15", 3, 15, {}),
                                        ("batch 3 seq 16", 3, 16, {}),
                                        ("global", 4, 16, {"moe_dispatch": "global"}),
                                        ("global batch 3", 3, 16,
                                         {"moe_dispatch": "global"}))] +
               [("grok pod data layer 0", GROK, 0, 4, 16, LOW),
                ("llama4 pod data layer 0", LLAMA4, 0, 4, 16, {}),
                ("llama4 pod data batch 3 seq 16", LLAMA4, 0, 3, 16, {})])
MESH.update({c[0]: POD for c in LAYER_CASES[-3:]})


def _jcfg(arch, changes):
    return dataclasses.replace(j_reduced(j_get_config(arch)), **changes)


def _ref_params(arch, changes, seed=0):
    jcfg = _jcfg(arch, changes)
    return jcfg, j_init_params(jax.random.PRNGKey(seed), jcfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _batch_fn(jcfg, batch, seq):
    pipe = JTokenPipeline(jcfg.vocab_size, batch=batch, seq_len=seq, seed=0)
    return lambda i: {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}


def _ref_mesh(spec):
    """The reference's mesh of a job's ``mesh``: a name or (shape, axes)."""
    return (j_make_mesh_named(spec) if isinstance(spec, str)
            else j_make_mesh(*spec))


@contextlib.contextmanager
def _ref_moe_calls():
    """Yields a list that gets each reference MoE call's ``(dropped_frac,
    expert_load)`` as numpy while the block runs (a ``jax.debug.callback``
    in a wrapper of the reference's ``moe``, traced by the jits made
    meanwhile)."""
    seen, real = [], j_transformer.moe

    def recorded(*args, **kwargs):
        out, aux = real(*args, **kwargs)
        jax.debug.callback(lambda d, load: seen.append((float(d), np.array(load))),
                           aux["dropped_frac"], aux["expert_load"])
        return out, aux
    j_transformer.moe = recorded
    try:
        yield seen
        jax.effects_barrier()
    finally:
        j_transformer.moe = real


def _ref_mesh_step(jcfg, microbatches=1, mesh="tiny"):
    """The reference launcher's jitted step under its mesh placements."""
    mesh = _ref_mesh(mesh)
    tcfg = JTrainConfig(total_steps=STEPS, remat="none",
                        microbatches=microbatches, **TCFG)
    step = j_make_train_step(JModel(jcfg), tcfg)
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    pshard = j_sharding.sharding_tree(shapes, mesh, jcfg.expert_sharding,
                                      jcfg.mlp_dp)
    return jax.jit(step, in_shardings=(pshard, None, None),
                   out_shardings=(pshard, None, None)), pshard


def _ref_train(arch, batch, seq, changes, microbatches=1, mesh="tiny"):
    """3 steps of the reference on its mesh: (losses, final params, each
    MoE call's ``(dropped_frac, expert_load)``)."""
    jcfg, jp = _ref_params(arch, changes)
    j_sharding.set_mesh(_ref_mesh(mesh))
    try:
        with _ref_moe_calls() as calls:
            step, pshard = _ref_mesh_step(jcfg, microbatches, mesh)
            params, opt = jax.device_put(jp, pshard), j_adamw_init(jp)
            fn, losses = _batch_fn(jcfg, batch, seq), []
            for i in range(STEPS):
                params, opt, m = step(params, opt, fn(i))
                losses.append(float(m["loss"]))
        return losses, _np(params), calls
    finally:
        j_sharding.reset_mesh()


def _ref_runner(arch, directory, steps, seed):
    """The reference's TrainingRunner on its tiny mesh in ``directory``
    (a checkpoint every 2 steps; it restores one it finds there): its
    losses over ``steps`` more steps and the step it resumed from."""
    from repro.training import latest_step
    jcfg, jp = _ref_params(arch, {}, seed)
    j_sharding.set_mesh(j_make_mesh_named("tiny"))
    try:
        step, _ = _ref_mesh_step(jcfg)
        runner = JTrainingRunner(JRunnerConfig(directory, checkpoint_every=2),
                                 step, jp, j_adamw_init(jp), _batch_fn(jcfg, 4, 16))
        resumed = latest_step(directory) or 0
        runner.run(steps)
        return [float(m["loss"]) for m in runner.metrics_log], resumed
    finally:
        j_sharding.reset_mesh()


def _layer_inputs(arch, layer, batch, seq, changes):
    """The reference's weights of MoE layer ``layer`` (keys without
    ``stk_``), and numpy x and output weights."""
    jcfg, jp = _ref_params(arch, changes)
    moe_stages = [f"s{i}" for i, (kind, _) in enumerate(stages_meta(jcfg))
                  if kind.endswith("+moe")]
    counts = [n for kind, n in stages_meta(jcfg) if kind.endswith("+moe")]
    flat = [(s, j) for s, n in zip(moe_stages, counts) for j in range(n)]
    s, j = flat[layer]
    lp = {k[4:]: np.asarray(v[j]) for k, v in jp["stages"][s].items()
          if k.startswith("stk_router") or k.startswith("stk_experts")}
    rng = np.random.default_rng(100 + layer + batch * seq)
    x = rng.standard_normal((batch, seq, jcfg.d_model)).astype(np.float32)
    dout = rng.standard_normal((batch, seq, jcfg.d_model)).astype(np.float32)
    return jcfg, lp, x, dout


def _ref_layer(arch, layer, batch, seq, changes, mesh="tiny"):
    """The reference's ``moe`` on its mesh, forward and the gradient of
    ``sum(out * dout) + aux_loss``."""
    jcfg, lp, x, dout = _layer_inputs(arch, layer, batch, seq, changes)
    placement = (None if jcfg.expert_placement == "default"
                 else jnp.asarray(j_moe.expert_placement(jcfg)))
    j_sharding.set_mesh(_ref_mesh(mesh))
    try:
        def f(p, x):
            out, aux = j_moe.moe(p, x, jcfg, placement=placement)
            return jnp.sum(out * dout) + aux["aux_loss"], (out, aux)
        (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(lp, jnp.asarray(x))
        return dict(out=np.asarray(out), dx=np.asarray(gx), grads=_np(gp),
                    expert_load=np.asarray(aux["expert_load"]),
                    dropped_frac=float(aux["dropped_frac"]),
                    aux_loss=float(aux["aux_loss"]))
    finally:
        j_sharding.reset_mesh()


def _train_job(arch, batch, seq, changes, ckpt_dir, **kw):
    _, jp = _ref_params(arch, changes)
    job = dict(kind="train", mesh="tiny", arch=arch, reduced=True, cfg=changes,
               steps=STEPS, batch=batch, seq=seq, tcfg=TCFG, params=_np(jp),
               ckpt_dir=str(ckpt_dir), gather=True, moe_stats=True)
    job.update(kw)
    return job


_REF = {}


def _dirname(label):
    return "".join(c if c.isalnum() else "_" for c in label)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port job in one start of 4 gloo ranks, the reference's runs in
    3 spawned processes meanwhile; returns (jobs, per-rank results) by
    label."""
    root = tmp_path_factory.mktemp("moe_mesh")
    pool = ProcessPoolExecutor(3, mp_context=mp.get_context("spawn"))
    try:
        # a checkpoint the reference writes on its mesh at step 2 (llama4)
        jdir = str(root / "jax")
        ref_ckpt = pool.submit(_ref_runner, LLAMA4, jdir, 2, 0)
        train_refs = {c[0]: pool.submit(_ref_train, *c[1:], MICRO.get(c[0], 1),
                                        MESH.get(c[0], "tiny"))
                      for c in TRAIN_CASES}
        layer_refs = {c[0]: pool.submit(_ref_layer, *c[1:], MESH.get(c[0], "tiny"))
                      for c in LAYER_CASES}
        jobs = {c[0]: _train_job(*c[1:], root / _dirname(c[0]),
                                 microbatches=MICRO.get(c[0], 1),
                                 mesh=MESH.get(c[0], "tiny"))
                for c in TRAIN_CASES}
        for label, arch, layer, b, s, changes in LAYER_CASES:
            jcfg, lp, x, dout = _layer_inputs(arch, layer, b, s, changes)
            jobs[label] = dict(kind="moe", mesh=MESH.get(label, "tiny"), arch=arch,
                               reduced=True, cfg=changes, layer=lp, x=x, dout=dout)
        # grok: 2 steps with a checkpoint at 2, then step 3 in memory
        jobs["ckpt"] = _train_job(GROK, 4, 16, {}, root / "torch", steps=2,
                                  ckpt_every=2, then=1,
                                  tcfg=dict(TCFG, total_steps=STEPS))
        ref_ckpt.result()
        # the reference's llama4 checkpoint restored on the port's mesh (a
        # copy: each runner writes its own step 3) and on the reference's
        shutil.copytree(jdir, root / "jax_copy")
        ref_cont = pool.submit(_ref_runner, LLAMA4, jdir, 1, 0)
        jobs["restore"] = _train_job(LLAMA4, 4, 16, {}, root / "jax_copy", steps=1,
                                     params=None, seed=5,
                                     tcfg=dict(TCFG, total_steps=STEPS))
        labels = list(jobs)
        first = run_ranks(run_jobs, 4, backend="gloo", device="cpu",
                          args=([jobs[k] for k in labels],), timeout=600)
        # the port's grok checkpoint restored on the reference's mesh
        from_port = pool.submit(_ref_runner, GROK, jobs["ckpt"]["ckpt_dir"], 1, 3)
        _REF.update({k: f.result() for k, f in train_refs.items()})
        _REF.update({k: f.result() for k, f in layer_refs.items()})
        _REF["from port"] = from_port.result()
        _REF["jax ckpt"] = ref_cont.result()
    finally:
        pool.shutdown(cancel_futures=True)
    results = {k: [r[i] for r in first] for i, k in enumerate(labels)}
    return jobs, results


@pytest.mark.parametrize("label,arch,batch,seq,changes", TRAIN_CASES)
def test_moe_training_matches_the_references_mesh(runs, label, arch, batch, seq,
                                                  changes):
    _, results = runs
    want_losses, want_params, _ = _REF[label]
    per_rank = results[label]
    for res in per_rank:
        assert "error" not in res, res
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-5)
        assert res["losses"] == per_rank[0]["losses"]
    lead = [r for r in per_rank if r["lead"]]
    assert len(lead) == 1
    got, want = dict(_flat(lead[0]["params"])), dict(_flat(want_params))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path].astype(np.float32),
                                   rtol=0, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("label,arch,layer,batch,seq,changes", LAYER_CASES)
def test_moe_layer_matches_the_references_mesh(runs, label, arch, layer, batch,
                                               seq, changes):
    """One MoE layer on the mesh: each rank's output block and input
    gradient, the gathered weight gradients, and the layer's expert load,
    dropped share and aux loss against the reference's GSPMD layer."""
    _, results = runs
    want = _REF[label]
    per_rank = results[label]
    for res in per_rank:
        assert "error" not in res, res
        nd = res["n_data"]
        rows = slice(None) if res["whole"] else slice(
            res["data"] * batch // nd, (res["data"] + 1) * batch // nd)
        assert nd == (2 if MESH.get(label, "tiny") == "tiny" else 4)
        assert res["whole"] == (batch % nd != 0)
        np.testing.assert_allclose(res["out"], want["out"][rows], rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["dx"], want["dx"][rows], rtol=0, atol=1e-5)
        tokens = batch * seq
        assert np.array_equal(np.rint(res["expert_load"] * tokens),
                              np.rint(want["expert_load"] * tokens))
        np.testing.assert_allclose(res["expert_load"], want["expert_load"],
                                   rtol=0, atol=1e-7)
        assert abs(res["dropped_frac"] - want["dropped_frac"]) <= 1e-7
        np.testing.assert_allclose(res["aux_loss"], want["aux_loss"], rtol=1e-6)
    lead = [r for r in per_rank if r["grads"] is not None]
    assert len(lead) == 1
    for name, g in want["grads"].items():
        np.testing.assert_allclose(lead[0]["grads"][name], g, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("mesh_name,n_data", [("tiny", 2), ("single", 16)])
def test_the_groups_halve_when_the_data_axis_does_not_divide_the_tokens(
        mesh_name, n_data):
    """The port's routing groups are the reference's ``_n_groups`` under
    its mesh (the data axes' size halved until it divides the tokens)."""
    from repro.launch import mesh as jm
    layout = named_mesh_layout(mesh_name)
    j_sharding.set_mesh(layout if mesh_name != "tiny" else jm.make_mesh_named("tiny"))
    try:
        for tokens in (1, 3, 6, 7, 8, 45, 48, 64, 96, 4096, 4100):
            assert _n_groups(tokens, n_data) == j_moe._n_groups(None, tokens)
    finally:
        j_sharding.reset_mesh()


def test_a_port_moe_checkpoint_restores_on_the_references_mesh(runs):
    """The lead rank writes grok's global arrays at step 2; the reference's
    runner restores them on its mesh and its step 3 gives the port's."""
    _, results = runs
    lead = next(r for r in results["ckpt"] if r["lead"])
    losses, resumed = _REF["from port"]
    assert resumed == 2
    np.testing.assert_allclose(losses[-1], lead["losses"][2], rtol=1e-5)
    want, _, _ = _REF["grok tp2d"]
    np.testing.assert_allclose(lead["losses"], want, rtol=1e-5)


def test_the_references_moe_checkpoint_restores_on_the_mesh(runs):
    """llama4's checkpoint the reference wrote on its mesh at step 2
    restores on the port's mesh (each rank its blocks, the experts split
    over data) and step 3 follows as the reference's does."""
    _, results = runs
    losses, resumed = _REF["jax ckpt"]
    assert resumed == 2
    for res in results["restore"]:
        assert "error" not in res, res
        assert res["resumed"] == 2 and res["final"] == 3
        np.testing.assert_allclose(res["losses"], losses[-1:], rtol=1e-5)


def _calls_by_step(calls, per_step):
    """A run's MoE calls cut into steps, each step's as a sorted list of
    (top-1 counts, dropped share): the reference's callbacks need not come
    in call order within a step."""
    steps = [calls[i:i + per_step] for i in range(0, len(calls), per_step)]
    return [sorted(steps_calls, key=lambda c: (c[0], c[1])) for steps_calls in steps]


@pytest.mark.parametrize("label", [c[0] for c in GROUPED_CASES])
def test_grouped_cases_tell_the_groupings_apart(runs, label):
    """The microbatch and two-data-axis cases: the reference drops entries
    in at least one MoE layer (so a grouping other than its own gives
    other drops and another loss), and every step of every rank routes as
    the reference does: each MoE call's top-1 counts equal exactly, its
    dropped share within 1e-7."""
    jobs, results = runs
    _, arch, batch, seq, changes, m, _ = next(c for c in GROUPED_CASES if c[0] == label)
    _, _, calls = _REF[label]
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    n_moe = sum(n for kind, n in stages_meta(cfg) if kind.endswith("+moe"))
    tokens = batch // m * seq
    assert len(calls) == STEPS * m * n_moe
    assert max(d for d, _ in calls) > 0, calls

    def counted(step_calls):
        return [(tuple(int(c) for c in np.rint(np.asarray(load) * tokens)), d)
                for d, load in step_calls]
    want = _calls_by_step(counted(calls), m * n_moe)
    for res in results[label]:
        got = _calls_by_step(counted([c for rec in res["records"] for c in rec["moe"]]),
                             m * n_moe)
        assert len(got) == len(want) == STEPS
        for g_step, w_step in zip(got, want):
            assert [c for c, _ in g_step] == [c for c, _ in w_step], label
            for (_, dg), (_, dw) in zip(g_step, w_step):
                assert abs(dg - dw) <= 1e-7, (label, dg, dw)


@pytest.mark.parametrize("label", [c[0] for c in LAYER_CASES if c[0] in MESH])
def test_two_data_axis_layer_cases_drop_entries(runs, label):
    """Each MoE layer case on (pod, data, model) = (2, 2, 1) routes 4
    groups: the reference drops entries there, so the tiny mesh's 2 groups
    or one group would give another output."""
    assert _REF[label]["dropped_frac"] > 0, _REF[label]["dropped_frac"]


def _layout(spec):
    return (named_mesh_layout(spec) if isinstance(spec, str)
            else mesh_layout(*spec))


def _per_step_counts(cfg, microbatches=1, mesh="tiny"):
    """The collectives of one MoE train step on a rank of ``mesh`` whose
    data axes split every microbatch (the count chip_smoke.py declares).
    On ``model``, per microbatch, two a layer forward and backward for
    attention and two for its MLP (the experts' only when the axis has
    more than one rank), and the vocab-parallel embedding's, loss sum's
    and hidden gradient's with a loss chunk's max (a vocabulary split over
    more than one rank); then the global norm's.  On each data axis, per
    microbatch, the mask count and the loss, two a MoE layer (the top-1
    counts, the aux loss) and the experts' exchanges: ``ep`` two
    all-to-alls forward and two backward over ``data`` alone, ``tp2d`` a
    gather and a reduce-scatter forward and their conjugates backward over
    each data axis; then one all-gather of the batch's tokens with two
    microbatches or more, every leaf its placement does not split over the
    axis, and the norm's.  The norm all-reduces each set of axes that
    leaves are split over once an axis of it.  Under ``seq_parallel`` each
    tensor-parallel part on ``model`` gathers the sequence in front and
    reduce-scatters after (an all-gather and a reduce-scatter each way for
    its two all-reduces), the embedding reduce-scatters its sum and the
    loss gathers the hidden rows (an all-gather and a reduce-scatter each
    for their two all-reduces), a MoE layer gathers its data shard's
    sequence whole (an all-gather forward, one backward for the cut back to
    the rank's rows), and every norm's leaf and, with ``mlp_dp``, the
    replicated dense FFN's are summed over ``model`` per step; ``mlp_dp``
    runs that FFN on the rank's rows with no collective."""
    from repro_torch.dist.sharding import data_axes, spec_axes, spec_tree
    layout = _layout(mesh)
    m = microbatches
    meta = stages_meta(cfg)
    layers = sum(n for _, n in meta)
    n_moe = sum(n for kind, n in meta if kind.endswith("+moe"))
    tree = spec_tree(param_shapes(cfg), layout, cfg.expert_sharding, cfg.mlp_dp)
    specs = tree_leaves(tree)
    named = [{a for e in sp for a in spec_axes(e)} for sp in specs]
    norm_sets = {tuple(sorted(axes)) for axes in named if axes}
    out = {}
    for a in data_axes(layout):
        per = {"all_reduce": m * (2 + 2 * n_moe)}
        if cfg.expert_sharding == "tp2d":
            per.update(all_gather=m * 2 * n_moe, reduce_scatter=m * 2 * n_moe)
        elif a == "data":
            per["all_to_all"] = m * 4 * n_moe
        if m > 1:
            per["all_gather"] = per.get("all_gather", 0) + 1
        per["all_reduce"] += (sum(a not in axes for axes in named)
                              + sum(a in axes for axes in norm_sets))
        out[a] = per
    size = layout.shape.get("model", 1)
    split_vocab = size > 1 and cfg.vocab_size % size == 0
    experts = 2 * n_moe if size > 1 else 0
    dense = 0 if cfg.mlp_dp else 2 * (layers - n_moe)
    norm = sum("model" in axes for axes in norm_sets)
    sp = cfg.seq_parallel and size > 1
    summed = 0
    if size > 1:
        for (path, _), axes in zip(_flat(tree), named):
            ffn = path.endswith(("w_up", "w_gate", "w_down"))
            summed += "model" not in axes and ((sp and ("norm" in path or ffn))
                                               or (cfg.mlp_dp and ffn))
    if sp:
        tp = 2 * layers + dense + (2 if split_vocab else 0)
        model = {"all_reduce": m * (experts + (1 if split_vocab else 0)) + norm + summed,
                 "all_gather": m * (tp + 2 * n_moe), "reduce_scatter": m * tp}
    else:
        model = {"all_reduce": m * (2 * layers + dense + experts
                                    + (3 if split_vocab else 0)) + norm + summed}
        if cfg.mlp_dp and size > 1:
            model["all_gather"] = m * 2 * (layers - n_moe)
    if split_vocab:
        model["all_reduce_max"] = m
    out["model"] = model
    return out


# the train cases whose every microbatch the data axes split, with their
# declared collectives
COUNTED = ["grok tp2d", "llama4 ep", "grok microbatches 2", "llama4 microbatches 2",
           "grok pod data", "llama4 pod data", "llama4 pod data microbatches 2",
           "grok seq_parallel", "llama4 seq_parallel mlp_dp"]


def test_moe_step_collectives_are_the_declared_count(runs):
    """Every step of every rank makes the declared collectives."""
    jobs, results = runs
    for label in COUNTED:
        job = jobs[label]
        cfg = dataclasses.replace(reduced_config(get_config(job["arch"])), **job["cfg"])
        want = _per_step_counts(cfg, job.get("microbatches", 1), job["mesh"])
        for res in results[label]:
            for rec in res["records"]:
                got = {a: {op: c["calls"] for op, c in ops.items()}
                       for a, ops in rec["collectives"].items()}
                assert got == want, label


@pytest.mark.parametrize("arch", [GROK, LLAMA4])
def test_check_mesh_takes_a_mixture_of_experts_with_every_flag(arch):
    """``check_mesh`` takes both mixtures of experts on the tiny mesh, on
    two data axes (the reference's multi-pod mesh and the (2, 2, 1) one),
    and with ``seq_parallel`` and ``mlp_dp`` (before, it refused the
    flags); ``mlp_dp`` replicates llama4's dense FFN and no expert leaf."""
    cfg = get_config(arch)
    check_mesh(cfg, named_mesh_layout("tiny"))
    Model(reduced_config(cfg))
    check_mesh(cfg, named_mesh_layout("multi"))
    check_mesh(reduced_config(cfg), mesh_layout(*POD))
    check_mesh(dataclasses.replace(cfg, seq_parallel=True), named_mesh_layout("tiny"))
    flagged = dataclasses.replace(cfg, mlp_dp=True, seq_parallel=True)
    check_mesh(flagged, named_mesh_layout("multi"))
    specs = Model(flagged, mesh=named_mesh_layout("tiny")).specs
    plain = Model(cfg, mesh=named_mesh_layout("tiny")).specs
    for s, sp in specs["stages"].items():
        for name, spec in sp.items():
            dense = name in ("stk_w_up", "stk_w_gate", "stk_w_down")
            assert spec == ((None,) * len(spec) if dense else plain["stages"][s][name])


class _FakeMesh:
    """The mesh API ``train_step.microbatches`` reads, for one rank at
    ``coord`` of data axes ``sizes`` (no process group)."""

    def __init__(self, sizes, coord):
        self.mesh_dim_names = tuple(sizes)
        self._sizes, self._coord = dict(sizes), dict(coord)

    def size(self, dim):
        return self._sizes[self.mesh_dim_names[dim]]

    def get_local_rank(self, axis):
        return self._coord[axis]


@pytest.mark.parametrize("sizes,batch,m", [
    ({"data": 2}, 4, 2), ({"data": 2}, 6, 2), ({"pod": 2, "data": 2}, 8, 2),
    ({"pod": 2, "data": 2}, 4, 2), ({"pod": 2, "data": 2}, 6, 2),
    ({"pod": 2, "data": 2}, 16, 4)])
def test_microbatches_are_the_references_global_rows(monkeypatch, sizes, batch, m):
    """Each rank's microbatch ``i`` is its contiguous slice of the global
    rows ``[i B / m, (i + 1) B / m)`` (data rank pod-major), or those rows
    whole, marked, when the data axes do not divide them; the gathers over
    the data axes are stubbed with the global batch's blocks."""
    import torch
    from repro_torch.dist.sharding import batch_spec, shard_tree
    from repro_torch.training import train_step
    glob = torch.arange(batch * 3).reshape(batch, 3)
    n_data = sizes["data"]
    nd = int(np.prod(list(sizes.values())))
    for rank in range(nd):
        coord = dict(zip(sizes, np.unravel_index(rank, tuple(sizes.values()))))
        mesh = _FakeMesh(sizes, {a: int(c) for a, c in coord.items()})

        def gather(t, mesh_, axis, coord=coord):
            blocks = glob.reshape(-1, *t.shape)
            if axis == "data" and "pod" in sizes:     # this pod's data ranks
                p = int(coord["pod"])
                return blocks[p * n_data:(p + 1) * n_data]
            return blocks
        monkeypatch.setattr(train_step.coll, "all_gather", gather)
        spec = batch_spec(batch, mesh)
        whole = spec == (None,)
        block = {"tokens": glob if whole else
                 shard_tree({"t": glob}, mesh, {"t": spec})["t"]}
        if whole:
            block["whole_batch"] = True
        per = batch // m
        for i, micro in enumerate(train_step.microbatches(block, m, mesh)):
            rows = glob[i * per:(i + 1) * per]
            if per % nd:
                assert micro.get("whole_batch") is True
                assert torch.equal(micro["tokens"], rows)
            else:
                assert "whole_batch" not in micro
                part = per // nd
                assert torch.equal(micro["tokens"], rows[rank * part:(rank + 1) * part])
