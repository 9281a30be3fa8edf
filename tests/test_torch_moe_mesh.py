"""The port's mixture of experts on the reference's ``tiny`` mesh,
``("data", "model") = (2, 2)``, against the JAX package's GSPMD runs, on
the CPU: grok-1 (``expert_sharding="tp2d"``: every expert on every rank,
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
an odd one (the group count halves to 1), and ``moe_dispatch="global"``.
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
from repro.launch.mesh import make_mesh_named as j_make_mesh_named
from repro.models import Model as JModel
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro.training import RunnerConfig as JRunnerConfig
from repro.training import TrainingRunner as JTrainingRunner
from repro.training import adamw_init as j_adamw_init
from repro.training import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.launch.mesh import named_mesh_layout, run_ranks
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
                                         {"moe_dispatch": "global"}))])


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


def _ref_mesh_step(jcfg):
    """The reference driver's jitted step under its tiny-mesh placements."""
    mesh = j_make_mesh_named("tiny")
    tcfg = JTrainConfig(total_steps=STEPS, remat="none", **TCFG)
    step = j_make_train_step(JModel(jcfg), tcfg)
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    pshard = j_sharding.sharding_tree(shapes, mesh, jcfg.expert_sharding)
    return jax.jit(step, in_shardings=(pshard, None, None),
                   out_shardings=(pshard, None, None)), pshard


def _ref_train(arch, batch, seq, changes):
    """3 steps of the reference on its tiny mesh: (losses, final params)."""
    jcfg, jp = _ref_params(arch, changes)
    j_sharding.set_mesh(j_make_mesh_named("tiny"))
    try:
        step, pshard = _ref_mesh_step(jcfg)
        params, opt = jax.device_put(jp, pshard), j_adamw_init(jp)
        fn, losses = _batch_fn(jcfg, batch, seq), []
        for i in range(STEPS):
            params, opt, m = step(params, opt, fn(i))
            losses.append(float(m["loss"]))
        return losses, _np(params)
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


def _ref_layer(arch, layer, batch, seq, changes):
    """The reference's ``moe`` on its tiny mesh, forward and the gradient
    of ``sum(out * dout) + aux_loss``."""
    jcfg, lp, x, dout = _layer_inputs(arch, layer, batch, seq, changes)
    placement = (None if jcfg.expert_placement == "default"
                 else jnp.asarray(j_moe.expert_placement(jcfg)))
    j_sharding.set_mesh(j_make_mesh_named("tiny"))
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
               ckpt_dir=str(ckpt_dir), gather=True)
    job.update(kw)
    return job


_REF = {}


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
        train_refs = {c[0]: pool.submit(_ref_train, *c[1:]) for c in TRAIN_CASES}
        layer_refs = {c[0]: pool.submit(_ref_layer, *c[1:]) for c in LAYER_CASES}
        jobs = {c[0]: _train_job(*c[1:], root / c[0].replace(" ", "_"))
                for c in TRAIN_CASES}
        for label, arch, layer, b, s, changes in LAYER_CASES:
            jcfg, lp, x, dout = _layer_inputs(arch, layer, b, s, changes)
            jobs[label] = dict(kind="moe", mesh="tiny", arch=arch, reduced=True,
                               cfg=changes, layer=lp, x=x, dout=dout)
        # grok: 2 steps with a checkpoint at 2, then step 3 in memory
        jobs["ckpt"] = _train_job(GROK, 4, 16, {}, root / "torch", steps=2,
                                  ckpt_every=2, then=1,
                                  tcfg=dict(TCFG, total_steps=STEPS))
        jobs["micro"] = dict(_train_job(GROK, 4, 16, {}, root / "micro"),
                             microbatches=2)
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
    want_losses, want_params = _REF[label]
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
        rows = slice(None) if res["whole"] else slice(
            res["data"] * batch // 2, (res["data"] + 1) * batch // 2)
        assert res["whole"] == (batch % 2 == 1)
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
    want, _ = _REF["grok tp2d"]
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


def test_moe_microbatches_on_a_mesh_are_refused(runs):
    _, results = runs
    for res in results["micro"]:
        assert "NotImplementedError" in res["error"] and "12h" in res["error"], res


def _per_step_counts(cfg):
    """The collectives of one MoE train step on a rank of the tiny mesh
    (the count chip_smoke.py declares): on ``model`` the embedding's, two
    a layer forward and backward (attention's and the MLP's or the
    experts'), the loss's, and the global norm's two (the leaves split over
    ``model`` alone, and over both axes); on ``data`` the mask count and
    the loss, two a MoE layer (the top-1 counts, the aux loss), every leaf
    its placement does not split over ``data``, and the norm's; and the
    experts' exchanges over ``data``: two all-to-alls forward and two
    backward (``ep``), or a gather and a reduce-scatter forward and their
    conjugates backward (``tp2d``)."""
    from repro_torch.dist.sharding import spec_tree
    layers = sum(n for _, n in stages_meta(cfg))
    n_moe = sum(n for kind, n in stages_meta(cfg) if kind.endswith("+moe"))
    specs = tree_leaves(spec_tree(param_shapes(cfg), named_mesh_layout("tiny"),
                                  cfg.expert_sharding))
    summed = sum("data" not in {a for e in sp for a in (e if isinstance(e, tuple)
                                                        else (e,))} for sp in specs)
    data = {"all_reduce": 2 + 2 * n_moe + summed + 1}
    if cfg.expert_sharding == "tp2d":
        data.update(all_gather=2 * n_moe, reduce_scatter=2 * n_moe)
    else:
        data.update(all_to_all=4 * n_moe)
    return {"data": data,
            "model": {"all_reduce": 1 + 4 * layers + 1 + 1 + 2, "all_reduce_max": 1}}


def test_moe_step_collectives_are_the_declared_count(runs):
    """Every step of every rank makes the declared collectives."""
    jobs, results = runs
    for label in ("grok tp2d", "llama4 ep"):
        want = _per_step_counts(reduced_config(get_config(jobs[label]["arch"])))
        for res in results[label]:
            for rec in res["records"]:
                got = {a: {op: c["calls"] for op, c in ops.items()}
                       for a, ops in rec["collectives"].items()}
                assert got == want, label


@pytest.mark.parametrize("arch", [GROK, LLAMA4])
def test_check_mesh_takes_a_mixture_of_experts_and_keeps_the_other_refusals(arch):
    cfg = get_config(arch)
    check_mesh(cfg, named_mesh_layout("tiny"))
    Model(reduced_config(cfg))
    with pytest.raises(NotImplementedError, match="seq_parallel.*12h"):
        check_mesh(dataclasses.replace(cfg, seq_parallel=True), named_mesh_layout("tiny"))
    with pytest.raises(NotImplementedError, match="data axes.*12h"):
        check_mesh(cfg, named_mesh_layout("multi"))
