"""Kill-and-restore of the port's streaming miner at every kill point, on
every backend, and live re-meshing, against the reference package
(``tests/test_faultinject.py``'s checklist), on the CPU.

The contract: crash the miner at any named kill point — mid-append,
mid-evict, between the cached level-2 delta and the deep expansion,
mid-checkpoint-write, pre-replace — restore the newest durable checkpoint,
replay the deterministic stream, and the final window's support map is
bit-exact with a run that never crashed (the reference's ``jnp`` stream).
``ref`` and ``fused`` run in this process on ``device="cpu"``; ``sharded``,
``tidsharded`` and ``grid`` run on gloo ranks of the host, started once per
world size for the module (``launch.mesh_runs`` jobs ``stream_ckpt``,
``stream_restore``, ``resume`` and ``mine``), where the lead rank writes and
every rank restores the step it broadcasts.  Directories cross between the
packages in both directions.  Every comparison is exact.
"""
import functools
import json
import os

import numpy as np
import pytest

from faultinject import ALL_POINTS, CHECKPOINT_POINTS, make_batches
from faultinject import crashed_run as j_crashed_run
from faultinject import stream_run as j_stream_run
from repro.dist.compat import make_mesh
from repro.streaming import StreamConfig as JStreamConfig
from repro.streaming import restore_miner as j_restore_miner

from repro_torch.core import (EclatConfig, latest_mining_checkpoint, mine,
                              support_checksum)
from repro_torch.faults import InjectedFault, clear_kill_hook, set_kill_hook
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.mesh_runs import run_jobs
from repro_torch.streaming import (StreamCheckpointer, StreamConfig,
                                   StreamingMiner, restore_miner)
from repro_torch.training import valid_steps

from test_lineage import make_db

N_ITEMS = 12
KILL_SLIDE = 2
BATCHES = make_batches(4, 24, seed=42, n_items=N_ITEMS)
KW = dict(min_sup=5, n_blocks=3, block_txns=32, bucket_min=16)
# mesh backend -> (StreamConfig backend, shard, grid) on 4 gloo ranks
MESH = {"sharded": ("sharded", "pairs", None),
        "tidsharded": ("tidsharded", "words", None),
        "grid": ("grid", "grid", "2x2")}
MINE_DB = make_db()
MINE_CFG = dict(min_sup=30, variant="v4", p=4)


def _raiser(point):
    def hook(name):
        if name == point:
            raise InjectedFault(point)
    return hook


def stream_run(cfg, batches, *, directory=None, every=1, kill=None):
    """The port's counterpart of ``faultinject.stream_run`` on the host."""
    miner = StreamingMiner(N_ITEMS, cfg, keep_transactions=False, device="cpu")
    ck = StreamCheckpointer(directory, every=every) if directory else None
    res = None
    try:
        for i, batch in enumerate(batches):
            if kill is not None and i == kill[1]:
                set_kill_hook(_raiser(kill[0]))
            res = miner.advance(batch)
            if ck is not None and ck.maybe_save(miner, i + 1):
                ck.wait()
    finally:
        clear_kill_hook()
    return res


def crashed_run(cfg, batches, directory, point, kill_slide, every=1):
    with pytest.raises(InjectedFault):
        stream_run(cfg, batches, directory=directory, every=every,
                   kill=(point, kill_slide))
    steps = valid_steps(directory)
    assert steps, f"no durable checkpoint survived the {point!r} crash"
    return steps[-1]


def resume_run(batches, directory, **kw):
    miner, start = restore_miner(directory, keep_transactions=False,
                                 device="cpu", **kw)
    res = None
    for batch in batches[start:]:
        res = miner.advance(batch)
    return res if res is not None else miner.mine_window()


@functools.lru_cache(maxsize=None)
def _reference():
    """Support map of the reference's uninterrupted ``jnp`` stream."""
    return j_stream_run(N_ITEMS, JStreamConfig(backend="jnp", **KW),
                        BATCHES).support_map()


# ---------------------------------------------------------------------------
# the ranks: one start per world size, every mesh case inside
# ---------------------------------------------------------------------------

JOBS = {4: [], 2: []}
WHERE = {}


def _add(key, world, job):
    WHERE[key] = (world, len(JOBS[world]))
    JOBS[world].append(job)


def _cfg(backend):
    b, shard, _ = MESH[backend]
    return dict(KW, backend=b, shard=shard)


for _b in MESH:
    for _p in ALL_POINTS:
        _d = f"{_b}-{_p.replace(':', '_')}"
        _add(("crash", _b, _p), 4, dict(
            kind="stream_ckpt", n_items=N_ITEMS, batches=BATCHES, directory=_d,
            grid=MESH[_b][2], config=_cfg(_b), kill=(_p, KILL_SLIDE)))
        _add(("restore", _b, _p), 4, dict(
            kind="stream_restore", n_items=N_ITEMS, batches=BATCHES, directory=_d,
            backend=MESH[_b][0], shard=MESH[_b][1], grid=MESH[_b][2],
            config={}, support_map=True))
# live re-meshing
_add(("crash", "tid4"), 4, dict(kind="stream_ckpt", n_items=N_ITEMS,
                                batches=BATCHES, directory="tid4",
                                config=_cfg("tidsharded"),
                                kill=("miner:mid_append", KILL_SLIDE)))
_add(("restore", "tid4->2"), 2, dict(kind="stream_restore", n_items=N_ITEMS,
                                     batches=BATCHES, directory="tid4",
                                     backend="tidsharded", shard="words",
                                     config={}, support_map=True))
_add(("crash", "grid2x2"), 4, dict(kind="stream_ckpt", n_items=N_ITEMS,
                                   batches=BATCHES, directory="grid2x2", grid="2x2",
                                   config=_cfg("grid"),
                                   kill=("miner:pre_deep_expand", KILL_SLIDE)))
_add(("restore", "grid2x2->4x1"), 4, dict(
    kind="stream_restore", n_items=N_ITEMS, batches=BATCHES, directory="grid2x2",
    backend="grid", shard="grid", grid="4x1", config={}, support_map=True))
_add(("crash", "sharded4"), 4, dict(kind="stream_ckpt", n_items=N_ITEMS,
                                    batches=BATCHES, directory="sharded4",
                                    config=_cfg("sharded"),
                                    kill=("miner:mid_evict", KILL_SLIDE)))
_add(("restore", "single->grid"), 4, dict(
    kind="stream_restore", n_items=N_ITEMS, batches=BATCHES, directory="single",
    backend="grid", shard="grid", grid="2x2",
    config=dict(backend="grid", shard="grid"), support_map=True))
_add(("restore", "reference->tid"), 4, dict(
    kind="stream_restore", n_items=N_ITEMS, batches=BATCHES, directory="reference",
    backend="tidsharded", shard="words", config=dict(backend="tidsharded",
                                                     shard="words"),
    support_map=True))
# batch mining: per-level checkpoints written on a word-sharded mesh, and
# resume_mine of the host's level-3 checkpoint on two meshes
_add(("mine", "tidsharded"), 4, dict(
    kind="mine", txns=MINE_DB, n_items=14,
    config=dict(MINE_CFG, backend="tidsharded", shard="words",
                checkpoint_dir="mine-mesh", checkpoint_every_level=True)))
for _b, _shard, _g in (("tidsharded", "words", None), ("grid", "grid", "2x2")):
    _add(("resume", _b), 4, dict(kind="resume", grid=_g, config=dict(
        MINE_CFG, backend=_b, shard=_shard, checkpoint_dir="mine-k3")))


def _resolved(jobs, root):
    out = []
    for job in jobs:
        job = dict(job)
        if "directory" in job:
            job["directory"] = os.path.join(root, job["directory"])
        if job.get("config", {}).get("checkpoint_dir"):
            job["config"] = dict(job["config"], checkpoint_dir=os.path.join(
                root, job["config"]["checkpoint_dir"]))
        out.append(job)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's ranks, started once (world 4 first: world 2 restores
    what it wrote), after the host writes the directories the ranks
    restore: a crashed single-device run, a crashed reference run and the
    host mine's level-3 checkpoint."""
    root = str(tmp_path_factory.mktemp("faultinject"))
    crashed_run(StreamConfig(backend="fused", **KW), BATCHES,
                os.path.join(root, "single"), "miner:mid_append", KILL_SLIDE)
    j_crashed_run(N_ITEMS, JStreamConfig(backend="jnp", **KW), BATCHES,
                  os.path.join(root, "reference"), "miner:mid_append", KILL_SLIDE)
    k3 = os.path.join(root, "mine-k3")
    mine(MINE_DB, 14, EclatConfig(**MINE_CFG, checkpoint_dir=k3,
                                  checkpoint_every_level=True), device="cpu")
    for f in os.listdir(k3):
        if f != "mining_ckpt_k3.npz":
            os.remove(os.path.join(k3, f))
    out = {world: run_ranks(run_jobs, world, backend="gloo", device="cpu",
                            args=(_resolved(JOBS[world], root),), timeout=240)
           for world in (4, 2)}
    out["root"] = root
    return out


def _per_rank(ranks, key):
    world, j = WHERE[key]
    got = [r[j] for r in ranks[world]]
    for rank, g in enumerate(got):
        assert "error" not in g, (key, rank, g["error"])
    return got


# ---------------------------------------------------------------------------
# the full matrix: five backends x five kill points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", ALL_POINTS)
@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_kill_and_restore_bit_exact(backend, point, tmp_path):
    cfg = StreamConfig(backend=backend, **KW)
    step = crashed_run(cfg, BATCHES, str(tmp_path), point, KILL_SLIDE)
    assert step == KILL_SLIDE
    res = resume_run(BATCHES, str(tmp_path))
    assert res.support_map() == _reference(), f"{backend} @ {point}"


@pytest.mark.parametrize("point", ALL_POINTS)
@pytest.mark.parametrize("backend", list(MESH))
def test_mesh_kill_and_restore_bit_exact(ranks, backend, point):
    """On 4 gloo ranks: the fault fires (on the lead rank alone for the
    checkpoint points, which only it writes) and every rank stops; every
    rank restores step 2 and replays to the reference's map."""
    for res in _per_rank(ranks, ("crash", backend, point)):
        assert res["fired"] and res["steps"][-1] == KILL_SLIDE, res
    for res in _per_rank(ranks, ("restore", backend, point)):
        assert res["start"] == KILL_SLIDE and res["validate"] == "ok"
        assert res["slides"][-1]["support_map"] == _reference()
        assert res["engine"] == backend


@pytest.mark.parametrize("backend", list(MESH))
def test_mesh_restore_collectives(ranks, backend):
    """A restore makes one broadcast of the step per mesh axis and nothing
    else; a push after it makes none."""
    n_axes = 2 if MESH[backend][2] else 1
    for res in _per_rank(ranks, ("restore", backend, "miner:mid_append")):
        coll = res["restore_stats"]["collectives"]
        assert sum(ops["broadcast"]["calls"] for ops in coll.values()) == n_axes
        assert all(set(ops) == {"broadcast"} for ops in coll.values())
        assert all(sl["push_collectives"] == {} for sl in res["slides"])


# ---------------------------------------------------------------------------
# live re-meshing
# ---------------------------------------------------------------------------

def test_remesh_tidsharded_4_to_2_ranks(ranks):
    assert all(r["fired"] for r in _per_rank(ranks, ("crash", "tid4")))
    for res in _per_rank(ranks, ("restore", "tid4->2")):
        assert res["mesh"] == {"axes": ["data"], "shape": [2]}
        assert res["slides"][-1]["support_map"] == _reference()


def test_remesh_grid_2x2_to_4x1(ranks):
    for res in _per_rank(ranks, ("restore", "grid2x2->4x1")):
        assert res["mesh"] == {"axes": ["class", "data"], "shape": [4, 1]}
        assert res["slides"][-1]["support_map"] == _reference()


def test_remesh_sharded_to_single_device(ranks):
    assert all(r["fired"] for r in _per_rank(ranks, ("crash", "sharded4")))
    res = resume_run(BATCHES, os.path.join(ranks["root"], "sharded4"),
                     backend="fused", shard="pairs")
    assert res.support_map() == _reference()


def test_remesh_single_device_to_grid(ranks):
    for res in _per_rank(ranks, ("restore", "single->grid")):
        assert res["engine"] == "grid" and res["start"] == KILL_SLIDE
        assert res["slides"][-1]["support_map"] == _reference()


# ---------------------------------------------------------------------------
# durability edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", CHECKPOINT_POINTS)
def test_torn_checkpoint_is_invisible(point, tmp_path):
    crashed_run(StreamConfig(backend="ref", **KW), BATCHES, str(tmp_path),
                point, KILL_SLIDE)
    assert valid_steps(str(tmp_path))[-1] == KILL_SLIDE
    assert [d for d in os.listdir(tmp_path) if d.startswith(".tmp_ckpt_")]
    miner, start = restore_miner(str(tmp_path), device="cpu")
    assert start == KILL_SLIDE and miner.ring.n_txn > 0
    miner.ring.validate()


def test_crash_before_first_checkpoint_restores_nothing(tmp_path):
    cfg = StreamConfig(backend="ref", **KW)
    with pytest.raises(InjectedFault):
        stream_run(cfg, BATCHES, directory=str(tmp_path),
                   kill=("miner:mid_append", 0))
    assert valid_steps(str(tmp_path)) == []
    with pytest.raises(FileNotFoundError):
        restore_miner(str(tmp_path), device="cpu")
    assert stream_run(cfg, BATCHES).support_map() == _reference()


def test_checkpoint_cadence_replays_uncheckpointed_slides(tmp_path):
    step = crashed_run(StreamConfig(backend="fused", **KW), BATCHES,
                       str(tmp_path), "miner:pre_deep_expand", 3, every=2)
    assert step == 2
    assert resume_run(BATCHES, str(tmp_path)).support_map() == _reference()


# ---------------------------------------------------------------------------
# directories shared with the reference package
# ---------------------------------------------------------------------------

def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A stream checkpoint the reference wrote (``jnp``) restores in the port
    with no override, as ``ref``, and its state equals the reference's own
    restore, leaf for leaf; the replay reaches the reference's map."""
    j_crashed_run(N_ITEMS, JStreamConfig(backend="jnp", **KW), BATCHES,
                  str(tmp_path), "miner:mid_evict", KILL_SLIDE)
    miner, start = restore_miner(str(tmp_path), device="cpu")
    j_miner, j_start = j_restore_miner(str(tmp_path))
    assert start == j_start == KILL_SLIDE
    assert (miner.config.backend, miner.engine.name) == ("ref", "ref")
    got, want = miner.snapshot_state(), j_miner.snapshot_state()
    np.testing.assert_array_equal(got.cooc, want.cooc)
    np.testing.assert_array_equal(got.prev_frequent, want.prev_frequent)
    np.testing.assert_array_equal(got.ring.words, want.ring.words)
    assert got.window_version == want.window_version == KILL_SLIDE
    assert (got.engine.level_padding, got.engine.n_intersections) == \
        (want.engine.level_padding, want.engine.n_intersections)
    assert resume_run(BATCHES, str(tmp_path)).support_map() == _reference()


def test_reference_mesh_checkpoint_restores_on_port_ranks(ranks):
    for res in _per_rank(ranks, ("restore", "reference->tid")):
        assert res["engine"] == "tidsharded"
        assert res["slides"][-1]["support_map"] == _reference()


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_port_checkpoint_restores_in_the_reference(backend, tmp_path):
    """A port checkpoint names the reference's backends on disk and
    restores in the reference with no override."""
    crashed_run(StreamConfig(backend=backend, **KW), BATCHES, str(tmp_path),
                "miner:mid_append", KILL_SLIDE)
    path = os.path.join(tmp_path, f"step_{KILL_SLIDE:08d}", "manifest.json")
    extra = json.load(open(path))["extra"]
    want = {"ref": "jnp", "fused": "pallas"}[backend]
    assert (extra["config"]["backend"], extra["engine"]["backend"],
            extra["engine"]["inner"]) == (want, want, want)
    assert (extra["engine"]["compact"], extra["engine"]["block_w"],
            extra["engine"]["autotune"], extra["engine"]["interpret"]) == \
        (True, None, False, None)
    j_miner, start = j_restore_miner(str(tmp_path), keep_transactions=False)
    assert j_miner.engine.name == want
    res = None
    for batch in BATCHES[start:]:
        res = j_miner.advance(batch)
    assert res.support_map() == _reference()


def test_a_non_compacting_reference_state_is_refused_by_name(tmp_path):
    """A checkpoint of the reference's non-compacting stream (``compact=
    False``, ported) is no longer refused: it restores in the port as a
    non-compacting ``ref`` miner, its state leaf for leaf the reference's
    own restore, and the replay reaches the uninterrupted map."""
    j_crashed_run(N_ITEMS, JStreamConfig(backend="jnp", compact=False, **KW),
                  BATCHES, str(tmp_path), "miner:mid_append", KILL_SLIDE)
    miner, start = restore_miner(str(tmp_path), device="cpu")
    j_miner, j_start = j_restore_miner(str(tmp_path))
    assert start == j_start == KILL_SLIDE
    assert (miner.config.compact, miner.engine.compact, miner.engine.name) == \
        (False, False, "ref")
    got, want = miner.snapshot_state(), j_miner.snapshot_state()
    assert got.engine.compact is want.engine.compact is False
    np.testing.assert_array_equal(got.ring.words, want.ring.words)
    np.testing.assert_array_equal(got.cooc, want.cooc)
    assert resume_run(BATCHES, str(tmp_path)).support_map() == _reference()


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_a_non_compacting_port_checkpoint_restores_in_the_reference(backend, tmp_path):
    """The reverse: a port checkpoint of a ``compact=False`` stream records
    ``compact`` false and restores in the reference as a non-compacting
    engine that replays to the uninterrupted map."""
    crashed_run(StreamConfig(backend=backend, compact=False, **KW), BATCHES,
                str(tmp_path), "miner:mid_append", KILL_SLIDE)
    path = os.path.join(tmp_path, f"step_{KILL_SLIDE:08d}", "manifest.json")
    extra = json.load(open(path))["extra"]
    assert extra["config"]["compact"] is extra["engine"]["compact"] is False
    j_miner, start = j_restore_miner(str(tmp_path), keep_transactions=False)
    assert j_miner.engine.compact is False
    res = None
    for batch in BATCHES[start:]:
        res = j_miner.advance(batch)
    assert res.support_map() == _reference()


def test_reference_mesh_state_restores_on_one_device(tmp_path):
    """A reference checkpoint taken word-sharded on 4 devices restores in
    the port on one device (its per-device accounting dropped)."""
    mesh = make_mesh((4,), ("data",))
    j_crashed_run(N_ITEMS, JStreamConfig(backend="tidsharded", shard="words", **KW),
                  BATCHES, str(tmp_path), "miner:pre_deep_expand", KILL_SLIDE,
                  mesh=mesh)
    res = resume_run(BATCHES, str(tmp_path), backend="ref", shard="pairs")
    assert res.support_map() == _reference()


# ---------------------------------------------------------------------------
# batch mining on the mesh
# ---------------------------------------------------------------------------

def test_mesh_mine_writes_the_hosts_checkpoints(ranks, tmp_path):
    """Per-level checkpoints of a tidsharded mine on 4 ranks (the lead rank
    writes the gathered frontier) equal the host mine's, array for array."""
    for res in _per_rank(ranks, ("mine", "tidsharded")):
        assert res["total"] > 0
    mine(MINE_DB, 14, EclatConfig(**MINE_CFG, checkpoint_dir=str(tmp_path),
                                  checkpoint_every_level=True), device="cpu")
    mesh_dir = os.path.join(ranks["root"], "mine-mesh")
    assert sorted(os.listdir(mesh_dir)) == sorted(os.listdir(tmp_path))
    for f in os.listdir(tmp_path):
        got, want = np.load(os.path.join(mesh_dir, f)), np.load(os.path.join(tmp_path, f))
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{f}:{k}")


@pytest.mark.parametrize("backend", ["tidsharded", "grid"])
def test_resume_mine_on_a_mesh(ranks, backend):
    want = mine(MINE_DB, 14, EclatConfig(**MINE_CFG), device="cpu")
    assert os.path.basename(latest_mining_checkpoint(
        os.path.join(ranks["root"], "mine-k3"))) == "mining_ckpt_k3.npz"
    for res in _per_rank(ranks, ("resume", backend)):
        assert res["resume_k"] == 3 and res["backend"] == backend
        assert res["checksum"] == support_checksum(want.support_map())
        assert res["counts"] == want.counts
        n_axes = 2 if backend == "grid" else 1
        restore = res["collectives"]["restore"]
        assert sum(ops["broadcast"]["calls"] for ops in restore.values()) == n_axes
