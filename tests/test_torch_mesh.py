"""The port's mesh backends on gloo ranks of the host against the reference
package's mesh backends on the 4-device host mesh that ``conftest.py`` pins.

The ranks are started once per world size for the whole module
(``run_ranks`` with the ``launch.mesh_runs`` jobs: spawning costs seconds a
start); every case runs inside them, and the parametrised tests below
assert on what each rank returned:

* ``mine()`` over ``pairs`` 4, ``words`` 1x4 and 2, ``grid`` 2x2, 4x1 and
  1x4, for v1-v6 and v6 with diffsets: the support map, its checksum, the
  levels and the engine's accounting equal the reference's mesh ``mine()``
  with the same split, and the port's single-device ``ref`` mine, on every
  rank;
* one ``expand`` per backend and mode equals the reference engine's mask,
  supports, survivor rows (the ranks' word slices put back together) and
  stats, each rank holding a (P, ceil(W / n_data)) slice;
* the collectives per expand and rank: ``tidsharded`` one all-reduce of
  the (Qb,) counts over ``data`` and nothing else; ``grid`` one all-reduce
  of (qmax,) over ``data`` plus the all-gathers of supports and survivors
  over ``class``; ``sharded`` no all-reduce, its exchange being the
  all-gathers of supports and survivors over its pair axis;
* the v3 mesh accumulator bit for bit, the mesh helpers and the errors;
* the sliding-window miner (``stream`` jobs) on ``pairs`` 4, ``words`` 1x4
  and 2 and ``grid`` 2x2: each rank's per-slide support map, levels, class
  churn, co-occurrence counts and engine accounting equal the reference's
  streaming miner on the same mesh, each rank's ring is ``shard_words`` of
  the reference ring's host mirror (block spans that straddle two ranks,
  zero pad words past ``n_words``), and a push makes no collective call.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.core import EclatConfig as JConfig
from repro.core import engine as jeng
from repro.core import mine as j_mine
from repro.core.accumulator import build_vertical_accumulated as j_build_acc
from repro.dist.compat import make_mesh
from repro.dist.sharding import mesh_descriptor as j_mesh_descriptor
from repro.launch import mesh as jmesh
from repro.streaming import StreamConfig as JStreamConfig
from repro.streaming import StreamingMiner as JMiner

from repro_torch.core import EclatConfig, mine, support_checksum
from repro_torch.core.bitmap import popcount_np
from repro_torch.core.engine import bucket_size, group_pairs_by_device
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.mesh_runs import run_jobs

from test_eclat_correctness import make_db
from test_streaming import _batches

DB = make_db()          # 150 transactions over 10 items: W = 5 words
MIN_SUP = 25
VARIANTS = [("v1", False), ("v2", False), ("v3", False), ("v4", False),
            ("v5", False), ("v6", False), ("v6", True)]
# label -> (world, port backend, shard, grid, reference mesh shape, axes)
MESHES = {
    "pairs4": (4, "sharded", "pairs", None, (4,), ("data",)),
    "words1x4": (4, "fused", "words", None, (4,), ("data",)),
    "words2": (2, "fused", "words", None, (2,), ("data",)),
    "grid2x2": (4, "grid", "grid", "2x2", (2, 2), ("class", "data")),
    "grid4x1": (4, "grid", "grid", "4x1", (4, 1), ("class", "data")),
    "grid1x4": (4, "grid", "grid", "1x4", (1, 4), ("class", "data")),
}
# engine cases: label -> (mesh label, engine backend name)
ENGINES = {"sharded": ("pairs4", "sharded"),
           "tidsharded": ("words1x4", "tidsharded"),
           "tidsharded2": ("words2", "tidsharded"),
           "grid": ("grid2x2", "grid")}
MODES = [0, 1, 2]
P, W, Q = 32, 9, 40     # W = 9: no multiple of 2 or 4 (zero pad words)
JOBS = {2: [], 4: []}
WHERE = {}              # case key -> (world, job index)


def _add(key, world, job):
    WHERE[key] = (world, len(JOBS[world]))
    JOBS[world].append(job)


def _n_data(label):
    shape, axes = MESHES[label][4:]
    return shape[axes.index("data")]


def _config(variant, diffsets, **kw):
    return dict(min_sup=MIN_SUP, variant=variant, p=3, use_diffsets=diffsets,
                bucket_min=32, **kw)


def _expand_case(label, mode):
    """A random (P, W) frontier and Q pairs, their true left supports,
    min_sup at the median support, and a pair -> slot routing."""
    rng = np.random.default_rng(100 * mode + len(label))
    words = rng.integers(0, 2**32, (P, W), dtype=np.uint32)
    left = rng.integers(0, P, Q).astype(np.int32)
    right = rng.integers(0, P, Q).astype(np.int32)
    sup_left = popcount_np(words[left]).sum(-1).astype(np.int32)
    inter = {0: words[left] & words[right], 1: words[left] & ~words[right],
             2: words[right] & ~words[left]}[mode]
    pop = popcount_np(inter).sum(-1)
    sup = pop if mode == 0 else sup_left - pop
    n_dev = {"sharded": 4, "grid": 2}.get(ENGINES[label][1], 1)
    return dict(bitmaps=words, left=left, right=right, sup_left=sup_left,
                mode=mode, min_sup=int(np.median(sup)),
                device_of_pair=rng.integers(0, n_dev, Q))


for _label, (_world, _backend, _shard, _grid, _, _) in MESHES.items():
    for _v, _d in VARIANTS:
        _add(("mine", _label, _v, _d), _world,
             dict(kind="mine", txns=DB, n_items=10, grid=_grid,
                  support_map=True,
                  config=_config(_v, _d, backend=_backend, shard=_shard)))
    _add(("mesh", _label), _world,
         dict(kind="mesh", backend=_backend, shard=_shard, grid=_grid))
for _label, (_mesh, _name) in ENGINES.items():
    _world, _backend, _shard, _grid = MESHES[_mesh][:4]
    for _mode in MODES:
        _add(("expand", _label, _mode), _world,
             dict(kind="expand", backend=_backend, shard=_shard, grid=_grid,
                  inner="ref", bucket_min=8, **_expand_case(_label, _mode)))
for _label in ("words1x4", "grid2x2"):
    _world, _backend, _shard, _grid = MESHES[_label][:4]
    _add(("accumulate", _label), _world,
         dict(kind="accumulate", txns=DB, n_items=10, min_sup=MIN_SUP,
              backend=_backend, shard=_shard, grid=_grid))
# streams: (n_blocks, block_txns, batch_txns) per world; n_blocks * wpb
# words over the data axis leave zero pad words (3 words over 2 or 4 ranks)
# or spans that straddle two ranks (2-word blocks over slices of 3 words)
STREAM_GEOMETRIES = {4: [(3, 32, 28), (5, 64, 60)], 2: [(3, 32, 28), (3, 64, 60)]}
STREAM_MESHES = ("pairs4", "words1x4", "words2", "grid2x2")
STREAM_MIN_SUP = 6


def _stream_batches(n_blocks, block_txns, batch_txns):
    return _batches(n_blocks + 3, batch_txns, seed=n_blocks + block_txns)


def _stream_config(n_blocks, block_txns, **kw):
    return dict(min_sup=STREAM_MIN_SUP, n_blocks=n_blocks,
                block_txns=block_txns, bucket_min=16, **kw)


for _label in STREAM_MESHES:
    _world, _backend, _shard, _grid = MESHES[_label][:4]
    for _geo in STREAM_GEOMETRIES[_world]:
        _add(("stream", _label, _geo), _world,
             dict(kind="stream", batches=_stream_batches(*_geo), n_items=12,
                  grid=_grid, support_map=True, cooc=True,
                  config=_stream_config(*_geo[:2], backend=_backend,
                                        shard=_shard)))
# errors, on 4 ranks: the grid engine on a 1-D mesh, class ids outside the
# class axis, grids that do not fit the ranks
_add(("error", "grid on 1-D"), 4,
     dict(kind="expand", backend="tidsharded", shard="pairs", grid=None,
          inner="grid", **_expand_case("grid", 0)))
_bad = _expand_case("grid", 0)
_bad["device_of_pair"] = np.where(np.arange(Q) == 3, 2, _bad["device_of_pair"])
_add(("error", "class id"), 4,
     dict(kind="expand", backend="grid", shard="grid", grid="2x2",
          inner="ref", **_bad))
for _g in ("3x2", "3x1", "2x3x1"):
    _add(("error", _g), 4, dict(kind="mesh", backend="grid", shard="grid",
                                grid=_g))


@pytest.fixture(scope="module")
def ranks():
    """Each world's ranks, started once: {world: [rank results]}."""
    return {world: run_ranks(run_jobs, world, backend="gloo", device="cpu",
                             args=(jobs,), timeout=240)
            for world, jobs in JOBS.items()}


def _per_rank(ranks, key):
    world, j = WHERE[key]
    return [r[j] for r in ranks[world]]


def _j_mesh(label):
    shape, axes = MESHES[label][4:]
    return make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])


@functools.lru_cache(maxsize=None)
def _j_mine(label, variant, diffsets):
    backend, shard = MESHES[label][1:3]
    cfg = JConfig(**_config(variant, diffsets,
                            backend="pallas" if backend == "fused" else backend,
                            shard=shard))
    return j_mine(DB, 10, cfg, mesh=_j_mesh(label))


# ---------------------------------------------------------------------------
# mine() on the mesh
# ---------------------------------------------------------------------------

STATS_KEYS = ("backend", "n_intersections", "n_padded", "pair_padding",
              "device_balance", "n_word_shards", "grid", "abs_min_sup")


@pytest.mark.parametrize("variant,diffsets", VARIANTS,
                         ids=[v + ("-diffsets" if d else "") for v, d in VARIANTS])
@pytest.mark.parametrize("label", list(MESHES))
def test_mesh_mine_matches_reference(ranks, label, variant, diffsets):
    want = _j_mine(label, variant, diffsets)
    ref = mine(DB, 10, EclatConfig(**_config(variant, diffsets, backend="ref")),
               device="cpu")
    assert ref.support_map() == want.support_map()
    want_sum = support_checksum(want.support_map())
    for res in _per_rank(ranks, ("mine", label, variant, diffsets)):
        assert res["support_map"] == want.support_map()
        assert res["checksum"] == want_sum
        assert res["counts"] == want.counts
        for key in STATS_KEYS:
            assert res["stats"].get(key) == want.stats.get(key), key


@pytest.mark.parametrize("label", list(MESHES))
def test_mesh_mine_frontier_and_collectives(ranks, label):
    """Per rank: the frontier slice, and the collectives of the vertical
    build (one all-reduce of the v4 accumulator's partial) and of the
    levels, per the backend's budget."""
    backend = MESHES[label][1]
    n_data = _n_data(label)
    for res in _per_rank(ranks, ("mine", label, "v4", False)):
        st = res["stats"]
        levels = st["pair_padding"]["per_level"]
        assert res["n_expands"] == len(levels) > 0
        assert st["collectives"]["vertical"] == {
            "data": {"all_reduce": {"calls": 1, "bytes": 10 * 5 * 4}}}
        lev = st["collectives"]["levels"]
        padded = sum(lv["padded_to"] for lv in levels)
        if backend == "sharded":
            assert st.get("frontier_words") is None
            assert set(lev) == {"data"} and set(lev["data"]) == {"all_gather"}
            assert len(levels) <= lev["data"]["all_gather"]["calls"] <= 2 * len(levels)
            continue
        assert st["frontier_words"] == -(-st["n_words"] // n_data)
        assert lev["data"] == {"all_reduce": {
            "calls": len(levels),
            "bytes": 4 * padded // (1 if label.startswith("words") else
                                    MESHES[label][4][0])}}
        if label.startswith("words"):
            assert set(lev) == {"data"}
        else:
            assert set(lev) == {"class", "data"}
            assert set(lev["class"]) == {"all_gather"}


# ---------------------------------------------------------------------------
# one expand against the reference engine
# ---------------------------------------------------------------------------

def _j_expand(label, mode):
    mesh_label, name = ENGINES[label]
    case = _expand_case(label, mode)
    e = jeng.make_engine(name, mesh=_j_mesh(mesh_label), bucket_min=8,
                         inner="jnp")
    res = e.expand(jax.numpy.asarray(case["bitmaps"]), case["left"],
                   case["right"], case["sup_left"], mode=mode,
                   min_sup=case["min_sup"],
                   device_of_pair=case["device_of_pair"])
    return e, res


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("label", list(ENGINES))
def test_expand_matches_reference_engine(ranks, label, mode):
    mesh_label, name = ENGINES[label]
    e, want = _j_expand(label, mode)
    n_surv = int(want.mask.sum())
    want_rows = np.asarray(want.bitmaps)
    per_rank = _per_rank(ranks, ("expand", label, mode))
    n_data = _n_data(mesh_label) if name != "sharded" else 1
    wp = -(-W // n_data) * n_data
    # put the word slices back together: rank r is at data coordinate
    # r % n_data; ranks that differ only in their class coordinate agree
    for c in range(len(per_rank) // n_data):
        group = per_rank[c * n_data:(c + 1) * n_data]
        rows = np.concatenate([r["survivors"] for r in group], axis=1)
        assert rows.shape == (want_rows.shape[0], wp)
        assert np.array_equal(rows[:n_surv, :W], want_rows[:n_surv, :W])
    for res in per_rank:
        assert np.array_equal(res["mask"], want.mask)
        assert np.array_equal(res["supports"], want.supports)
        assert res["frontier_shape"] == (P, wp // n_data)
        assert res["device_pair_counts"] == [c.tolist() for c in e.device_pair_counts]
        want_stats = e.stats()
        for key in ("backend", "n_intersections", "n_padded", "pair_padding",
                    "device_balance", "n_word_shards", "grid",
                    "n_class_shards"):
            assert res["stats"].get(key) == want_stats.get(key), key
    assert (n_surv > 0) and not want.mask.all()


@pytest.mark.parametrize("label", list(ENGINES))
def test_expand_collectives_per_rank(ranks, label):
    """The collectives of one expand, on every rank, pinned."""
    mesh_label, name = ENGINES[label]
    for mode in MODES:
        case = _expand_case(label, mode)
        for res in _per_rank(ranks, ("expand", label, mode)):
            coll = res["collectives"]
            qmax = res["stats"]["pair_padding"]["per_level"][0]["padded_to"]
            if name == "tidsharded":
                assert qmax == bucket_size(Q, 8)
                assert coll == {"data": {"all_reduce": {"calls": 1,
                                                        "bytes": qmax * 4}}}
                continue
            n_dev = 4 if name == "sharded" else 2
            qmax //= n_dev
            counts = np.bincount(case["device_of_pair"], minlength=n_dev)
            assert qmax == bucket_size(int(counts.max()), 8)
            s_max = max(int((res["mask"] & (case["device_of_pair"] == d)).sum())
                        for d in range(n_dev))
            width = W if name == "sharded" else -(-W // 2)
            pair_axis = "data" if name == "sharded" else "class"
            assert coll[pair_axis]["all_gather"] == {
                "calls": 2, "bytes": qmax * 4 + s_max * width * 4}
            if name == "sharded":
                assert set(coll) == {"data"} and set(coll["data"]) == {"all_gather"}
            else:
                assert coll["data"] == {"all_reduce": {"calls": 1,
                                                       "bytes": qmax * 4}}
                assert set(coll) == {"class", "data"}


# ---------------------------------------------------------------------------
# the v3 mesh accumulator, the mesh helpers, the errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["words1x4", "grid2x2"])
def test_mesh_accumulator_matches_reference(ranks, label):
    want = j_build_acc(DB, 10, MIN_SUP, order="support_asc",
                       mesh=_j_mesh(label))
    n_data = _n_data(label)
    for res in _per_rank(ranks, ("accumulate", label)):
        assert np.array_equal(res["bitmaps"], np.asarray(want.bitmaps))
        assert res["bitmaps"].dtype == np.uint32
        assert np.array_equal(res["items"], want.items)
        assert np.array_equal(res["supports"], want.supports)
        assert res["n_txn"] == want.n_txn
        assert res["collectives"] == {"data": {"all_reduce": {
            "calls": 1, "bytes": 10 * 5 * 4}}}
    assert n_data in (2, 4)


@pytest.mark.parametrize("label", list(MESHES))
def test_mesh_descriptor_matches_reference(ranks, label):
    want = j_mesh_descriptor(_j_mesh(label))
    for res in _per_rank(ranks, ("mesh", label)):
        assert res["mesh"] == want


def test_mesh_errors_match_reference(ranks):
    (grid_1d, class_id) = (_per_rank(ranks, ("error", k))[0]["error"]
                           for k in ("grid on 1-D", "class id"))
    assert grid_1d.startswith("ValueError: grid backend needs a 2D")
    with pytest.raises(ValueError, match="grid backend needs a 2D") as want:
        jeng.make_engine("grid", mesh=_j_mesh("words1x4"))
    assert grid_1d == f"ValueError: {want.value}"
    with pytest.raises(ValueError) as want:
        _j_expand_bad_class()
    assert class_id == f"ValueError: {want.value}"
    for res in _per_rank(ranks, ("error", "3x2")):
        assert res["error"] == "ValueError: grid 3x2 needs 6 device(s); 4 visible"
    for res in _per_rank(ranks, ("error", "3x1")):
        # the reference would leave the fourth device idle; a rank has
        # nothing to run outside the mesh
        assert res["error"].startswith("ValueError: grid 3x1 uses 3 of the 4 ranks")
    for res in _per_rank(ranks, ("error", "2x3x1")):
        assert res["error"] == "ValueError: --grid expects RxC (e.g. 2x2), got '2x3x1'"


def _j_expand_bad_class():
    e = jeng.make_engine("grid", mesh=_j_mesh("grid2x2"), bucket_min=8,
                         inner="jnp")
    return e.expand(jax.numpy.asarray(_bad["bitmaps"]), _bad["left"],
                    _bad["right"], _bad["sup_left"], mode=0,
                    min_sup=_bad["min_sup"],
                    device_of_pair=_bad["device_of_pair"])


def test_stray_grid_is_refused_as_in_the_reference():
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError, match="requires the grid mode"):
            mod.mesh_for_mining("fused" if mod is tmesh else "pallas",
                                "words", "2x2")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 8, 9, 12, 16])
def test_factor_grid_matches_reference(n):
    assert tmesh.factor_grid(n) == jmesh.factor_grid(n)


@pytest.mark.parametrize("spec", [None, "2x2", "4X1", "1×4", "3x5"])
def test_parse_grid_arg_matches_reference(spec):
    assert tmesh.parse_grid_arg(spec) == jmesh.parse_grid_arg(spec)


@pytest.mark.parametrize("bad", ["2x", "axb", "2x2x2"])
def test_parse_grid_arg_errors_match_reference(bad):
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError, match="--grid expects"):
            mod.parse_grid_arg(bad)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_group_pairs_by_device_matches_reference(n_dev):
    rng = np.random.default_rng(n_dev)
    left, right, sup = (rng.integers(0, 50, 37).astype(np.int32) for _ in range(3))
    dop = rng.integers(0, n_dev, 37)
    got = group_pairs_by_device(left, right, sup, dop, n_dev, 8)
    want = jeng.group_pairs_by_device(left, right, sup, dop, n_dev, 8)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, w)
    bad = dop.copy()
    bad[5] = n_dev
    for fn in (group_pairs_by_device, jeng.group_pairs_by_device):
        with pytest.raises(ValueError, match="outside"):
            fn(left, right, sup, bad, n_dev, 8)


def test_a_failed_rank_fails_the_run():
    """A rank that raises fails run_ranks with its traceback, at once."""
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        run_ranks(run_jobs, 1, backend="gloo", device="cpu",
                  args=([{"kind": "no such job"}],), timeout=60)


@pytest.mark.parametrize("device", ["cuda:1", "cpu:0", "gpu"])
def test_mine_cli_refuses_a_device_it_would_not_use(device, capsys):
    """Under --ranks the ranks sit on cuda:r % count or on the host: any
    other --device is refused before a rank starts."""
    from repro_torch.launch import mine as mine_cli
    with pytest.raises(SystemExit):
        mine_cli.main(["--ranks", "2", "--device", device])
    assert "--device must be cuda or cpu" in capsys.readouterr().err


def test_nccl_needs_the_card():
    with pytest.raises((ValueError, RuntimeError)):
        with tmesh.process_group("nccl", 1, 0, "file:///nonexistent/x",
                                 device="cpu"):
            pass


def test_mine_with_a_mesh_backend_and_no_mesh_is_single_device():
    got = mine(DB, 10, EclatConfig(**_config("v4", False, backend="grid")),
               device="cpu")
    want = j_mine(DB, 10, JConfig(**_config("v4", False, backend="grid")))
    assert got.support_map() == want.support_map()
    assert (got.stats["backend"], want.stats["backend"]) == ("fused", "pallas")
    cfg = dataclasses.replace(EclatConfig(min_sup=MIN_SUP, backend="tidsharded"),
                              shard="grid")
    with pytest.raises(ValueError, match="implies shard"):
        mine(DB, 10, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the sliding-window miner on the mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_stream(label, geo):
    """The reference's streaming miner on the same mesh: per slide (support
    map, levels, co-occurrence counts, stats), and its ring's host mirror."""
    backend, shard = MESHES[label][1:3]
    cfg = JStreamConfig(**_stream_config(
        *geo[:2], backend="pallas" if backend == "fused" else backend,
        shard=shard))
    miner = JMiner(12, cfg, mesh=_j_mesh(label))
    slides = []
    for batch in _stream_batches(*geo):
        res = miner.advance(batch)
        slides.append((res.support_map(), res.counts, miner.cooc.copy(),
                       res.stats))
    return slides, miner.ring.words.copy(), miner.engine.name


STREAM_STATS = ("abs_min_sup", "classes", "window", "n_intersections",
                "n_padded", "pair_padding", "device_balance", "n_word_shards")
STREAM_CASES = [(label, geo) for label in STREAM_MESHES
                for geo in STREAM_GEOMETRIES[MESHES[label][0]]]
STREAM_IDS = [f"{label}-{g[0]}x{g[1]}" for label, g in STREAM_CASES]


@pytest.mark.parametrize("label,geo", STREAM_CASES, ids=STREAM_IDS)
def test_mesh_stream_matches_reference(ranks, label, geo):
    slides, want_words, want_engine = _j_stream(label, geo)
    assert want_engine == {"pairs4": "sharded", "grid2x2": "grid"}.get(label, "tidsharded")
    for res in _per_rank(ranks, ("stream", label, geo)):
        assert res["engine"] == want_engine
        assert len(res["slides"]) == len(slides)
        for i, (got, (smap, counts, cooc, stats)) in enumerate(zip(res["slides"], slides)):
            assert got["support_map"] == smap, f"slide {i}"
            assert got["checksum"] == support_checksum(smap)
            assert got["counts"] == counts
            assert np.array_equal(got["cooc"], cooc), f"slide {i}"
            for key in STREAM_STATS:
                assert got["stats"].get(key) == stats.get(key), (i, key)
        assert res["validate"] == "ok"


@pytest.mark.parametrize("label,geo", STREAM_CASES, ids=STREAM_IDS)
def test_mesh_stream_ring_is_the_word_slice(ranks, label, geo):
    """Each rank's ring: the slice ``shard_words`` cuts of the reference
    ring's host mirror (the whole mirror for ``pairs``, replicated over
    ``class`` on the grid)."""
    _, want_words, _ = _j_stream(label, geo)
    n_data = 1 if label == "pairs4" else _n_data(label)
    n_words = want_words.shape[1]
    ws = -(-n_words // n_data)
    padded = np.zeros((12, ws * n_data), np.uint32)
    padded[:, :n_words] = want_words
    per_rank = _per_rank(ranks, ("stream", label, geo))
    for rank, res in enumerate(per_rank):
        d = rank % n_data
        assert res["ring_geometry"] == dict(
            n_words=n_words, n_words_dev=ws * n_data, local_words=ws,
            word_lo=d * ws)
        assert res["ring"].dtype == np.uint32
        assert np.array_equal(res["ring"], padded[:, d * ws:(d + 1) * ws])


@pytest.mark.parametrize("label,geo", STREAM_CASES, ids=STREAM_IDS)
def test_mesh_stream_push_makes_no_collective(ranks, label, geo):
    """A push writes only the rank's own words: zero collectives.  A mine's
    collectives are its expansions': one all-reduce over ``data`` each on
    the word-sharded backends, all-gathers only for ``sharded``."""
    backend = {"pairs4": "sharded", "grid2x2": "grid"}.get(label, "tidsharded")
    for res in _per_rank(ranks, ("stream", label, geo)):
        for slide in res["slides"]:
            assert slide["push_collectives"] == {}
            coll = slide["mine_collectives"]
            n_exp = slide["n_expands"]
            if backend == "sharded":
                assert all("all_reduce" not in ops for ops in coll.values())
                continue
            got = coll.get("data", {}).get("all_reduce", {}).get("calls", 0)
            assert got == n_exp
            if backend == "tidsharded":
                assert set(coll) <= {"data"}
