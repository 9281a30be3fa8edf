"""Tile selection and dispatch in the port (``kernels.autotune``,
``core.engine.DispatchPolicy``, ``resolve_engine("auto")``), on the CPU:
the counterparts of ``tests/test_kerneltune.py``'s table, candidate and
policy tests, the mines with ``backend="auto"``, each ``block_w`` candidate
and ``autotune=True`` against the JAX package's on the same database, a
reference ``EngineState`` with ``autotune=True`` restoring, and a numpy
emulation of K2's tiles and decoupled look-back (8-, 64- and 128-pair
tiles) against the plain version.  Mining is integer arithmetic: every
comparison is exact.  Card-only cases are in ``test_torch_cuda.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import EclatConfig as JConfig
from repro.core import engine as jeng
from repro.core import mine as j_mine
from repro.kernels import autotune as j_autotune
from repro.streaming import StreamCheckpointer as JCheckpointer
from repro.streaming import StreamConfig as JStreamConfig
from repro.streaming import StreamingMiner as JMiner

from repro_torch.analysis import roofline
from repro_torch.core import EclatConfig, mine
from repro_torch.core import engine as eng
from repro_torch.device import words_from_numpy
from repro_torch.kernels import autotune as at
from repro_torch.kernels.fused_intersect import (COMPACT_LANES,
                                                 COMPACT_TILE_PAIRS,
                                                 compact_survivors_ref,
                                                 fused_intersect_compact,
                                                 fused_intersect_compact_ref)
from repro_torch.kernels.fused_intersect.fused_intersect import rule_lanes
from repro_torch.kernels.trimatrix import plan_for, split_plan
from repro_torch.streaming import StreamConfig, StreamingMiner, restore_miner

from test_kerneltune import DB, ORACLE
from test_streaming import N_ITEMS, _batches

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def tune_caches(tmp_path, monkeypatch):
    """Both packages' autotune caches in a temporary directory, the
    in-process tables dropped around every test."""
    monkeypatch.setenv(j_autotune.CACHE_ENV, str(tmp_path / "reference.json"))
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "port.json"))
    monkeypatch.delenv(eng.KERNELTUNE_ENV, raising=False)
    j_autotune.reset()
    at.reset()
    yield tmp_path
    j_autotune.reset()
    at.reset()


# ---------------------------------------------------------------------------
# shape classes and candidates
# ---------------------------------------------------------------------------

def test_shape_class_buckets():
    assert at.shape_class("compact", 1000, 100, 0, "cpu") == "compact_q1024_w128_m0_cpu"
    assert (at.shape_class("compact", 513, 100, 0, "cpu")
            == at.shape_class("compact", 1024, 128, 0, "cpu"))
    # kernel, mode and card split classes
    keys = {at.shape_class(k, 1000, 100, m, kind)
            for k in at.KERNELS for m in (0, 1) for kind in ("cpu", CARD)}
    assert len(keys) == 4 * len(at.KERNELS) == 16
    with pytest.raises(ValueError, match="unknown kernel"):
        at.shape_class("pallas", 1, 1)


@pytest.mark.parametrize("w", [1, 5, 7, 100, 600, 3125, 4000])
def test_candidates_collapse_on_the_cpu(w):
    """The plain version has no tile: one candidate, the rule's."""
    assert at.block_w_candidates(w, "cpu") == [at.block_w_of(w, rule_lanes(w))]
    assert at.seeded_candidates(4096, w, "cpu") == at.block_w_candidates(w, "cpu")
    assert at.split_candidates(187, w, "cpu") == [split_plan(187, w)[0]]


def test_candidates_on_a_card_are_the_kernels_instantiations():
    assert at.block_w_candidates(100, CARD) == [128, 256, 1024]
    assert at.block_w_candidates(7, CARD) == [32, 64, 256]
    assert at.block_w_candidates(3125, CARD) == [32, 64, 256]
    assert at.kernel_block_ws(4096) == [128, 256, 1024]
    # the engines' names: K2's tiles and K1's and K3's chunks, no Pallas
    # tile width the port cannot run (512, 2048)
    assert eng.PORT_BLOCK_WS == sorted({32, 64, 128, 256, 1024}
                                       | set(at.window_block_ws()))
    assert 512 not in eng.PORT_BLOCK_WS and 2048 not in eng.PORT_BLOCK_WS
    assert at.split_candidates(75, 16, CARD) == [1, 2]
    cands = at.split_candidates(187, 3125, CARD)
    assert split_plan(187, 3125)[0] in cands and 1 in cands
    assert cands == sorted(set(cands))


@pytest.mark.parametrize("q,w", [(393216, 100), (4096, 3125), (1024, 4096),
                                 (768, 128), (7, 5)])
def test_seeded_candidates_are_an_ordered_permutation(q, w):
    seeded = at.seeded_candidates(q, w, CARD)
    assert sorted(seeded) == sorted(at.block_w_candidates(w, CARD))
    costs = [roofline.intersect_cost(q, w, at.lanes_for_block_w(w, bw))
             for bw in seeded]
    assert [(c.bound_s, c.model) for c in costs] == sorted(
        (c.bound_s, c.model) for c in costs)


@pytest.mark.parametrize("n,w", [(187, 3125), (4096, 3125), (870, 256), (75, 16),
                                 (37, 100), (1, 1)])
def test_seeded_splits_lead_with_split_plans_pick(n, w):
    seeded = at.seeded_splits(n, w, CARD)
    assert sorted(seeded) == at.split_candidates(n, w, CARD)
    assert seeded[0] == split_plan(n, w)[0]


@pytest.mark.parametrize("w", [4, 5, 100, 3125])
def test_block_w_names_the_lanes(w):
    for g in COMPACT_LANES:
        assert at.lanes_for_block_w(w, at.block_w_of(w, g)) == g
    with pytest.raises(ValueError, match=r"candidates: \[") as e:
        at.lanes_for_block_w(w, 512)
    assert str(at.kernel_block_ws(w)) in str(e.value)


def test_split_plan_minimises_the_cost_model():
    """split_plan picks the least modelled cost (waves x (stages + 2)),
    ties to fewer ranges, over every split: the same plan as the formula
    it had before the model moved to analysis.roofline."""
    for n, w in [(187, 3125), (4096, 3125), (870, 256), (75, 16), (37, 100),
                 (1000, 3125), (129, 7)]:
        tiles = -(-n // 128) * (-(-n // 128) + 1) // 2
        stages = max(1, -(-w // 8))
        best = None
        for s in range(1, stages + 1):
            used, words = plan_for(w, s)
            cost = -(-tiles * used // 132) * (words // 8 + 2)
            assert roofline.cooccurrence_cost(n, w, (used, words)).model == cost
            if best is None or (cost, used) < best[0]:
                best = ((cost, used), (used, words))
        assert split_plan(n, w) == best[1]


def test_cost_models():
    c8, c16, c32 = (roofline.intersect_cost(393216, 100, g) for g in (8, 16, 32))
    assert c8.nbytes == c16.nbytes == c32.nbytes == 3 * 393216 * 100 * 4
    assert c32.waves > c16.waves > c8.waves
    with pytest.raises(ValueError, match="lanes"):
        roofline.intersect_cost(10, 10, 4)
    k = roofline.cooccurrence_cost(187, 3125, split_plan(187, 3125))
    assert k.bound_s >= 2 * 187 * 187 * 3125 * 32 / roofline.INT8_TENSOR_OPS_PER_S


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

def test_table_roundtrip(tune_caches):
    path = str(tune_caches / "port.json")
    t = at.AutotuneTable(path)
    t.put("compact_q64_w128_m0_x", at.KernelConfig(lanes=16), measured_ms=0.1,
          clock="cuda_events")
    t.put("trimatrix_q128_w16_m0_x", at.KernelConfig(split=1), source="manual")
    t.save()
    t2 = at.AutotuneTable(path).load()
    assert t2.get("compact_q64_w128_m0_x") == at.KernelConfig(lanes=16)
    assert t2.get("trimatrix_q128_w16_m0_x") == at.KernelConfig(split=1)
    assert t2.entries["compact_q64_w128_m0_x"]["source"] == "measured"
    assert t2.entries["trimatrix_q128_w16_m0_x"] == {"lanes": 0, "split": 1,
                                                      "source": "manual"}
    assert sorted(os.listdir(tune_caches)) == ["port.json"]


@pytest.mark.parametrize("text", ["{not json", "[]", '{"shapes": [1, 2]}', "null"])
def test_a_corrupt_table_is_a_miss(tune_caches, text):
    (tune_caches / "port.json").write_text(text)
    assert at.AutotuneTable(str(tune_caches / "port.json")).load().entries == {}
    assert at.load_table(refresh=True).get("anything") is None
    assert at.table_config("compact", 10, 10, 0, "cpu") is None


def test_lookup_miss_returns_the_cost_model_seed():
    cfg = at.lookup("compact", 64, 40, 0, CARD)
    assert at.block_w_of(40, cfg.lanes) == at.seeded_candidates(64, 40, CARD)[0]
    assert at.lookup("trimatrix", 75, 16, 0, CARD) == at.KernelConfig(split=2)
    assert at.lookup("compact", 64, 40, 0, "cpu").lanes == rule_lanes(40)


def test_an_entry_of_another_card_is_a_miss(tune_caches):
    t = at.load_table()
    t.put(at.shape_class("compact", 100, 40, 0, CARD), at.KernelConfig(lanes=32))
    assert at.table_config("compact", 100, 40, 0, "cpu") is None
    assert at.lookup("compact", 100, 40, 0, CARD).lanes == 32
    assert at.lookup("compact", 100, 40, 0, "cpu").lanes == rule_lanes(40)


def test_paths_are_the_ports_own(monkeypatch, tune_caches):
    assert at.table_path() == str(tune_caches / "port.json")
    monkeypatch.delenv(at.CACHE_ENV)
    monkeypatch.setenv(j_autotune.CACHE_ENV, str(tune_caches / "other.json"))
    assert at.table_path() == os.path.expanduser(
        os.path.join("~", ".cache", "repro-eclat-torch", "autotune.json"))
    assert at.CACHE_ENV != j_autotune.CACHE_ENV
    assert at.table_path() != j_autotune.table_path()
    assert eng.KERNELTUNE_ENV != jeng.KERNELTUNE_ENV
    assert eng.KERNELTUNE_FILE == "BENCH_torch_kerneltune.json"


@pytest.mark.parametrize("kernel,q,w", [("compact", 300, 100), ("compact", 40, 7),
                                        ("trimatrix", 75, 16)])
def test_tune_shape_on_the_cpu_caches_its_one_candidate(tune_caches, kernel, q, w):
    before = at.launches
    rec = at.tune_shape(kernel, q, w, 0, device="cpu", reps=1)
    assert at.launches == before          # the plain version launches nothing
    assert rec["kind"] == "cpu" and rec["clock"] == "host"
    assert list(rec["candidates"]) == [str(rec["tuned"])] == [str(rec["default"])]
    assert rec["model_agrees"] and rec["ms"] == rec["default_ms"] > 0
    data = json.loads((tune_caches / "port.json").read_text())
    assert data["shapes"][rec["key"]]["clock"] == "host"
    cfg = at.table_config(kernel, q, w, 0, "cpu")
    at.reset()
    assert at.table_config(kernel, q, w, 0, "cpu") == cfg
    assert cfg == (at.KernelConfig(lanes=rule_lanes(w)) if kernel == "compact"
                   else at.KernelConfig(split=split_plan(q, w)[0]))


def test_plain_versions_ignore_the_tile():
    rng = np.random.default_rng(0)
    bm = words_from_numpy(rng.integers(0, 2**32, (30, 12), dtype=np.uint32), "cpu")
    l, r = (torch.from_numpy(rng.integers(0, 30, 50).astype(np.int32)) for _ in range(2))
    s = torch.full((50,), 384, dtype=torch.int32)
    want = fused_intersect_compact_ref(bm, l, r, s, 96, 44, mode=1)
    for g in (None, 0, 8, 16, 32):
        for a, b in zip(fused_intersect_compact(bm, l, r, s, 96, 44, mode=1, lanes=g), want):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# measured dispatch
# ---------------------------------------------------------------------------

FAKE_CELLS = [
    {"q": 256, "w": 32, "best_single": "ref", "best_mesh": "sharded"},
    {"q": 16384, "w": 1024, "best_single": "fused", "best_mesh": "tidsharded"},
    {"q": 4096, "w": 128, "best_single": "fused", "best_mesh": None},
]


@pytest.fixture
def fake_table(tmp_path):
    path = str(tmp_path / "BENCH_torch_kerneltune.json")
    with open(path, "w") as f:
        json.dump({"device": "cpu", "crossover": FAKE_CELLS}, f)
    return path


def test_policy_nearest_cell(fake_table):
    pol = eng.DispatchPolicy.load(fake_table)
    assert pol is not None and pol.source == fake_table
    assert pol.choose(100, 16) == "ref"
    assert pol.choose(200000, 4096) == "fused"
    assert pol.choose(100, 16, have_mesh=True) == "sharded"
    assert pol.choose(200000, 4096, have_mesh=True) == "tidsharded"
    assert pol.choose(4096, 128, have_mesh=True) == "fused"   # no mesh measured


def test_policy_missing_corrupt_empty(tmp_path):
    assert eng.DispatchPolicy.load(str(tmp_path / "nope.json")) is None
    for name, text in (("bad", "{not json"), ("list", "[1]"),
                       ("empty", json.dumps({"crossover": []})),
                       ("junk", json.dumps({"crossover": [{"q": 1}]}))):
        (tmp_path / name).write_text(text)
        assert eng.DispatchPolicy.load(str(tmp_path / name)) is None, name


def test_policy_of_another_card_is_not_used(tmp_path, fake_table):
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"device": CARD, "crossover": FAKE_CELLS}))
    assert eng.DispatchPolicy.load(str(other), kind="cpu") is None
    assert eng.DispatchPolicy.load(str(other), kind=CARD) is not None
    assert eng.DispatchPolicy.load(fake_table, kind="cpu") is not None
    # a table that names no card answers any
    anon = tmp_path / "anon.json"
    anon.write_text(json.dumps({"crossover": FAKE_CELLS}))
    assert eng.DispatchPolicy.load(str(anon), kind=CARD) is not None
    e = eng.resolve_engine("auto", policy_path=str(other), hints=(100, 16),
                           device="cpu")
    assert e.name == "fused" and e.dispatch["policy"] is None


def test_policy_env_path(fake_table, monkeypatch):
    monkeypatch.setenv(eng.KERNELTUNE_ENV, fake_table)
    pol = eng.DispatchPolicy.load()
    assert pol is not None and pol.source == fake_table


def test_resolve_auto_routes_by_hints(fake_table, monkeypatch):
    e = eng.resolve_engine("auto", policy_path=fake_table, hints=(100, 16),
                           device="cpu")
    assert e.name == "ref"
    assert e.dispatch == {"requested": "auto", "auto": True, "policy": fake_table}
    # on a card (named, or the default None) a cell won by the plain
    # version keeps the kernels' engine; the table still answered
    monkeypatch.setattr(at, "device_kind", lambda device: "cpu")
    for device in ("cuda", None):
        e = eng.resolve_engine("auto", policy_path=fake_table, hints=(100, 16),
                               device=device)
        assert e.name == "fused", device
        assert e.dispatch["policy"] == fake_table
    assert eng.resolve_engine("ref", device="cuda").name == "ref"
    e = eng.resolve_engine("auto", policy_path=fake_table, hints=(200000, 4096),
                           block_w=256, autotune=True)
    assert (e.name, e.block_w, e.autotune) == ("fused", 256, True)


def test_resolve_auto_on_a_mesh_overrides_shard(fake_table, tmp_path):
    """Under auto the table's mesh winner overrides the default
    shard="pairs"; a named backend contradicting shard is still refused."""
    from repro_torch.launch.mesh import make_data_mesh, process_group
    with process_group("gloo", 1, 0, f"file://{tmp_path}/rdv", device="cpu"):
        mesh = make_data_mesh()
        e = eng.resolve_engine("auto", mesh, policy_path=fake_table,
                               hints=(200000, 4096))
        assert e.name == "tidsharded"
        e = eng.resolve_engine("auto", mesh, policy_path=fake_table,
                               hints=(100, 16))
        assert (e.name, e.inner) == ("sharded", "fused")
        e = eng.resolve_engine("auto", mesh, policy_path=fake_table,
                               hints=(4096, 128))
        assert (e.name, e.inner) == ("sharded", "fused")
        with pytest.raises(ValueError, match="implies shard"):
            eng.resolve_engine("tidsharded", mesh, shard="grid")


def test_resolve_auto_fallbacks(tmp_path):
    e = eng.resolve_engine("auto", policy_path=str(tmp_path / "nope.json"),
                           hints=(100, 16))
    assert e.name == "fused"
    assert e.dispatch["auto"] is True and e.dispatch["policy"] is None
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"crossover": FAKE_CELLS}))
    assert eng.resolve_engine("auto", policy_path=str(path)).name == "fused"
    # a winner that is no backend of the port
    path.write_text(json.dumps({"crossover": [{"q": 1, "w": 1, "best_single": "jnp"}]}))
    assert eng.resolve_engine("auto", policy_path=str(path), hints=(1, 1)).name == "fused"


def test_resolve_non_auto_unchanged(fake_table):
    e = eng.resolve_engine("ref", policy_path=fake_table, hints=(200000, 4096))
    assert e.name == "ref" and e.dispatch["auto"] is False
    e = eng.resolve_engine("batched")
    assert e.name == "fused" and e.dispatch["requested"] == "batched"
    with pytest.raises(ValueError, match="unknown engine backend"):
        eng.resolve_engine("pallas")


# ---------------------------------------------------------------------------
# mines against the reference
# ---------------------------------------------------------------------------

def _reference(**kw):
    return j_mine(DB, 10, JConfig(min_sup=25, **kw)).support_map()


def test_auto_mines_match_the_reference(fake_table, monkeypatch):
    monkeypatch.setenv(eng.KERNELTUNE_ENV, fake_table)
    got = mine(DB, 10, EclatConfig(min_sup=25, backend="auto"), device="cpu")
    assert got.support_map() == _reference(backend="auto") == ORACLE
    # 10 items: 45 level-2 pairs over 5 words -> the (256, 32) cell: ref
    assert got.stats["backend"] == "ref"
    assert got.stats["dispatch"] == {"requested": "auto", "auto": True,
                                     "policy": fake_table}


@pytest.mark.parametrize("block_w", [32, 64, 256])
def test_each_block_w_candidate_mines_the_references_itemsets(block_w):
    # DB has 150 transactions: 5-word rows, whose tiles are 32, 64 and 256
    assert block_w in at.kernel_block_ws(5)
    got = mine(DB, 10, EclatConfig(min_sup=25, block_w=block_w), device="cpu")
    assert got.support_map() == _reference() == ORACLE


def test_a_block_w_the_row_has_not_is_refused():
    with pytest.raises(ValueError, match=r"candidates: \[32, 64, 256\]"):
        mine(DB, 10, EclatConfig(min_sup=25, block_w=1024), device="cpu")
    with pytest.raises(ValueError, match="512"):
        mine(DB, 10, EclatConfig(min_sup=25, block_w=512), device="cpu")


@pytest.mark.parametrize("variant,diffsets", [("v4", False), ("v6", True)])
def test_autotune_mines_match_the_reference(tune_caches, variant, diffsets):
    cfg = dict(variant=variant, use_diffsets=diffsets)
    got = mine(DB, 10, EclatConfig(min_sup=25, autotune=True, **cfg), device="cpu")
    assert got.support_map() == _reference(autotune=True, **cfg) == ORACLE
    entries = at.load_table().entries
    # every K2 shape class of the mine and its K4 were tuned on the host
    n_exp = len(got.stats["pair_padding"]["per_level"])
    assert sum(k.startswith("compact") for k in entries) >= 1
    assert sum(k.startswith("trimatrix") for k in entries) == 1
    assert all(e["clock"] == "host" for e in entries.values()) and n_exp >= 1
    again = mine(DB, 10, EclatConfig(min_sup=25, autotune=True, **cfg), device="cpu")
    assert again.support_map() == ORACLE
    assert at.load_table().entries.keys() == entries.keys()


def test_autotune_streams_match_the_reference():
    cfg = dict(min_sup=0.05, n_blocks=2, block_txns=64, autotune=True)
    got = StreamingMiner(N_ITEMS, StreamConfig(**cfg), device="cpu")
    want = JMiner(N_ITEMS, JStreamConfig(backend="pallas", **cfg))
    for batch in _batches(4, 64, seed=5):
        g, w = got.advance(batch), want.advance(batch)
        assert g.support_map() == w.support_map() and g.counts == w.counts
    assert any(k.startswith("trimatrix") for k in at.load_table().entries)


# ---------------------------------------------------------------------------
# engine state
# ---------------------------------------------------------------------------

def _reference_state(**kw):
    """A reference engine's state, its backend names read as the port's
    (``streaming.persist`` translates them on disk)."""
    from repro_torch.streaming.persist import FROM_REFERENCE
    tree, extra = jeng.make_engine("pallas", **kw).snapshot_state().to_tree()
    extra = {**extra, "backend": FROM_REFERENCE[extra["backend"]],
             "inner": FROM_REFERENCE[extra["inner"]]}
    return eng.EngineState.from_tree(tree, extra)


def test_a_reference_state_with_autotune_restores():
    state = _reference_state(autotune=True)
    assert state.autotune is True
    e = eng.engine_from_state(state)
    assert (e.name, e.autotune, e.block_w) == ("fused", True, None)
    assert e.snapshot_state().autotune is True


def test_a_reference_state_with_a_pallas_tile_is_refused_by_name():
    with pytest.raises(ValueError, match="block_w=512"):
        eng.engine_from_state(_reference_state(block_w=512))
    e = eng.engine_from_state(_reference_state(block_w=256))
    assert e.block_w == 256
    # a non-compacting reference state (ported) rebuilds a non-compacting
    # engine, which snapshots as one
    e = eng.engine_from_state(_reference_state(compact=False))
    assert (e.name, e.compact, e.snapshot_state().compact) == ("fused", False, False)


def test_a_reference_stream_checkpoint_with_autotune_restores(tmp_path):
    """The reference's miner with autotune=True, checkpointed by the
    reference, restored by the port: the same slides after it."""
    cfg = dict(min_sup=0.05, n_blocks=2, block_txns=64, autotune=True)
    batches = _batches(5, 64, seed=9)
    want = JMiner(N_ITEMS, JStreamConfig(backend="pallas", **cfg))
    ck = JCheckpointer(str(tmp_path / "ck"))
    for i, batch in enumerate(batches[:3]):
        want.advance(batch)
    ck.save(want, 3)
    ck.wait()
    got, start = restore_miner(str(tmp_path / "ck"), device="cpu")
    assert start == 3
    assert (got.config.autotune, got.engine.autotune) == (True, True)
    for batch in batches[3:]:
        g, w = got.advance(batch), want.advance(batch)
        assert g.support_map() == w.support_map()


def test_engine_knobs_are_checked():
    with pytest.raises(ValueError, match="block_w=512"):
        eng.make_engine("fused", block_w=512)
    e = eng.make_engine("ref", block_w=128)
    rng = np.random.default_rng(1)
    bm = words_from_numpy(rng.integers(0, 2**32, (6, 5), dtype=np.uint32), "cpu")
    with pytest.raises(ValueError, match=r"5-word rows; candidates: \[32, 64, 256\]"):
        e.expand(bm, np.array([0], np.int32), np.array([1], np.int32),
                 np.array([9], np.int32), mode=0, min_sup=1)


# ---------------------------------------------------------------------------
# K2's tiles and look-back, emulated
# ---------------------------------------------------------------------------

WARP = 32


def _lookback(status, tile):
    """Warp 0's look-back of ``tile`` over ``status`` (None: not published;
    (1, count): aggregate; (2, prefix): inclusive), 32 tiles a round as the
    kernel reads them.  Returns the exclusive prefix, or None where a lane
    up to the nearest inclusive prefix reads an unpublished status (the
    kernel spins: here the caller retries later)."""
    exclusive = 0
    j = tile - 1
    while True:
        sts = [(2, 0) if j - lane < 0 else status[j - lane] for lane in range(WARP)]
        inc = [lane for lane, s in enumerate(sts) if s is not None and s[0] == 2]
        upto = inc[0] if inc else WARP - 1
        if any(sts[lane] is None for lane in range(upto + 1)):
            return None
        exclusive += sum(sts[lane][1] for lane in range(upto + 1))
        if inc:
            return exclusive
        j -= WARP


def _emulate_k2(inter, mask, n_valid, tile_pairs, rng):
    """K2's output rows from its tiles: each tile counts its flags, takes
    its first slot by the decoupled look-back (tiles publish and finish in
    a random interleaving that respects ticket order), and writes its
    survivors from there and its share of the pad rows from the end."""
    q = mask.shape[0]
    flags = (mask != 0) & (np.arange(q) < n_valid)
    n_tiles = -(-q // tile_pairs)
    status = [None] * n_tiles
    base = [None] * n_tiles
    started = 0
    pending = set()
    while any(b is None for b in base):
        moves = (["start"] if started < n_tiles else []) + sorted(pending)
        move = moves[rng.integers(len(moves))]
        if move == "start":
            t = started
            started += 1
            count = int(flags[t * tile_pairs:(t + 1) * tile_pairs].sum())
            if t == 0:
                status[0], base[0] = (2, count), 0
            else:
                status[t] = (1, count)
                pending.add(t)
            continue
        t = move
        ex = _lookback(status, t)
        if ex is not None:
            base[t] = ex
            status[t] = (2, ex + status[t][1])
            pending.discard(t)
    out = np.full((q,) + inter.shape[1:], -1, inter.dtype)
    written = np.zeros(q, np.int64)
    for t in range(n_tiles):
        q0 = t * tile_pairs
        n = min(q - q0, tile_pairs)
        sel = q0 + np.nonzero(flags[q0:q0 + n])[0]
        count = sel.size
        pad0 = q - (q0 - base[t]) - (n - count)
        for i in range(n):
            row = base[t] + i if i < count else pad0 + i - count
            out[row] = inter[sel[i]] if i < count else inter[0]
            written[row] += 1
    assert (written == 1).all(), "every output row is written once"
    return out, int(flags.sum())


@pytest.mark.parametrize("tile_pairs", sorted(COMPACT_TILE_PAIRS.values()))
@pytest.mark.parametrize("q,n_valid,density", [
    (1, 1, 0.5), (8, 8, 1.0), (9, 9, 0.5), (63, 60, 0.5), (64, 64, 0.0),
    (65, 61, 0.7), (129, 129, 0.5), (300, 250, 0.3), (1500, 1400, 0.5),
    (2049, 2000, 0.9)])
def test_k2_tiles_and_lookback_emulated(tile_pairs, q, n_valid, density):
    rng = np.random.default_rng(q * 7 + tile_pairs)
    w = 3
    bm = words_from_numpy(rng.integers(0, 2**32, (40, w), dtype=np.uint32), "cpu")
    l = torch.from_numpy(rng.integers(0, 40, q).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, 40, q).astype(np.int32))
    mask = torch.from_numpy((rng.random(q) < density).astype(np.int32))
    inter = (bm.index_select(0, l.long()) & bm.index_select(0, r.long())).numpy()
    want, _, n_surv = compact_survivors_ref(bm, l, r, mask, n_valid, mode=0)
    got, s = _emulate_k2(inter, mask.numpy(), n_valid, tile_pairs, rng)
    assert s == int(n_surv)
    assert np.array_equal(got, want.numpy())


def test_k2_tiles_are_the_bindings():
    assert COMPACT_TILE_PAIRS == {8: 128, 16: 64, 32: 8}
    # the look-back state has a status per 8 pairs: every tile fits it
    assert min(COMPACT_TILE_PAIRS.values()) == 8


def test_k2_shape_is_the_bindings_copy():
    from repro_torch.kernels.fused_intersect.fused_intersect import compact_shape
    # (lanes, pairs a tile, pairs a group, in flight, blocks/SM fused)
    assert [compact_shape(g) for g in COMPACT_LANES] == [
        (8, 128, 4, 4, 3), (16, 64, 4, 4, 4), (32, 8, 1, 8, 1)]
    for g in COMPACT_LANES:
        lanes, tile, per_group, _, _ = compact_shape(g)
        assert tile == (256 // lanes) * per_group   # 256 threads a block


def test_k2_occupancy_reads_ptxas_registers():
    from repro_torch.launch import k2_occupancy
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z20compact_pairs_kernelILi0ELi4ELi16ELb1EEvPKj' for 'sm_90a'",
        "ptxas info    : Used 80 registers, 380 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_Z20compact_pairs_kernelILi0ELi4ELi16ELb0EEvPKj' for 'sm_90a'",
        "ptxas info    : Used 64 registers, 380 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_Z20compact_pairs_kernelILi1ELi4ELi16ELb1EEvPKj' for 'sm_90a'",
        "ptxas info    : Used 90 registers, 380 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z16other_kernelv' for 'sm_90a'",
        "ptxas info    : Used 12 registers"])
    assert k2_occupancy._registers(log) == {"16 lanes fused": 80,
                                            "16 lanes given": 64}
    assert k2_occupancy._flags("2,4") == ["-DK2_G16_MIN_BLOCKS_FUSED=2",
                                          "-DK2_G16_MIN_BLOCKS_GIVEN=4"]


# ---------------------------------------------------------------------------
# K1's and K3's window plans
# ---------------------------------------------------------------------------

from repro.data.synthetic import quest  # noqa: E402

from repro_torch.kernels.fused_intersect.fused_intersect import (  # noqa: E402
    RULE_PLAN, WINDOW_PLAN_ERRORS, WindowPlan, window_plan, window_skew)

# the main path's K1 and K3 classes (launch.kerneltune) and edge shapes: (Q, W)
WINDOW_CLASSES = [(393216, 100), (4096, 3125), (1024, 4096), (768, 128),
                  (393216, 25), (4096, 782), (1024, 1024),
                  (1001, 100), (4097, 3125), (1001, 131), (300, 7), (1, 100),
                  (0, 100), (1001, 26)]
# a database whose rows are wide enough for staged chunks: 4,000
# transactions (125-word rows) of 24 items
WIDE = quest(4000, 24, 8, 4, seed=3)
WIDE_ITEMS = 24
WIDE_MIN_SUP = 0.08


@pytest.mark.parametrize("q,w", WINDOW_CLASSES)
def test_window_candidates_hold_the_rule_in_cost_order(q, w):
    """On a card: the rule's plan always, at most 8 plans, each one the
    check takes as it is, distinct, ordered by the cost model."""
    rule = window_plan(q, w)
    cands = at.window_candidates(q, w, CARD)
    assert rule in cands and 1 <= len(cands) <= at.MAX_WINDOW_CANDIDATES
    assert len({c[:3] for c in cands}) == len(cands)
    for c in cands:
        assert window_plan(q, w, c[:3]) == c
        lanes = 256 // c.tile
        assert c.chunk == w or (c.chunk + 4) % 32 == max(lanes, 4) % 32
    costs = [roofline.intersect_cost(q, w, plan=c) for c in cands]
    assert [(k.bound_s, k.model) for k in costs] == sorted(
        (k.bound_s, k.model) for k in costs)


def test_a_plan_class_keeps_its_word_width():
    """K1's and K3's classes key the exact width: a plan tuned for 25-word
    slices (whole rows, chunk 25) is never applied to 32-word ones, where
    a chunk of 25 would be a staged chunk off its tile's skew."""
    assert at.shape_class("partial", 393216, 25, 0, CARD) != at.shape_class(
        "partial", 393216, 32, 0, CARD)
    assert at.shape_class("pairs", 300, 100, 0, "cpu") == "pairs_q512_w100_m0_cpu"
    assert at.shape_class("compact", 300, 100, 0, "cpu") == "compact_q512_w128_m0_cpu"
    with pytest.raises(ValueError):
        window_plan(768, 32, (256, 256, 25))
    assert window_plan(768, 25, (256, 256, 25)).stages == 1


@pytest.mark.parametrize("q,w", WINDOW_CLASSES)
def test_window_candidates_collapse_on_the_cpu(q, w):
    assert at.window_candidates(q, w, "cpu") == [window_plan(q, w)]
    assert at.lookup("pairs", q, w, 0, "cpu").plan == tuple(window_plan(q, w)[:3])


def test_window_candidates_at_the_main_path():
    """chess level 4 keeps whole rows (its tile halved, and two staged
    chunks); T10I4D100K level 3 adds 8-pair tiles, 32-pair tiles and the
    skewed chunks under each power-of-two pitch shorter than its rows."""
    got = {c[:3] for c in at.window_candidates(393216, 100, CARD)}
    assert got == {(256, 256, 100), (128, 256, 100), (256, 256, 32), (256, 256, 96)}
    got = {c[:3] for c in at.window_candidates(4096, 3125, CARD)}
    assert (16, 32, 364) in got and (8, 16, 764) in got and (32, 64, 164) in got
    assert {c for _, _, c in got} >= {108, 236, 492, 1004}


# (W, plan, code): a tile no power of two, too small, too large; window rows
# 0 and 257; a chunk off its tile's skew, a chunk of 0; stages and whole
# rows past the shared memory a block may take
REFUSED = [(100, (12, 24, 100), -1), (100, (4, 8, 100), -1),
           (100, (512, 256, 100), -1), (100, (256, 0, 100), -2),
           (100, (256, 257, 100), -2), (3125, (16, 32, 100), -3),
           (3125, (16, 32, 0), -3), (3125, (64, 128, 30), -3),
           (3125, (8, 256, 1020), -4), (3125, (256, 256, 3125), -4)]


@pytest.mark.parametrize("w,plan,code", REFUSED)
def test_the_plan_check_refuses_each_bad_plan(w, plan, code):
    with pytest.raises(ValueError) as e:
        window_plan(50, w, plan)
    assert WINDOW_PLAN_ERRORS[code] in str(e.value)


def test_the_plan_check_reports_a_given_plan():
    """All zeros is the rule; a chunk of at least the row stages whole rows,
    reported as the row; a staged chunk takes two stages of its pitch."""
    assert window_plan(4096, 3125, RULE_PLAN) == window_plan(4096, 3125)
    assert window_plan(10, 100, (64, 128, 4092)) == WindowPlan(64, 128, 100, 1,
                                                               128 * 400 + 16)
    assert window_plan(10, 3125, (16, 28, 1004)) == WindowPlan(
        16, 28, 1004, 2, 2 * 28 * 1008 * 4)
    assert window_skew(8) == 0 and window_skew(16) == 16 and window_skew(32) == 8
    assert {window_skew(t) for t in (64, 128, 256)} == {4}


def test_window_block_ws_are_chunks_of_some_tile():
    """Every name keeps the bank skew of some tile, the rule's chunks are
    among them, and no power of two of 512 or more (a Pallas tile width)
    is."""
    names = at.window_block_ws()
    for c in names:
        assert any((c + 4) % 32 == window_skew(t) for t in at.WINDOW_TILES), c
    for q, w in [(4096, 3125), (1024, 4096), (16896, 3125), (8448, 1563)]:
        assert window_plan(q, w).chunk in names
    assert not {512, 1024 * 2, 4096} & set(names)
    assert set(eng.PORT_BLOCK_WS) == set(names) | {32, 64, 128, 256, 1024}


def test_plan_for_block_w_names_the_chunk(tune_caches):
    """An explicit block_w is the chunk; the tile is the table's, else the
    rule's, moved to the nearest tile that keeps the chunk's skew; a
    block_w of at least the row stages whole rows; any other is refused
    naming this shape's chunks."""
    p = at.plan_for_block_w("pairs", 4096, 3125, 0, 1004, CARD)
    assert p[:3] == (16, 28, 1004)
    p = at.plan_for_block_w("pairs", 4096, 3125, 0, 764, CARD)
    assert p[:3] == (8, 16, 764)
    p = at.plan_for_block_w("partial", 393216, 100, 0, 1024, CARD)
    assert p[:3] == (256, 256, 100)
    at.load_table().put(at.shape_class("pairs", 393216, 100, 0, CARD),
                        at.KernelConfig(plan=(128, 256, 100)))
    assert at.plan_for_block_w("pairs", 393216, 100, 0, 96, CARD)[:3] == (128, 256, 96)
    assert at.plan_for_block_w("pairs", 393216, 100, 0, 60, CARD)[:3] == (8, 16, 60)
    assert at.plan_for_block_w("pairs", 393216, 100, 0, 124, CARD)[:3] == (128, 256, 100)
    with pytest.raises(ValueError, match=r"block_w=50 is not a chunk fused_pairs_kernel "
                                         r"\(K1\) can stage for 100-word rows; its chunks"):
        at.plan_for_block_w("pairs", 393216, 100, 0, 50, CARD)
    with pytest.raises(ValueError, match=r"partial_pairs_kernel \(K3\)"):
        at.plan_for_block_w("partial", 4096, 782, 0, 30, CARD)
    with pytest.raises(ValueError, match="no window plan"):
        at.plan_for_block_w("compact", 10, 10, 0, 32, CARD)


def test_a_table_written_before_window_plans_still_loads(tune_caches):
    """A table file of K2's and K4's entries only (no ``plan`` key) loads,
    its entries mean what they meant, and an entry with a plan roundtrips."""
    path = tune_caches / "port.json"
    path.write_text(json.dumps({"version": 1, "shapes": {
        "compact_q64_w128_m0_cpu": {"lanes": 16, "split": 0, "source": "measured",
                                    "measured_ms": 0.1, "clock": "host"},
        "trimatrix_q128_w16_m0_cpu": {"lanes": 0, "split": 2, "source": "manual"}}}))
    t = at.load_table(refresh=True)
    assert t.get("compact_q64_w128_m0_cpu") == at.KernelConfig(lanes=16)
    assert t.get("trimatrix_q128_w16_m0_cpu") == at.KernelConfig(split=2)
    assert t.get("compact_q64_w128_m0_cpu").plan == RULE_PLAN
    assert at.table_config("compact", 64, 128, 0, "cpu").lanes == 16
    t.put("pairs_q4096_w4096_m0_cpu", at.KernelConfig(plan=(8, 16, 764)))
    t.save()
    data = json.loads(path.read_text())["shapes"]
    assert data["pairs_q4096_w4096_m0_cpu"]["plan"] == [8, 16, 764]
    assert "plan" not in data["compact_q64_w128_m0_cpu"]
    assert at.load_table(refresh=True).get("pairs_q4096_w4096_m0_cpu").plan == (8, 16, 764)


@pytest.mark.parametrize("kernel,q,w", [("pairs", 300, 100), ("partial", 40, 7),
                                        ("pairs", 64, 3125)])
def test_tune_shape_of_a_plan_on_the_cpu_caches_the_rule(tune_caches, kernel, q, w):
    before = at.launches
    rec = at.tune_shape(kernel, q, w, 0, device="cpu", reps=1)
    assert at.launches == before
    rule = list(window_plan(q, w)[:3])
    assert rec["tuned"] == rec["default"] == rec["model_pick"] == rule
    assert list(rec["candidates"]) == ["/".join(map(str, rule))]
    assert at.table_config(kernel, q, w, 0, "cpu") == at.KernelConfig(plan=tuple(rule))


def _plan_spies(monkeypatch):
    """Recording stubs for K1 and K3 behind the engines: each resolves the
    plan the way the wrapper does on the card (``plan=None``: the table's
    plan for the shape class, else the rule) and records it, then runs the
    plain version."""
    import sys
    fi = sys.modules["repro_torch.kernels.fused_intersect.fused_intersect"]
    from repro_torch.kernels.fused_intersect import (fused_intersect_partial_ref,
                                                     fused_intersect_ref)
    seen = []

    def k1(bm, l, r, s, ms, *, mode, plan=None):
        seen.append(("pairs", int(l.shape[0]), int(bm.shape[1]),
                     fi._plan(plan, "pairs", l.shape[0], bm.shape[1], mode, bm.device)))
        return fused_intersect_ref(bm, l, r, s, ms, mode=mode)

    def k3(bm, l, r, *, mode, store=True, plan=None):
        seen.append(("partial", int(l.shape[0]), int(bm.shape[1]),
                     fi._plan(plan, "partial", l.shape[0], bm.shape[1], mode, bm.device)))
        return fused_intersect_partial_ref(bm, l, r, mode=mode, store=store)

    monkeypatch.setattr(eng.FusedEngine, "_intersect", staticmethod(k1))
    monkeypatch.setitem(eng._INNER_FUNCS, "fused", (
        eng._INNER_FUNCS["fused"][0], k3, eng._INNER_FUNCS["fused"][2], k1))
    return seen


def test_k1_receives_the_tables_plan_and_a_named_chunk(monkeypatch, tune_caches):
    seen = _plan_spies(monkeypatch)
    got = mine(WIDE, WIDE_ITEMS, EclatConfig(min_sup=WIDE_MIN_SUP, compact=False),
               device="cpu")
    want = j_mine(WIDE, WIDE_ITEMS, JConfig(min_sup=WIDE_MIN_SUP, compact=False))
    assert got.support_map() == want.support_map()
    assert seen and all(k == "pairs" and p == RULE_PLAN for k, _, _, p in seen)
    # the table's plan for every class the mine launched
    table = at.load_table()
    for _, q, w, _ in seen:
        table.put(at.shape_class("pairs", q, w, 0, "cpu"),
                  at.KernelConfig(plan=(16, 32, w)))
    seen.clear()
    mine(WIDE, WIDE_ITEMS, EclatConfig(min_sup=WIDE_MIN_SUP, compact=False), device="cpu")
    assert seen and all(p == (16, 32, w) for _, _, w, p in seen)
    # an explicit block_w: its chunk, at the tile that keeps its skew
    seen.clear()
    mine(WIDE, WIDE_ITEMS, EclatConfig(min_sup=WIDE_MIN_SUP, compact=False, block_w=60),
         device="cpu")
    assert seen and all(p == (8, 16, 60) for _, _, _, p in seen)


def test_k3_receives_the_tables_plan_and_a_named_chunk(monkeypatch, tune_caches, tmp_path):
    """The word-sharded engine (one gloo rank) passes K3 the plan of an
    explicit block_w at its slice width, or leaves it to the table; with
    compact=True K2's given-mask front end takes block_w as its own tile
    (32 words is one of K2's tiles for 125-word rows, and a chunk of K3's
    at 64-pair tiles)."""
    from repro_torch.launch.mesh import make_data_mesh, process_group
    seen = _plan_spies(monkeypatch)
    with process_group("gloo", 1, 0, f"file://{tmp_path}/rdv", device="cpu"):
        mesh = make_data_mesh()
        for compact in (False, True):
            for block_w in (None, 32):
                seen.clear()
                got = mine(WIDE, WIDE_ITEMS,
                           EclatConfig(min_sup=WIDE_MIN_SUP, compact=compact,
                                       block_w=block_w, backend="fused", shard="words"),
                           device="cpu", mesh=mesh)
                assert got.stats["backend"] == "tidsharded"
                want = (RULE_PLAN if block_w is None else (64, 128, 32))
                assert seen and all(k == "partial" and p == want for k, _, _, p in seen), (
                    compact, block_w, seen[:3])
        assert got.support_map() == j_mine(WIDE, WIDE_ITEMS,
                                           JConfig(min_sup=WIDE_MIN_SUP)).support_map()


def test_an_invalid_block_w_is_refused_by_name():
    with pytest.raises(ValueError, match="block_w=50"):
        eng.make_engine("fused", block_w=50, compact=False)
    with pytest.raises(ValueError, match="block_w=512"):
        EclatConfig(min_sup=1, block_w=512, compact=False) and eng.resolve_engine(
            "fused", block_w=512, compact=False)
    # a chunk of K1's that is no tile of K2's, on a compacting engine
    e = eng.make_engine("fused", block_w=364)
    bm = words_from_numpy(np.zeros((6, 5), np.uint32), "cpu")
    with pytest.raises(ValueError, match=r"candidates: \[32, 64, 256\]"):
        e.expand(bm, np.array([0], np.int32), np.array([1], np.int32),
                 np.array([9], np.int32), mode=0, min_sup=1)


# ---------------------------------------------------------------------------
# mines of the window plans against the reference
# ---------------------------------------------------------------------------

def _wide_reference(**kw):
    return j_mine(WIDE, WIDE_ITEMS, JConfig(min_sup=WIDE_MIN_SUP, **kw))


@pytest.mark.parametrize("variant,diffsets", [("v4", False), ("v6", True)])
def test_non_compacting_autotune_mines_match_the_reference(tune_caches, variant, diffsets):
    from repro_torch.core import support_checksum
    cfg = dict(variant=variant, use_diffsets=diffsets, compact=False, autotune=True)
    got = mine(WIDE, WIDE_ITEMS, EclatConfig(min_sup=WIDE_MIN_SUP, **cfg), device="cpu")
    want = _wide_reference(**cfg)
    assert got.support_map() == want.support_map()
    assert support_checksum(got.support_map()) == support_checksum(want.support_map())
    entries = at.load_table().entries
    # every K1 class of the mine was tuned on the host, and no K2 class
    assert sum(k.startswith("pairs") for k in entries) >= 1
    assert not any(k.startswith("compact") for k in entries)
    again = mine(WIDE, WIDE_ITEMS, EclatConfig(min_sup=WIDE_MIN_SUP, **cfg), device="cpu")
    assert again.support_map() == want.support_map()
    assert at.load_table().entries.keys() == entries.keys()


@pytest.mark.parametrize("block_w", [60, 124, 164])
def test_each_chunk_candidate_mines_the_references_itemsets(block_w):
    """125-word rows: the chunks of K1's candidates (164 names whole rows)."""
    assert block_w in at.window_chunk_candidates(1001, 125, CARD)
    got = mine(WIDE, WIDE_ITEMS, EclatConfig(min_sup=WIDE_MIN_SUP, compact=False,
                                             block_w=block_w), device="cpu")
    assert got.support_map() == _wide_reference(compact=False).support_map()


def test_a_tidsharded_autotune_mine_matches_the_reference(tune_caches, tmp_path):
    from repro_torch.launch.mesh import make_data_mesh, process_group
    with process_group("gloo", 1, 0, f"file://{tmp_path}/rdv", device="cpu"):
        mesh = make_data_mesh()
        for compact in (True, False):
            got = mine(WIDE, WIDE_ITEMS,
                       EclatConfig(min_sup=WIDE_MIN_SUP, autotune=True, compact=compact,
                                   backend="fused", shard="words"),
                       device="cpu", mesh=mesh)
            assert got.stats["backend"] == "tidsharded"
            assert got.support_map() == _wide_reference(compact=compact).support_map()
    entries = at.load_table().entries
    assert any(k.startswith("partial") for k in entries)
    assert any(k.startswith("compact") for k in entries)


def test_the_chess_stream_without_compaction_autotunes_as_the_reference(tune_caches):
    """The chess stream's shape (512-transaction blocks, min_sup 0.7) on a
    window of 2 blocks, 4 slides, ``compact=False`` and ``autotune=True``:
    the same slides as the reference's miner, K1's classes tuned."""
    from repro.data import transaction_stream as j_stream
    batches = list(j_stream("chess", 512, 4, seed=0, drift_every=10))
    cfg = dict(min_sup=0.7, n_blocks=2, block_txns=512, compact=False, autotune=True)
    from repro.data.synthetic import PAPER_DATASETS
    n_items = PAPER_DATASETS["chess"].n_items
    got = StreamingMiner(n_items, StreamConfig(**cfg), device="cpu")
    want = JMiner(n_items, JStreamConfig(backend="pallas", **cfg))
    for batch in batches:
        g, w = got.advance(batch), want.advance(batch)
        assert g.support_map() == w.support_map() and g.counts == w.counts
    assert any(k.startswith("pairs") for k in at.load_table().entries)


def test_a_reference_state_without_compaction_with_autotune_restores():
    state = _reference_state(autotune=True, compact=False)
    assert (state.autotune, state.compact) == (True, False)
    e = eng.engine_from_state(state)
    assert (e.name, e.autotune, e.compact, e.block_w) == ("fused", True, False, None)
    snap = e.snapshot_state()
    assert (snap.autotune, snap.compact) == (True, False)
