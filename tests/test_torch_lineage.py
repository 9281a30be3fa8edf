"""Lineage recovery and the per-level mining checkpoints of the port's
batch miner against the reference package (``tests/test_lineage.py``'s
checklist), on the CPU: ``recover_partition`` equal to the reference's and
to the subtree of a full mine, the mining-checkpoint round trip,
``resume_mine`` from every checkpointed level equal to an uninterrupted
``mine()``, and ``mining_ckpt_k*.npz`` files crossing between the packages
in both directions.  The reference's ``resume_mine`` restarts its level
count at 2 (``src/repro/core/eclat.py:172``), so it resumes only from the
deepest checkpoint, the one with no further level; the cases that hand a
port checkpoint to it use that one.  Every comparison is exact.
"""
import os
import shutil

import numpy as np
import pytest

from repro.core import EclatConfig as JConfig
from repro.core import build_vertical as j_build_vertical
from repro.core import load_mining_checkpoint as j_load_ckpt
from repro.core import mine as j_mine
from repro.core import recover_partition as j_recover
from repro.core import resume_mine as j_resume

from repro_torch.core import (EclatConfig, assign_partitions, build_vertical,
                              latest_mining_checkpoint, load_mining_checkpoint,
                              mine, recover_partition, resume_mine,
                              support_checksum)

from test_lineage import make_db

TXNS = make_db()
N_ITEMS = 14
MS, P = 30, 8
CFG = dict(min_sup=MS, variant="v4", p=4)


def _full(**kw):
    return mine(TXNS, N_ITEMS, EclatConfig(**CFG, **kw), device="cpu")


@pytest.mark.parametrize("pid", range(P))
def test_recover_partition_matches_reference_and_subtree(pid):
    db = build_vertical(TXNS, N_ITEMS, MS)
    table = assign_partitions(db.n_items - 1, "hash", P)
    got = recover_partition(db, table, pid=pid, abs_min_sup=MS, device="cpu")
    want = j_recover(j_build_vertical(TXNS, N_ITEMS, MS), table, pid=pid,
                     abs_min_sup=MS)
    assert got == want
    full = mine(TXNS, N_ITEMS, EclatConfig(min_sup=MS, variant="v4", p=P),
                device="cpu")
    rank_of_item = {int(it): r for r, it in enumerate(db.items)}
    expect = {iset: sup for iset, sup in full.support_map().items()
              if len(iset) >= 2
              and table[min(rank_of_item[i] for i in iset)] == pid}
    assert got == expect


def test_recover_partition_max_k():
    db = build_vertical(TXNS, N_ITEMS, MS)
    table = assign_partitions(db.n_items - 1, "hash", P)
    got = recover_partition(db, table, pid=0, abs_min_sup=MS, max_k=3,
                            device="cpu")
    want = j_recover(j_build_vertical(TXNS, N_ITEMS, MS), table, pid=0,
                     abs_min_sup=MS, max_k=3)
    assert got == want and max(map(len, got)) <= 3


def test_mining_checkpoint_roundtrip(tmp_path):
    res = _full(checkpoint_dir=str(tmp_path), checkpoint_every_level=True)
    ckpts = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert ckpts == [f"mining_ckpt_k{k}.npz" for k in range(3, len(res.counts) + 1)]
    store, frontier = load_mining_checkpoint(os.path.join(tmp_path, ckpts[-1]))
    for lvl_restored, lvl_final in zip(store.levels, res.store.levels):
        np.testing.assert_array_equal(lvl_restored.support, lvl_final.support)
        np.testing.assert_array_equal(lvl_restored.item_rank, lvl_final.item_rank)
    assert frontier["bitmaps"].ndim == 2 and frontier["bitmaps"].dtype == np.uint32
    assert frontier["meta"]["abs_min_sup"] == MS
    assert latest_mining_checkpoint(str(tmp_path)).endswith(ckpts[-1])


def test_mining_checkpoints_equal_the_references(tmp_path):
    """The port's files hold the reference's arrays, key for key."""
    _full(checkpoint_dir=str(tmp_path / "port"), checkpoint_every_level=True)
    j_mine(TXNS, N_ITEMS, JConfig(**CFG, backend="jnp",
                                  checkpoint_dir=str(tmp_path / "ref"),
                                  checkpoint_every_level=True))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for f in names:
        got = np.load(tmp_path / "port" / f)
        want = np.load(tmp_path / "ref" / f)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{f}:{k}")
            assert got[k].dtype == want[k].dtype, (f, k)


@pytest.mark.parametrize("backend", ["ref", "fused"])
@pytest.mark.parametrize("from_k", [3, 4, 5])
def test_resume_mine_equals_uninterrupted_mine(backend, from_k, tmp_path):
    full = _full(checkpoint_dir=str(tmp_path), checkpoint_every_level=True)
    for f in os.listdir(tmp_path):
        if int(f[len("mining_ckpt_k"):-len(".npz")]) > from_k:
            os.remove(os.path.join(tmp_path, f))
    res = resume_mine(EclatConfig(**CFG, backend=backend,
                                  checkpoint_dir=str(tmp_path)), device="cpu")
    assert res.stats["resume_k"] == from_k and res.db is None
    assert res.support_map() == full.support_map()
    assert res.counts == full.counts
    assert support_checksum(res.support_map()) == support_checksum(full.support_map())


def test_resume_mine_keeps_checkpointing(tmp_path):
    full = _full(checkpoint_dir=str(tmp_path), checkpoint_every_level=True)
    want = {f: np.load(os.path.join(tmp_path, f))["support"]
            for f in os.listdir(tmp_path)}
    for f in want:
        if f != "mining_ckpt_k3.npz":
            os.remove(os.path.join(tmp_path, f))
    res = resume_mine(EclatConfig(**CFG, checkpoint_dir=str(tmp_path),
                                  checkpoint_every_level=True), device="cpu")
    assert res.support_map() == full.support_map()
    assert sorted(os.listdir(tmp_path)) == sorted(want)
    for f, sup in want.items():
        np.testing.assert_array_equal(np.load(os.path.join(tmp_path, f))["support"], sup)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's level-3 checkpoint (deeper ones dropped) resumes in
    the port to the reference's full map."""
    want = j_mine(TXNS, N_ITEMS, JConfig(**CFG, backend="jnp",
                                         checkpoint_dir=str(tmp_path),
                                         checkpoint_every_level=True))
    for f in os.listdir(tmp_path):
        if f != "mining_ckpt_k3.npz":
            os.remove(os.path.join(tmp_path, f))
    res = resume_mine(EclatConfig(**CFG, checkpoint_dir=str(tmp_path)),
                      device="cpu")
    assert res.support_map() == want.support_map()


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    full = _full(checkpoint_dir=str(tmp_path), checkpoint_every_level=True)
    got = j_resume(JConfig(**CFG, backend="jnp", checkpoint_dir=str(tmp_path)))
    assert got.support_map() == full.support_map()
    store, frontier = j_load_ckpt(latest_mining_checkpoint(str(tmp_path)))
    assert frontier["bitmaps"].dtype == np.uint32 and store.counts == full.counts


def test_resume_needs_a_directory_and_a_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        resume_mine(EclatConfig(**CFG), device="cpu")
    with pytest.raises(FileNotFoundError):
        resume_mine(EclatConfig(**CFG, checkpoint_dir=str(tmp_path)), device="cpu")
    _full(checkpoint_dir=str(tmp_path / "old"), checkpoint_every_level=True)
    z = dict(np.load(tmp_path / "old" / "mining_ckpt_k3.npz"))
    z["meta"] = np.asarray("{}")
    os.makedirs(tmp_path / "bare")
    np.savez(tmp_path / "bare" / "mining_ckpt_k3.npz", **z)
    with pytest.raises(ValueError, match="predates resume metadata"):
        resume_mine(EclatConfig(**CFG, checkpoint_dir=str(tmp_path / "bare")),
                    device="cpu")
    shutil.rmtree(tmp_path / "old")
