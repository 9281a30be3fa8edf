"""The port's checkpoints (``repro_torch.training.checkpoint``) against the
reference's ``tests/test_checkpoint.py`` checklist, on the CPU: atomic
round trips, GC, torn writes, overwrites, fallback past corrupt steps and
writer errors raised on ``wait`` — and the on-disk form shared with the
reference package, both directions: the same trees flatten to the same
leaf paths, and a directory either package writes loads in the other to
equal arrays.  Every comparison is exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import load_checkpoint as j_load
from repro.training import restore_checkpoint as j_restore
from repro.training import save_checkpoint as j_save

from repro_torch.faults import InjectedFault, clear_kill_hook, set_kill_hook
from repro_torch.training import (AsyncCheckpointer, latest_step,
                                  load_checkpoint, restore_checkpoint,
                                  restore_latest, save_checkpoint, valid_steps)
from repro_torch.training.checkpoint import flatten_with_paths


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32), "d": torch.zeros(())}}


def _np(tree_):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else _np(v)
            for k, v in tree_.items()}


class crash_at:
    """Raise InjectedFault at the first hit of a kill point (hook cleared
    on exit)."""

    def __init__(self, point):
        self.point = point

    def __enter__(self):
        def hook(name):
            if name == self.point:
                raise InjectedFault(self.point)
        set_kill_hook(hook)

    def __exit__(self, *exc):
        clear_kill_hook()


def test_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 7, t, extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 7
    restored, manifest = restore_checkpoint(str(tmp_path), 7, t)
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "x"
    for path in ("a", "b/c", "b/d"):
        got = restored[path.split("/")[0]] if path == "a" else restored["b"][path[2]]
        want = t[path.split("/")[0]] if path == "a" else t["b"][path[2]]
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)


def test_restore_places_leaves_on_the_named_device(tmp_path):
    save_checkpoint(str(tmp_path), 1, _np(tree()))
    host, _ = restore_checkpoint(str(tmp_path), 1, _np(tree()))
    assert isinstance(host["a"], np.ndarray) and host["b"]["c"].dtype == np.int32
    placed, _ = restore_checkpoint(str(tmp_path), 1, _np(tree()),
                                   device=torch.device("cpu"))
    assert isinstance(placed["a"], torch.Tensor)
    assert torch.equal(placed["b"]["c"], torch.ones(5, dtype=torch.int32))


def test_latest_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    ck.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]
    assert ck.last_write_s is not None and ck.last_write_s >= 0


def test_async_save_copies_before_returning(tmp_path):
    """The tree may change as soon as save() returns: the host copy was
    taken on the caller's thread."""
    from repro_torch.training.checkpoint import _to_host
    host = torch.arange(6)
    copy = _to_host(host)
    host.zero_()
    np.testing.assert_array_equal(copy, np.arange(6))
    ck = AsyncCheckpointer(str(tmp_path))
    t = {"w": torch.arange(6)}
    ck.save(1, t)
    t["w"].zero_()
    ck.wait()
    flat, _ = load_checkpoint(str(tmp_path), 1)
    np.testing.assert_array_equal(flat["w"], np.arange(6))


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, tree())
    bad = {"a": torch.zeros(2, 2), "b": {"c": torch.ones(5, dtype=torch.int32),
                                         "d": torch.zeros(())}}
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, bad)
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), 1, {"zz": torch.zeros(1)})


def test_mid_write_crash_preserves_previous_step(tmp_path):
    save_checkpoint(str(tmp_path), 1, tree(), extra={"v": 1})
    with crash_at("checkpoint:mid_write"), pytest.raises(InjectedFault):
        save_checkpoint(str(tmp_path), 2, tree(), extra={"v": 2})
    assert valid_steps(str(tmp_path)) == [1]
    _, manifest, step = restore_latest(str(tmp_path))
    assert step == 1 and manifest["extra"]["v"] == 1


def test_overwrite_same_step_is_crash_safe(tmp_path):
    save_checkpoint(str(tmp_path), 5, {"a": np.arange(4.0)}, extra={"v": "old"})
    with crash_at("checkpoint:pre_replace"), pytest.raises(InjectedFault):
        save_checkpoint(str(tmp_path), 5, {"a": np.zeros(4)}, extra={"v": "new"})
    flat, manifest = load_checkpoint(str(tmp_path), 5)
    assert manifest["extra"]["v"] == "old"
    np.testing.assert_array_equal(flat["a"], np.arange(4.0))
    save_checkpoint(str(tmp_path), 5, {"a": np.zeros(4)}, extra={"v": "new"})
    flat, manifest = load_checkpoint(str(tmp_path), 5)
    assert manifest["extra"]["v"] == "new"
    np.testing.assert_array_equal(flat["a"], np.zeros(4))
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".old")]


def test_restore_latest_falls_back_past_corrupt_steps(tmp_path):
    for s in (1, 2, 3):
        save_checkpoint(str(tmp_path), s, tree(), extra={"v": s})
    leaf = os.path.join(tmp_path, "step_00000003", "leaf_00000.npy")
    with open(leaf, "r+b") as f:
        f.truncate(8)
    os.remove(os.path.join(tmp_path, "step_00000002", "manifest.json"))
    assert valid_steps(str(tmp_path)) == [1, 3]
    _, manifest, step = restore_latest(str(tmp_path))
    assert step == 1 and manifest["extra"]["v"] == 1
    _, _, step = restore_latest(str(tmp_path), like=tree())
    assert step == 1
    with open(os.path.join(tmp_path, "step_00000001", "leaf_00000.npy"),
              "r+b") as f:
        f.truncate(8)
    with pytest.raises(FileNotFoundError):
        restore_latest(str(tmp_path))


def test_gc_spares_newest_and_just_written(tmp_path):
    for s in (1, 2, 3):
        save_checkpoint(str(tmp_path), s, tree())
    ck = AsyncCheckpointer(str(tmp_path), keep=1)
    ck._gc(just_wrote=2)
    assert valid_steps(str(tmp_path)) == [2, 3]
    ck._gc(just_wrote=3)
    assert valid_steps(str(tmp_path)) == [3]
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".gc")]


def test_async_checkpointer_surfaces_writer_error_on_wait(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=3)
    ck.save(1, tree())
    ck.wait()
    with crash_at("checkpoint:mid_write"):
        ck.save(2, tree())
        with pytest.raises(InjectedFault):
            ck.wait()
    ck.wait()
    assert valid_steps(str(tmp_path)) == [1]
    ck.save(3, tree())
    ck.wait()
    assert valid_steps(str(tmp_path)) == [1, 3]


# ---------------------------------------------------------------------------
# the on-disk form, shared with the reference package
# ---------------------------------------------------------------------------

NESTED = {"z": [np.arange(3), (np.ones((2, 2)), np.int64(4))],
          "a": {"y": np.zeros(2, np.uint32), "b": None, "x": [np.arange(2.0)]},
          "ring/words": np.arange(6, dtype=np.uint32).reshape(2, 3)}


def test_leaf_paths_match_the_reference_flattening():
    paths, leaves = flatten_with_paths(NESTED)
    flat, _ = jax.tree_util.tree_flatten_with_path(NESTED)
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
            for kp, _ in flat]
    assert paths == want
    for got, (_, w) in zip(leaves, flat):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(w))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_directories_load_in_either_package(writer, tmp_path):
    save = save_checkpoint if writer == "port" else j_save
    save(str(tmp_path), 3, NESTED, extra={"kind": writer})
    for load in (load_checkpoint, j_load):
        flat, manifest = load(str(tmp_path), 3)
        assert manifest["step"] == 3 and manifest["extra"] == {"kind": writer}
        assert sorted(flat) == sorted(flatten_with_paths(NESTED)[0])
        np.testing.assert_array_equal(flat["ring/words"], NESTED["ring/words"])
        assert flat["ring/words"].dtype == np.uint32
        np.testing.assert_array_equal(flat["z/1/0"], np.ones((2, 2)))
    like = {"w": jnp.zeros((2, 3), jnp.uint32)}
    save(str(tmp_path), 4, {"w": NESTED["ring/words"]})
    got, _ = restore_checkpoint(str(tmp_path), 4, {"w": np.zeros((2, 3), np.uint32)})
    want, _ = j_restore(str(tmp_path), 4, like)
    np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))


def test_manifests_are_equal_key_for_key(tmp_path):
    t = {"a": np.arange(4, dtype=np.int64), "b": {"c": np.ones(3, np.uint32)}}
    save_checkpoint(str(tmp_path / "port"), 1, t, extra={"e": 1})
    j_save(str(tmp_path / "ref"), 1, t, extra={"e": 1})
    import json
    m = [json.load(open(tmp_path / d / "step_00000001" / "manifest.json"))
         for d in ("port", "ref")]
    assert m[0] == m[1]
