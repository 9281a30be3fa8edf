"""Atomic, asynchronous checkpoints of a tree of arrays.

Layout: one directory per step, ``step_%08d``, holding ``manifest.json``
(step, leaf paths, shapes, dtypes, a JSON ``extra``) plus one ``.npy`` per
leaf.  The form does not depend on the framework and is the reference
package's, key for key: a directory written by either package loads in the
other.  Writes go to a temporary directory that is atomically renamed, so a
crash mid-write never corrupts the latest checkpoint.  The checkpoint holds
logical content only, never a device layout: a restore places each leaf on
whatever ``device`` the restoring process names.

Crash-consistency contract (DESIGN.md §10):

- the manifest is written *last* inside the temporary directory and
  fsynced, so a step directory with a readable manifest holds every leaf it
  names;
- only directories with a readable manifest count as steps
  (``valid_steps``), so torn temporary directories and half-deleted GC
  victims are invisible to restore;
- overwriting an existing step renames the old directory aside before the
  new one lands — the step name never points at a partially-deleted tree;
- :func:`restore_latest` walks steps newest-first and falls back past any
  step whose manifest or leaves fail to load, so a crash *anywhere* in the
  writer loses at most the step in flight.

A tree is a nest of dicts, lists and tuples; every other value is a leaf
(a numpy array, a torch tensor or a scalar).  A bfloat16 leaf is written as
the reference writes one (``np.save`` of ml_dtypes' bfloat16 gives raw
2-byte records, ``V2``, with ``"bfloat16"`` in the manifest) and comes back
as a bfloat16 tensor, bit for bit.  Leaf paths join the dict keys
and sequence indices with ``/``, dict keys in sorted order — the paths the
reference's ``jax.tree_util.tree_flatten_with_path`` gives the same tree.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..faults import kill_point

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_sharded",
           "load_checkpoint", "restore_latest", "latest_step", "valid_steps",
           "AsyncCheckpointer", "flatten_with_paths"]

_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"step_(\d+)")


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{int(step):08d}")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(key, child)`` pairs of a container node in flattening order, or
    ``None`` for a leaf.  ``None`` itself is an empty node, as in jax."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree) -> Tuple[List[str], List[Any]]:
    """``(paths, leaves)`` of ``tree`` in flattening order."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            paths.append("/".join(prefix))
            leaves.append(node)
            return
        for key, child in kids:
            walk(child, prefix + [key])

    walk(tree, [])
    return paths, leaves


def _map_with_paths(tree, fn: Callable[[str, Any], Any], prefix=()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn("/".join(prefix), tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(tree[k], fn, prefix + (str(k),))
                for k in tree}
    out = [_map_with_paths(v, fn, prefix + (str(i),)) for i, v in enumerate(tree)]
    return type(tree)(out) if isinstance(tree, tuple) else out


_BF16_RECORD = np.dtype("V2")


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array: a tensor is copied (synchronously; a
    host tensor too, whose ``numpy()`` would share its memory), anything
    else goes through ``np.asarray``.  A bfloat16 tensor becomes its raw
    2-byte records (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RECORD)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_RECORD else str(arr.dtype)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A loaded leaf as a host tensor; 2-byte records are bfloat16."""
    arr = np.array(arr, order="C")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    return _write_leaves(directory, step, *flatten_with_paths(tree), extra)


def _write_leaves(directory: str, step: int, paths, leaves, extra) -> str:
    """Write ``leaves`` (a list, which this empties: each leaf is let go
    once it is written, so a host tree the size of grok's state is never
    held twice beside its files) as step ``step`` of ``directory``."""
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    manifest = {"step": int(step), "leaves": [], "extra": extra or {}}
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        arr = _to_host(leaf)
        fname = _leaf_name(i)
        np.save(os.path.join(tmp, fname), arr)
        leaves[i] = None
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape),
             "dtype": _dtype_name(arr)})
    kill_point("checkpoint:mid_write")   # leaves down, manifest not yet
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    kill_point("checkpoint:pre_replace")  # complete tmp, not yet visible
    final = _step_dir(directory, step)
    if os.path.exists(final):
        # re-saving an existing step: rename the old directory aside first so
        # the step name never points at a partially-deleted tree (a crash
        # between the two renames hides the step; restore falls back)
        doomed = final + ".old"
        shutil.rmtree(doomed, ignore_errors=True)
        os.replace(final, doomed)
        os.replace(tmp, final)
        shutil.rmtree(doomed, ignore_errors=True)
    else:
        os.replace(tmp, final)
    return final


def valid_steps(directory: str) -> List[int]:
    """Steps whose directory holds a readable manifest, ascending.  Torn
    temporary directories, GC-renamed victims and manifests cut off
    mid-write are excluded."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.fullmatch(d)
        if not m:
            continue
        try:
            with open(os.path.join(directory, d, _MANIFEST)) as f:
                json.load(f)
        except (OSError, ValueError):
            continue
        steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = valid_steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, step: int) -> Tuple[Dict[str, np.ndarray], dict]:
    """Self-describing restore, no ``like`` tree needed: returns
    ``({leaf_path: host_array}, manifest)``."""
    ckpt_dir = _step_dir(directory, step)
    with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    out = {e["path"]: np.load(os.path.join(ckpt_dir, e["file"]))
           for e in manifest["leaves"]}
    return out, manifest


def restore_checkpoint(directory: str, step: int, like: Any,
                       device: Optional[torch.device] = None, into: bool = False):
    """Restore into the structure of ``like``.  Each leaf takes its ``like``
    leaf's dtype; it comes back as a tensor on ``device`` when one is named,
    on the ``like`` leaf's device when that leaf is a tensor, and as a host
    numpy array otherwise.  ``into``: copy each leaf into its ``like``
    tensor in place, one at a time (a runner's own state: a second tree on
    the card is never alive).  Returns ``(tree, manifest)``."""
    ckpt_dir = _step_dir(directory, step)
    with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(path, leaf):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = np.load(os.path.join(ckpt_dir, entry["file"]))
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(want)}")
        if isinstance(leaf, torch.Tensor):
            if into:
                return leaf.copy_(_to_tensor(arr))
            t = _to_tensor(arr).to(leaf.dtype)
            return t.to(device if device is not None else leaf.device)
        arr = arr.astype(np.asarray(leaf).dtype)
        return arr if device is None else torch.from_numpy(arr).to(device)

    return _map_with_paths(like, load), manifest


def restore_sharded(directory: str, step: int, like: Any, mesh, specs):
    """Restore a checkpoint of *global* arrays (any package's, any mesh's or
    none) onto ``mesh``: each leaf is loaded whole on the host, cut to this
    rank's block under ``specs`` (a tree like ``like``; see
    ``dist.sharding.shard_tree``) and placed on the ``like`` leaf's device
    in its dtype.  ``like`` holds this rank's blocks, so each loaded shape
    must split into them.  Returns ``(tree, manifest)``."""
    from ..dist.sharding import shard_tree
    ckpt_dir = _step_dir(directory, step)
    with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(path, leaf):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        return _to_tensor(np.load(os.path.join(ckpt_dir, entry["file"])))

    host = _map_with_paths(like, load)
    blocks = shard_tree(host, mesh, specs)

    def place(path, block, leaf):
        if tuple(block.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: this rank's block {tuple(block.shape)} "
                             f"!= {tuple(leaf.shape)}")
        return block.to(device=leaf.device, dtype=leaf.dtype)

    flat_b = dict(zip(*flatten_with_paths(blocks)))
    return _map_with_paths(like, lambda p, leaf: place(p, flat_b[p], leaf)), manifest


def restore_latest(directory: str, like: Any = None,
                   device: Optional[torch.device] = None):
    """Restore the newest step that actually loads, falling back past any
    partially-written or corrupt step (truncated leaf, missing file, bad
    manifest).  With ``like=None`` returns ``(path_map, manifest, step)``
    from :func:`load_checkpoint`; otherwise ``(tree, manifest, step)``."""
    last_err: Optional[BaseException] = None
    for step in reversed(valid_steps(directory)):
        try:
            if like is None:
                flat, manifest = load_checkpoint(directory, step)
            else:
                flat, manifest = restore_checkpoint(directory, step, like,
                                                    device)
            return flat, manifest, step
        except (OSError, ValueError, KeyError) as e:
            last_err = e
    raise FileNotFoundError(
        f"no restorable checkpoint under {directory!r}") from last_err


class AsyncCheckpointer:
    """Checkpoint writes on a background thread, with a queue of one (a new
    save waits for the previous to land).  ``save`` copies every tensor leaf
    to the host first, on the caller's thread, so those may change (or be
    freed) as soon as it returns; numpy leaves are written as they are, so
    the caller hands them over until :meth:`wait` (the miner's snapshot
    gives fresh copies).  The write runs behind.
    ``last_write_s`` is the wall time of the last write that landed (the
    directory write, rename and GC, on the writer thread)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.last_write_s: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._gc_lock = threading.Lock()

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        paths, leaves = flatten_with_paths(
            _map_with_paths(tree, lambda _p, leaf: _to_host(leaf)))

        def _write():
            try:
                t0 = time.perf_counter()
                _write_leaves(self.directory, step, paths, leaves, extra)
                self._gc(just_wrote=int(step))
                self.last_write_s = time.perf_counter() - t0
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self, just_wrote: Optional[int] = None):
        """Keep the newest ``keep`` valid steps.  Serialized under a lock so
        two checkpointers on one directory cannot both collect; victims are
        renamed out of the step namespace *before* deletion, so a concurrent
        ``restore_latest`` sees a step completely or not at all.  Steps at or
        above a save that just landed are never collected."""
        with self._gc_lock:
            steps = valid_steps(self.directory)
            doomed = steps[:-self.keep] if self.keep > 0 else steps
            for s in doomed:
                if just_wrote is not None and s >= just_wrote:
                    continue
                path = _step_dir(self.directory, s)
                trash = path + ".gc"
                try:
                    os.replace(path, trash)
                except OSError:
                    continue    # another collector got it first
                shutil.rmtree(trash, ignore_errors=True)
