"""Periodic, non-blocking persistence for the streaming miner.

Bridges the miner's state contract (:class:`~repro_torch.streaming.miner.
MinerState`, DESIGN.md §10) onto ``training.checkpoint``: a snapshot is
taken synchronously on the stream thread (host copies), then written by
``AsyncCheckpointer`` off-thread so the next slide never waits on disk.

Checkpoint step semantics: step ``s`` is the state *after* ``s`` completed
slides.  ``data.stream.transaction_stream`` is deterministic in its
arguments, so recovery is restore-at-``s`` + replay batches ``s..``.

The directories are the reference package's, key for key, so either
package restores the other's.  Backend names are translated here and
nowhere else: the port's ``fused`` / ``ref`` are written as the reference's
``pallas`` / ``jnp`` and read back the other way.

On a mesh every rank holds the same logical state (the host mirror, the
``int64`` count matrix, the class bookkeeping), so only the lead rank
(``dist.sharding.is_lead_rank``) writes.  On restore the lead rank picks
the step and every other rank takes it from one broadcast per mesh axis,
so every rank loads the same step; those broadcasts are the restore's
only collectives, recorded in ``miner.restore_stats["collectives"]``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Tuple

from ..device import DeviceLike
from ..dist import collectives as coll
from ..dist.sharding import is_lead_rank
from ..training.checkpoint import (AsyncCheckpointer, load_checkpoint,
                                   restore_latest, valid_steps)
from .miner import MinerState, StreamConfig, StreamingMiner

__all__ = ["StreamCheckpointer", "restore_miner", "peek_config"]

# the port's single-device backend names -> the reference's
TO_REFERENCE = {"fused": "pallas", "ref": "jnp"}
FROM_REFERENCE = {v: k for k, v in TO_REFERENCE.items()}


def _renamed(extra: dict, names: dict) -> dict:
    """A MinerState extra with its three backend names mapped by ``names``
    (names outside the map pass through)."""
    out = dict(extra, config=dict(extra["config"]), engine=dict(extra["engine"]))
    out["config"]["backend"] = names.get(out["config"]["backend"],
                                         out["config"]["backend"])
    for key in ("backend", "inner"):
        out["engine"][key] = names.get(out["engine"][key], out["engine"][key])
    return out


class StreamCheckpointer:
    """Snapshot-and-write-behind for a :class:`StreamingMiner`.

    ``save(miner, step)`` is cheap on the caller's thread (host deep copies
    via ``snapshot_state``); the directory write, atomic rename and GC run
    on the :class:`AsyncCheckpointer` background thread.  ``every`` gates
    :meth:`maybe_save` to one checkpoint per N slides.  Call :meth:`wait`
    before reading the directory or exiting: it joins the write in flight
    and re-raises any writer error.  On a mesh only the lead rank writes;
    the others' saves do nothing.  ``last_save`` holds the seconds the last
    snapshot took on the caller's thread (``snapshot_s``: the host copies
    and the tree) and the write that ran behind it (``write_s``, once
    :meth:`wait` has seen it land).
    """

    def __init__(self, directory: str, *, every: int = 1, keep: int = 3):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = int(every)
        self._ckpt = AsyncCheckpointer(directory, keep=keep)
        self.last_save: dict = {}

    @property
    def directory(self) -> str:
        return self._ckpt.directory

    def save(self, miner: StreamingMiner, step: int) -> None:
        if not is_lead_rank(miner.mesh):
            return
        t0 = time.perf_counter()
        tree, extra = miner.snapshot_state().to_tree()
        snapshot_s = time.perf_counter() - t0
        self._ckpt.save(int(step), tree, extra=_renamed(extra, TO_REFERENCE))
        self.last_save = {"step": int(step), "snapshot_s": snapshot_s}

    def maybe_save(self, miner: StreamingMiner, step: int) -> bool:
        """Save iff ``step`` lands on the cadence; returns whether it did."""
        if int(step) % self.every != 0:
            return False
        self.save(miner, step)
        return True

    def wait(self) -> None:
        self._ckpt.wait()
        if self.last_save:
            self.last_save["write_s"] = self._ckpt.last_write_s


def _lead_step(directory: str, mesh):
    """The step every rank restores and, on the lead rank, its loaded
    ``(flat, manifest)``: the lead rank takes the newest restorable step
    (falling back past torn ones) and broadcasts it."""
    loaded, step = None, -1
    if is_lead_rank(mesh):
        try:
            flat, manifest, step = restore_latest(directory)
            loaded = (flat, manifest)
        except FileNotFoundError:
            pass
    step = coll.lead_int(step, mesh)
    if step < 0:
        raise FileNotFoundError(f"no restorable checkpoint under {directory!r}")
    return step, loaded


def restore_miner(
    directory: str,
    mesh=None,
    *,
    backend: Optional[str] = None,
    shard: Optional[str] = None,
    keep_transactions: Optional[bool] = None,
    device: DeviceLike = None,
) -> Tuple[StreamingMiner, int]:
    """Rebuild a miner from the newest restorable checkpoint in
    ``directory`` (falling back past torn or corrupt steps) under whatever
    ``mesh`` / ``backend`` / ``shard`` the restoring process brings, on
    ``device`` (``None`` = CUDA) — the re-meshing entry point of the
    stream driver's ``--restore`` / ``--remesh``.  A directory written by
    the reference package restores as it is.  Returns ``(miner,
    completed_slides)``; resume by replaying the deterministic stream from
    ``completed_slides``.  ``miner.restore_stats`` holds the step, the
    restore's wall seconds and its collectives."""
    t0 = time.perf_counter()
    before = coll.collective_counts()
    step, loaded = _lead_step(directory, mesh)
    flat, manifest = loaded if loaded is not None else load_checkpoint(directory, step)
    state = MinerState.from_tree(flat, _renamed(manifest["extra"], FROM_REFERENCE))
    miner = StreamingMiner.from_state(state, mesh=mesh, backend=backend,
                                      shard=shard,
                                      keep_transactions=keep_transactions,
                                      device=device)
    miner.restore_stats = {"step": int(manifest["step"]),
                           "restore_s": time.perf_counter() - t0,
                           "collectives": coll.counts_since(before)}
    return miner, int(manifest["step"])


def peek_config(directory: str) -> Tuple[StreamConfig, int]:
    """The (StreamConfig, completed_slides) of the newest valid checkpoint,
    from its manifest alone (no array loads), with the port's backend
    names — `launch.stream` reads this first to decide which mesh to build
    before calling :func:`restore_miner`."""
    fields = {f.name for f in dataclasses.fields(StreamConfig)}
    for step in reversed(valid_steps(directory)):
        try:
            path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
            with open(path) as f:
                manifest = json.load(f)
            cfg_kw = {k: v for k, v in manifest["extra"]["config"].items()
                      if k in fields}
            cfg_kw["backend"] = FROM_REFERENCE.get(cfg_kw["backend"],
                                                   cfg_kw["backend"])
            return StreamConfig(**cfg_kw), int(manifest["step"])
        except (OSError, ValueError, KeyError, TypeError):
            continue
    raise FileNotFoundError(f"no readable checkpoint manifest under "
                            f"{directory!r}")
