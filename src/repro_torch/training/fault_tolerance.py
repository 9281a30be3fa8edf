"""Fault-tolerant training runner (checkpoint/restart, failure injection)
and the liveness of long-running worker threads.

:class:`TrainingRunner` drives a train step with the reference's
semantics: batch ``i`` is a pure function of ``i`` (``batch_fn``), the
runner checkpoints params and optimizer state every ``checkpoint_every``
steps in the reference's on-disk form (``checkpoint.AsyncCheckpointer``),
retries a step that raises, restarts from the latest checkpoint when the
retries run out, and beats a :class:`Heartbeat` per completed step.  It
runs where its parameters lie: on the card unless they are CPU tensors.
The train step donates the parameters and optimizer state (AdamW updates
them in place), so a step is retried only when it failed before touching
them; one that raises ``train_step.DonatedStateError`` (a failure inside
the update, e.g. running out of memory part-way) left them part-updated,
and the runner restores the latest checkpoint at once (with none, the error
goes up).

On a mesh (``mesh`` and the params' ``specs``) each rank holds its blocks
and feeds the step its block of ``batch_fn(i)`` (``dist.sharding.
batch_spec``).  A checkpoint holds the *global* arrays, in the same form as
without a mesh (so it crosses between the packages and between meshes):
every rank takes part in gathering them and the lead rank alone writes.
The lead rank picks the step to restore (``collectives.lead_int``), after
its own writes have landed, and every rank loads it and keeps its blocks.
A step that raises on a mesh is not retried: the other ranks may be inside
that step's collectives, and a rank starting it again would pair its
collectives with theirs out of order (sums of like-shaped tensors that are
wrong and raise nothing).  The error goes up, ``launch.mesh.run_ranks``
stops every rank, and a new run resumes from the latest checkpoint.

The serving front end's writer thread (``serving.admission``) beats a
:class:`Heartbeat` once per window slide; a :class:`HeartbeatMonitor`
turns a missed deadline into :class:`WriterStalledError` for the readers
that would otherwise wait on it forever.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..dist import collectives as coll
from ..dist.sharding import (batch_spec, data_axes, gather_tree, is_lead_rank,
                             shard_tree)
from .checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                         restore_sharded)
from .train_step import DonatedStateError

__all__ = ["RunnerConfig", "TrainingRunner", "Heartbeat", "HeartbeatMonitor",
           "WriterStalledError", "batch_block"]


class WriterStalledError(RuntimeError):
    """A monitored worker missed its heartbeat deadline (it is stalled or
    dead); raised to readers that would otherwise wait on it forever."""


class Heartbeat:
    """Monotonic liveness stamp a long-running worker thread beats.

    The worker calls :meth:`beat` once per unit of progress (a window slide)
    and any other thread reads :meth:`age`.  ``clock`` is injectable so
    stall tests are deterministic, never sleep-based.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._last = clock()
        self._step: Optional[int] = None

    def beat(self, step: Optional[int] = None) -> None:
        with self._lock:
            self._last = self._clock()
            if step is not None:
                self._step = int(step)

    @property
    def last_step(self) -> Optional[int]:
        with self._lock:
            return self._step

    def age(self) -> float:
        """Seconds since the last beat."""
        with self._lock:
            return self._clock() - self._last


class HeartbeatMonitor:
    """Declares a worker stalled after ``timeout_s`` without a beat.

    :meth:`check` is pull-based (call it wherever you would otherwise block
    on the worker); the first detection latches, fires ``on_stall(report)``
    once, and every later :meth:`assert_alive` keeps raising — a stalled
    miner is *reported*, not silently waited on.
    """

    def __init__(self, heartbeat: Heartbeat, timeout_s: float,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 name: str = "worker"):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.heartbeat = heartbeat
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.name = name
        self._stalled = False
        self._lock = threading.Lock()

    @property
    def stalled(self) -> bool:
        return self._stalled

    def report(self) -> dict:
        return {"name": self.name, "age_s": self.heartbeat.age(),
                "timeout_s": self.timeout_s,
                "last_step": self.heartbeat.last_step}

    def check(self) -> bool:
        """True once the worker is stalled (latched; ``on_stall`` fires on
        the first detection only)."""
        if self._stalled:
            return True
        if self.heartbeat.age() <= self.timeout_s:
            return False
        with self._lock:
            if self._stalled:
                return True
            self._stalled = True
            hook = self.on_stall
        if hook is not None:
            hook(self.report())
        return True

    def assert_alive(self) -> None:
        if self.check():
            r = self.report()
            raise WriterStalledError(
                f"{self.name} stalled: no heartbeat for {r['age_s']:.2f}s "
                f"(timeout {self.timeout_s:.2f}s, last step "
                f"{r['last_step']})")


@dataclasses.dataclass
class RunnerConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    keep: int = 3
    max_retries_per_step: int = 2
    fail_injector: Optional[Callable[[int], bool]] = None  # tests: step -> bool


def _leaf_device(tree) -> torch.device:
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree.device


def batch_block(batch: dict, device, mesh=None) -> dict:
    """A batch (numpy arrays or tensors) as tensors on ``device``; on a mesh
    this rank's block of it (``dist.sharding.batch_spec`` of its leading
    dim: split over the data axes, or whole when they do not divide it,
    and then marked ``"whole_batch": True`` for the model's MoE routing)."""
    batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                                else v) for k, v in batch.items()}
    whole = False
    if mesh is not None:
        specs = {k: batch_spec(v.shape[0], mesh) for k, v in batch.items()}
        batch = shard_tree(batch, mesh, specs)
        whole = bool(data_axes(mesh)) and all(s == (None,) for s in specs.values())
    out = {k: v.to(device) for k, v in batch.items()}
    if whole:
        out["whole_batch"] = True
    return out


class TrainingRunner:
    """Drives ``step_fn(params, opt_state, batch)`` with checkpoint/restart
    semantics.  ``batch_fn(i)`` gives step ``i``'s batch (numpy arrays or
    tensors), moved here to the parameters' device.

    One difference from the reference, with the same result: when the last
    step of :meth:`run` was just checkpointed, the final save is not
    written again (the reference writes that step twice).

    ``mesh``/``specs``: the runner of one rank of a mesh; ``params`` and
    ``opt_state`` are the rank's blocks under ``specs`` (the params'
    placements; the moments follow their params).  There a step that
    raises is not retried: the error fails the run on every rank."""

    def __init__(self, cfg: RunnerConfig, step_fn, params, opt_state,
                 batch_fn, mesh=None, specs=None):
        if (mesh is None) != (specs is None):
            raise ValueError("TrainingRunner: a mesh needs the params' specs")
        self.mesh, self.specs = mesh, specs
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.batch_fn = batch_fn
        self.device = _leaf_device(params)
        self.ckpt = AsyncCheckpointer(cfg.checkpoint_dir, keep=cfg.keep)
        self.start_step = 0
        self.metrics_log: list = []
        self.heartbeat = Heartbeat()   # beaten per completed step; a
        # supervisor attaches a HeartbeatMonitor to spot a hung step_fn

    def _batch(self, i: int) -> dict:
        return batch_block(self.batch_fn(i), self.device, self.mesh)

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def _state_specs(self) -> dict:
        opt = {k: self.specs if k in ("mu", "nu", "master") else ()
               for k in self.opt_state}
        return {"params": self.specs, "opt": opt}

    def _save(self, step: int) -> None:
        if self.mesh is None:
            self.ckpt.save(step, self._state())
            return
        whole = gather_tree(self._state(), self.mesh, self._state_specs())
        if is_lead_rank(self.mesh):
            self.ckpt.save(step, whole)

    def _latest(self):
        """The newest checkpointed step (None for none): on a mesh the lead
        rank's, once its writes have landed."""
        if self.mesh is None:
            return latest_step(self.cfg.checkpoint_dir)
        step = None
        if is_lead_rank(self.mesh):
            self.ckpt.wait()
            step = latest_step(self.cfg.checkpoint_dir)
        step = coll.lead_int(-1 if step is None else step, self.mesh)
        return None if step < 0 else step

    def maybe_restore(self) -> int:
        step = self._latest()
        if step is None:
            return 0
        if self.mesh is None:
            restored, manifest = restore_checkpoint(
                self.cfg.checkpoint_dir, step, self._state(), into=True)
        else:
            restored, manifest = restore_sharded(
                self.cfg.checkpoint_dir, step, self._state(), self.mesh,
                self._state_specs())
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.start_step = int(manifest["step"])
        return self.start_step

    def run(self, n_steps: int) -> int:
        step = self.maybe_restore()
        end = step + n_steps if self.start_step == 0 else self.start_step + n_steps
        saved = None
        while step < end:
            batch = self._batch(step)
            retries = 0
            while True:
                try:
                    if self.cfg.fail_injector and self.cfg.fail_injector(step) \
                            and retries == 0:
                        raise RuntimeError(f"injected failure at step {step}")
                    self.params, self.opt_state, metrics = self.step_fn(
                        self.params, self.opt_state, batch)
                    break
                except RuntimeError as err:
                    if self.mesh is not None:
                        raise   # fail every rank (module docstring)
                    retries += 1
                    if (isinstance(err, DonatedStateError) or
                            retries > self.cfg.max_retries_per_step):
                        # full restart-from-checkpoint path
                        if self._latest() is None:
                            raise
                        step = self.maybe_restore()
                        batch = self._batch(step)
                        retries = 0
            self.metrics_log.append({k: float(v) for k, v in metrics.items()})
            step += 1
            self.heartbeat.beat(step)
            if step % self.cfg.checkpoint_every == 0:
                self._save(step)
                saved = step
        if saved != step:
            self._save(step)
        self.ckpt.wait()
        return step
