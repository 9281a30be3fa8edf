"""repro_torch.training — checkpoints and worker liveness.

* ``checkpoint`` — atomic, asynchronous checkpoints of a tree of arrays in
  the reference's framework-free form (``manifest.json`` + one ``.npy`` per
  leaf), with fallback past torn steps.
* ``fault_tolerance`` — ``Heartbeat`` / ``HeartbeatMonitor`` /
  ``WriterStalledError``, the liveness of the serving writer.

The optimizer, train step, gradient compression and ``TrainingRunner`` of
the reference's ``training`` package wait for ROADMAP item 12.
"""
from .checkpoint import (AsyncCheckpointer, latest_step, load_checkpoint,
                         restore_checkpoint, restore_latest, save_checkpoint,
                         valid_steps)
from .fault_tolerance import Heartbeat, HeartbeatMonitor, WriterStalledError

__all__ = [
    "AsyncCheckpointer", "latest_step", "load_checkpoint",
    "restore_checkpoint", "restore_latest", "save_checkpoint", "valid_steps",
    "Heartbeat", "HeartbeatMonitor", "WriterStalledError",
]
