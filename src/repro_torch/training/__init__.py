"""repro_torch.training — optimizer, train step, checkpoints, gradient
compression and the fault-tolerant runner (the reference package's
``training``, on one device or on a mesh).

* ``optimizer`` — AdamW on dicts of tensors (float32 moments), global-norm
  clipping (of the global gradient on a mesh), the warmup + cosine
  schedule, the ZeRO-1 placement ``zero1_spec_tree``.
* ``train_step`` — ``make_train_step`` (loss and gradients, float32
  microbatch accumulation, the data-axis reduction on a mesh, clipping,
  AdamW) and ``make_eval_step``.
* ``grad_compress`` — int8 / top-k round trips with error feedback and
  ``compressed_psum`` over a mesh axis (a building block: the reference's
  step does not call it, nor does the port's).
* ``checkpoint`` — atomic, asynchronous checkpoints of a tree of arrays in
  the reference's framework-free form (``manifest.json`` + one ``.npy`` per
  leaf), with fallback past torn steps; ``restore_sharded`` onto a mesh.
* ``fault_tolerance`` — ``TrainingRunner`` / ``RunnerConfig``, and
  ``Heartbeat`` / ``HeartbeatMonitor`` / ``WriterStalledError``.
"""
from .checkpoint import (AsyncCheckpointer, latest_step, load_checkpoint,
                         restore_checkpoint, restore_latest, restore_sharded,
                         save_checkpoint, valid_steps)
from .fault_tolerance import (Heartbeat, HeartbeatMonitor, RunnerConfig,
                              TrainingRunner, WriterStalledError)
from .grad_compress import (compressed_psum, int8_roundtrip, make_compressor,
                            topk_mask)
from .optimizer import (adamw_init, adamw_update, clip_by_global_norm_,
                        global_norm, lr_schedule, zero1_spec_tree)
from .train_step import make_eval_step, make_train_step

__all__ = [
    "AsyncCheckpointer", "latest_step", "load_checkpoint",
    "restore_checkpoint", "restore_latest", "restore_sharded",
    "save_checkpoint", "valid_steps",
    "RunnerConfig", "TrainingRunner",
    "Heartbeat", "HeartbeatMonitor", "WriterStalledError",
    "compressed_psum", "int8_roundtrip", "make_compressor", "topk_mask",
    "adamw_init", "adamw_update", "clip_by_global_norm_", "global_norm",
    "lr_schedule", "zero1_spec_tree",
    "make_eval_step", "make_train_step",
]
