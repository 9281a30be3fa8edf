"""repro_torch.training — optimizer, train step, checkpoints, gradient
compression and the fault-tolerant runner (the reference package's
``training`` on one device).

* ``optimizer`` — AdamW on dicts of tensors (float32 moments), global-norm
  clipping, the warmup + cosine schedule.
* ``train_step`` — ``make_train_step`` (loss and gradients, float32
  microbatch accumulation, clipping, AdamW) and ``make_eval_step``.
* ``grad_compress`` — int8 / top-k round trips with error feedback and
  ``compressed_psum`` over a mesh axis (for mesh training, which waits for
  ROADMAP item 12, as does ``zero1_spec_tree``).
* ``checkpoint`` — atomic, asynchronous checkpoints of a tree of arrays in
  the reference's framework-free form (``manifest.json`` + one ``.npy`` per
  leaf), with fallback past torn steps.
* ``fault_tolerance`` — ``TrainingRunner`` / ``RunnerConfig``, and
  ``Heartbeat`` / ``HeartbeatMonitor`` / ``WriterStalledError``.
"""
from .checkpoint import (AsyncCheckpointer, latest_step, load_checkpoint,
                         restore_checkpoint, restore_latest, save_checkpoint,
                         valid_steps)
from .fault_tolerance import (Heartbeat, HeartbeatMonitor, RunnerConfig,
                              TrainingRunner, WriterStalledError)
from .grad_compress import (compressed_psum, int8_roundtrip, make_compressor,
                            topk_mask)
from .optimizer import (adamw_init, adamw_update, clip_by_global_norm,
                        global_norm, lr_schedule)
from .train_step import make_eval_step, make_train_step

__all__ = [
    "AsyncCheckpointer", "latest_step", "load_checkpoint",
    "restore_checkpoint", "restore_latest", "save_checkpoint", "valid_steps",
    "RunnerConfig", "TrainingRunner",
    "Heartbeat", "HeartbeatMonitor", "WriterStalledError",
    "compressed_psum", "int8_roundtrip", "make_compressor", "topk_mask",
    "adamw_init", "adamw_update", "clip_by_global_norm", "global_norm",
    "lr_schedule",
    "make_eval_step", "make_train_step",
]
