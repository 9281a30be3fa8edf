"""Architecture registry of the port, every architecture of the reference
package: ``attn`` and ``local`` decoder layers, with a dense MLP or a
mixture of experts (gemma3-4b, gemma-2b, internlm2-20b, command-r-35b,
grok-1-314b and llama4-maverick-400b-a17b, for serving and for training;
phi-3-vision-4.2b, whose loss takes an image prefix), xLSTM's ``mlstm``
and ``slstm`` blocks (xlstm-1.3b), hymba's ``hybrid`` layers, attention
beside a selective SSM (hymba-1.5b), and whisper's ``enc`` and ``xdec``
layers, an encoder and a decoder with cross-attention (whisper-base,
served and trained on one device).

Every config is importable as ``repro_torch.configs.<module>.CONFIG`` and
selectable via ``get_config("<arch-id>")`` / ``--arch <id>``.  The modules
are copies of the reference package's; source citations are in each
module's docstring.
"""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, TrainConfig

_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        # a KeyError, as the reference's registry raises
        raise KeyError(f"no config {name!r} (registered: {sorted(_REGISTRY)})")
    return _REGISTRY[name]


def list_configs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import (command_r_35b, gemma3_4b, gemma_2b,  # noqa: F401
                   grok_1_314b, hymba_1_5b, internlm2_20b,
                   llama4_maverick_400b, phi3_vision_4_2b, whisper_base,
                   xlstm_1_3b)


__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "SHAPES",
           "get_config", "list_configs", "register"]
