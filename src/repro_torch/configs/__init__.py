"""Architecture registry of the port: the configs whose layer kinds the port
runs (``attn`` and ``local`` decoder layers).

Every config is importable as ``repro_torch.configs.<module>.CONFIG`` and
selectable via ``get_config("<arch-id>")`` / ``--arch <id>``.  The modules
are copies of the reference package's; source citations are in each
module's docstring.  The reference's other architectures (MoE, SSM, xLSTM,
hybrid, encoder-decoder, vision) wait for ROADMAP item 12.
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
        raise NotImplementedError(
            f"config {name!r} is not ported to repro_torch (ported: "
            f"{sorted(_REGISTRY)}); the other architectures wait for "
            f"ROADMAP item 12")
    return _REGISTRY[name]


def list_configs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import gemma3_4b, gemma_2b  # noqa: F401


__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "SHAPES",
           "get_config", "list_configs", "register"]
