"""Reduced (smoke-test) variants of the assigned configs.

Same family/topology, tiny widths: used by per-arch CPU smoke tests and the
examples.  Full-size configs are only ever lowered abstractly via the
dry-run (ShapeDtypeStruct — no allocation), per the assignment.
"""
from __future__ import annotations

import dataclasses

from .base import ModelConfig

__all__ = ["reduced_config"]


def reduced_config(cfg: ModelConfig, *, d_model: int = 64, vocab: int = 256) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        n_layers=(cfg.local_per_global + 1) if cfg.local_per_global
        else min(cfg.n_layers, 4),
        d_model=d_model,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
        d_head=d_model // 4,
        d_ff=d_model * 2 if cfg.d_ff else 0,
        vocab_size=vocab,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        window=min(cfg.window, 8) if cfg.window else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_len=16 if cfg.encoder_len else 0,
        frontend_len=4 if cfg.frontend_len else 0,
        slstm_every=min(cfg.slstm_every, 2) if cfg.slstm_every else 0,
        dtype="float32",
    )
