"""Carry the reference package's weights over to the port.

The reference's ``init_params`` returns a pytree of arrays; with its leaves
turned into numpy arrays (``jax.tree.map(np.asarray, params)``) it becomes
the port's parameter dict, key for key, so both packages can run on the
same weights.  Every key, shape and dtype is checked against what the
config asks for; any mismatch raises ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .transformer import _check_ported, stages_meta

__all__ = ["param_shapes", "params_from_numpy"]


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree the config asks for, with a shape at each leaf."""
    _check_ported(cfg)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def norm_shapes(prefix, lead):
        out = {f"{prefix}scale": (*lead, d)}
        if cfg.norm == "layernorm":
            out[f"{prefix}bias"] = (*lead, d)
        return out

    stages = {}
    for i, (_, c) in enumerate(stages_meta(cfg)):
        st = {**norm_shapes("stk_norm1_", (c,)), **norm_shapes("stk_norm2_", (c,)),
              "stk_wq": (c, d, h * hd), "stk_wk": (c, d, kv * hd),
              "stk_wv": (c, d, kv * hd), "stk_wo": (c, h * hd, d)}
        if cfg.mlp_act in ("swiglu", "geglu"):
            st["stk_w_gate"] = (c, d, f)
        if cfg.mlp_act != "none":
            st["stk_w_up"] = (c, d, f)
            st["stk_w_down"] = (c, f, d)
        stages[f"s{i}"] = st
    tree = {"embed": (v, d), "stages": stages,
            "final_norm": norm_shapes("", ())}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, v)
    return tree


def _leaf(arr, shape: Tuple[int, ...], dtype: str, path: str, device):
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{path}: shape {tuple(arr.shape)}, the config asks "
                         f"for {tuple(shape)}")
    if arr.dtype.name != dtype:
        raise ValueError(f"{path}: dtype {arr.dtype.name}, the config asks "
                         f"for {dtype}")
    if dtype == "bfloat16":   # numpy holds bf16 as ml_dtypes' bfloat16
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def params_from_numpy(tree, cfg, device=None) -> Dict[str, Any]:
    """Reference params pytree with numpy leaves -> the port's parameter
    dict on ``device`` (default CUDA).  Raises ``ValueError`` on a missing
    or extra key, or a leaf of the wrong shape or dtype."""
    from ..device import resolve_device
    device = resolve_device(device)

    def walk(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict):
                raise ValueError(f"{path or 'params'}: expected a dict, got "
                                 f"{type(node).__name__}")
            missing, extra = sorted(set(spec) - set(node)), sorted(set(node) - set(spec))
            if missing or extra:
                raise ValueError(f"{path or 'params'}: missing keys {missing}, "
                                 f"unexpected keys {extra}")
            return {k: walk(node[k], spec[k], f"{path}/{k}" if path else k)
                    for k in spec}
        return _leaf(node, spec, cfg.dtype, path, device)

    return walk(tree, param_shapes(cfg), "")
