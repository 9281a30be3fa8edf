"""Carry the reference package's weights over to the port.

The reference's ``init_params`` returns a pytree of arrays; with its leaves
turned into numpy arrays (``jax.tree.map(np.asarray, params)``) it becomes
the port's parameter dict, key for key, so both packages can run on the
same weights.  Every key, shape and dtype is checked against what the
config asks for; any mismatch raises ``ValueError``.  Every leaf is in the
config's dtype but an MoE layer's router (``stk_router``) and the SSM's
``stk_ssm_a_log`` and ``stk_ssm_d``, which are float32 in any model, as
the reference keeps them.  The reference's AdamW
state (``adamw_init``'s ``{"mu", "nu", "step"}``, float32 moments, with an
optional float32 ``master`` copy) crosses the same way with
:func:`opt_state_from_numpy`.  With ``mesh`` the params land on a mesh:
each rank keeps its block of every leaf under the reference's placement
rules (``dist.sharding.spec_tree`` of the config's shapes, then
``shard_tree``), cut on the host and moved to ``device``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .transformer import _block, _check_ported, has_attention, stages_meta

# the leaves that are float32 in every model dtype
_FLOAT32_LEAVES = ("/stk_router", "/stk_ssm_a_log", "/stk_ssm_d")

__all__ = ["param_shapes", "params_from_numpy", "opt_state_from_numpy"]


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

    gated = cfg.mlp_act in ("swiglu", "geglu")

    def attn_shapes(c, pre="stk_"):
        return {f"{pre}wq": (c, d, h * hd), f"{pre}wk": (c, d, kv * hd),
                f"{pre}wv": (c, d, kv * hd), f"{pre}wo": (c, h * hd, d)}

    def stage(kind, c):
        st = norm_shapes("stk_norm1_", (c,))
        if has_attention(kind):
            st.update({**norm_shapes("stk_norm2_", (c,)), **attn_shapes(c)})
        if kind == "xdec":
            st.update({**norm_shapes("stk_normx_", (c,)),
                       **attn_shapes(c, "stk_x")})
        if _block(kind) is not None:
            # the block's leaves as its own init makes them, on no storage
            st.update({k: tuple(t.shape) for k, t in _block(kind).init(
                torch.Generator(), cfg, torch.float32, stacked=c,
                device="meta").items()})
        if not has_attention(kind):
            return st
        if kind.endswith("+moe"):
            slots, fs = cfg.n_experts * cfg.expert_split, f // cfg.expert_split
            st["stk_router"] = (c, d, cfg.n_experts)
            st["stk_experts_up"] = (c, slots, d, fs)
            st["stk_experts_down"] = (c, slots, fs, d)
            if gated:
                st["stk_experts_gate"] = (c, slots, d, fs)
        elif cfg.mlp_act != "none":
            if gated:
                st["stk_w_gate"] = (c, d, f)
            st["stk_w_up"] = (c, d, f)
            st["stk_w_down"] = (c, f, d)
        return st

    tree = {"embed": (v, d),
            "stages": {f"s{i}": stage(kind, c)
                       for i, (kind, c) in enumerate(stages_meta(cfg))},
            "final_norm": norm_shapes("", ())}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, v)
    if cfg.n_encoder_layers:
        tree["enc_stages"] = {"e0": stage("enc", cfg.n_encoder_layers)}
        tree["enc_final_norm"] = norm_shapes("", ())
        tree["enc_pos"] = (cfg.encoder_len, d)
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


def _leaf_dtype(path: str, dtype: str) -> str:
    """The dtype a leaf must have: the router and the SSM's ``a_log`` and
    ``d`` stay float32."""
    return "float32" if path.endswith(_FLOAT32_LEAVES) else dtype


def _walk(node, spec, path, dtype, device):
    if isinstance(spec, dict):
        if not isinstance(node, dict):
            raise ValueError(f"{path or 'params'}: expected a dict, got "
                             f"{type(node).__name__}")
        missing, extra = sorted(set(spec) - set(node)), sorted(set(node) - set(spec))
        if missing or extra:
            raise ValueError(f"{path or 'params'}: missing keys {missing}, "
                             f"unexpected keys {extra}")
        return {k: _walk(node[k], spec[k], f"{path}/{k}" if path else k,
                         dtype, device) for k in spec}
    return _leaf(node, spec, _leaf_dtype(path, dtype), path, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def params_from_numpy(tree, cfg, device=None, mesh=None) -> Dict[str, Any]:
    """Reference params pytree with numpy leaves -> the port's parameter
    dict on ``device`` (default CUDA); with ``mesh``, this rank's block of
    each leaf.  Raises ``ValueError`` on a missing or extra key, or a leaf
    of the wrong shape or dtype."""
    from ..device import resolve_device
    device = resolve_device(device)
    if mesh is None:
        return _walk(tree, param_shapes(cfg), "", cfg.dtype, device)
    from ..dist.sharding import shard_tree, spec_tree
    host = _walk(tree, param_shapes(cfg), "", cfg.dtype, "cpu")
    return _to(shard_tree(host, mesh, spec_tree(param_shapes(cfg), mesh,
                                                cfg.expert_sharding, cfg.mlp_dp)),
               device)


def opt_state_from_numpy(state, cfg, device=None) -> Dict[str, Any]:
    """The reference's AdamW state with numpy leaves (``mu`` and ``nu``
    float32 trees like the params, ``step`` an int32 scalar, optionally a
    float32 ``master`` tree) -> the port's ``adamw_init`` form on
    ``device`` (default CUDA), checked as :func:`params_from_numpy` checks
    the params."""
    from ..device import resolve_device
    device = resolve_device(device)
    if not {"mu", "nu", "step"} <= set(state) <= {"mu", "nu", "step", "master"}:
        raise ValueError(f"expected mu, nu, step (and master), got {sorted(state)}")
    step = np.asarray(state["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step: expected an int32 scalar, got {step.dtype} "
                         f"{step.shape}")
    shapes = param_shapes(cfg)
    out = {k: _walk(state[k], shapes, k, "float32", device)
           for k in ("mu", "nu", "master") if k in state}
    out["step"] = torch.from_numpy(step.copy()).to(device)
    return out
