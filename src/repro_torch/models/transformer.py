"""Model assembly: stages, forward passes, prefill and decode.

The port of the reference package's ``models/transformer.py`` for dense
decoders (layer kinds ``attn`` and ``local``).  The per-layer kind list
(``ModelConfig.layer_pattern``) is run-length grouped into *stages*; a
stage's weights are stacked along a leading axis (``stk_wq`` is
``(count, d, h * hd)``), with the reference's parameter keys, and the
reference's ``lax.scan`` over a stage becomes a Python loop over that axis.
Every other layer kind (MoE, SSM, xLSTM, hybrid, encoder-decoder) waits for
ROADMAP item 12 and raises ``NotImplementedError``, as do training
(``loss``) and the cost-analysis mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from .attention import attention, init_attention
from .attention import init_cache as kv_init_cache
from .layers import init_norm, norm
from .mlp import init_mlp, mlp

__all__ = ["stages_meta", "init_params", "Model", "PORTED_KINDS"]

PORTED_KINDS = ("attn", "local")


def stages_meta(cfg) -> List[Tuple[str, int]]:
    """Run-length encode the layer pattern into (kind, count) stages."""
    stages: List[Tuple[str, int]] = []
    for kind in cfg.layer_pattern():
        if stages and stages[-1][0] == kind:
            stages[-1] = (kind, stages[-1][1] + 1)
        else:
            stages.append((kind, 1))
    return stages


def _check_ported(cfg) -> None:
    bad = sorted({k for k, _ in stages_meta(cfg) if k not in PORTED_KINDS})
    if bad or cfg.n_encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {bad or ['enc']} are not ported to "
            f"repro_torch (it runs {list(PORTED_KINDS)}); the other families "
            "wait for ROADMAP item 12")


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer_stack(generator, cfg, kind: str, count: int,
                      device) -> Dict[str, torch.Tensor]:
    dtype = _dtype(cfg)
    p: Dict[str, torch.Tensor] = {}

    def add_norm(name):
        for k, v in init_norm(cfg.d_model, cfg.norm, dtype, device).items():
            p[f"stk_{name}_{k}"] = v[None].expand(count, *v.shape).contiguous()

    add_norm("norm1")
    p.update(init_attention(generator, cfg, dtype, stacked=count,
                            device=device))
    add_norm("norm2")
    if cfg.mlp_act != "none":
        p.update(init_mlp(generator, cfg, dtype, stacked=count, device=device))
    return p


def init_params(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random weights with the reference's scales, drawn from an explicit
    ``generator`` (which must live on ``device``).  Same tree and shapes as
    the reference's ``init_params``; the numbers differ, since a
    ``torch.Generator`` is not ``jax.random``: carry the reference's weights
    over with :func:`..models.convert.params_from_numpy` to compare."""
    _check_ported(cfg)
    dtype = _dtype(cfg)
    embed = (torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                         dtype=torch.float32, device=device) * 0.02).to(dtype)
    params: Dict[str, Any] = {
        "embed": embed,
        "stages": {f"s{i}": _init_layer_stack(generator, cfg, kind, count, device)
                   for i, (kind, count) in enumerate(stages_meta(cfg))},
        "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=generator,
            dtype=torch.float32, device=device) * cfg.d_model ** -0.5).to(dtype)
    return params


# ---------------------------------------------------------------------------
# stage execution
# ---------------------------------------------------------------------------

def _sub(lp: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k.split("_", 1)[1]: v for k, v in lp.items() if k.startswith(prefix)}


def _layer_forward(lp: Dict[str, torch.Tensor], x, cfg, kind: str, *,
                   cache=None, pos=None):
    """One layer.  Returns (x, cache)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported (ROADMAP item 12)")
    window = cfg.window if kind == "local" else 0
    h = norm(_sub(lp, "norm1"), x, cfg.norm)
    attn_out, cache = attention(lp, h, cfg, window=window, cache=cache, pos=pos)
    if cfg.parallel_block:
        ff_in = h
    else:
        x = x + attn_out
        ff_in = norm(_sub(lp, "norm2"), x, cfg.norm)
    ff_out = mlp(lp, ff_in, cfg) if cfg.mlp_act != "none" else torch.zeros_like(x)
    x = x + attn_out + ff_out if cfg.parallel_block else x + ff_out
    return x, cache


def run_stage(stage_params, x, cfg, kind: str, *, cache=None, pos=None):
    """Run the stacked layers of one stage in order.  Returns (x, cache);
    a given cache is written in place, layer ``i`` into its slice ``i``."""
    count = next(iter(stage_params.values())).shape[0]
    for i in range(count):
        lp = {k[4:]: v[i] for k, v in stage_params.items()}
        c = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i]}
        x, _ = _layer_forward(lp, x, cfg, kind, cache=c, pos=pos)
    return x, cache


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    """Functional model handle for one architecture config."""

    cfg: Any

    def __post_init__(self):
        _check_ported(self.cfg)

    def embed(self, params, tokens):
        x = params["embed"][tokens]
        if self.cfg.scale_embed:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def logits_last(self, params, h):
        """(B, S, D) -> (B, 1, V) float32 logits of the last position, the
        product in float32 as the reference computes it."""
        w = params["embed"] if self.cfg.tie_embeddings else params["lm_head"]
        w = w.float()
        return h[:, -1:].float() @ (w.t() if self.cfg.tie_embeddings else w)

    def backbone(self, params, x, *, cache=None, pos=None):
        cfg = self.cfg
        for i, (kind, _) in enumerate(stages_meta(cfg)):
            sname = f"s{i}"
            x, _ = run_stage(params["stages"][sname], x, cfg, kind,
                             cache=None if cache is None else cache[sname],
                             pos=pos)
        return norm(params["final_norm"], x, cfg.norm), cache

    def init_cache(self, batch: int, s_max: int, dtype=torch.bfloat16,
                   device=None):
        """Per-stage KV cache: {"s<i>": {"k", "v"}} of
        (count, batch, s_max, KV, D)."""
        return {f"s{i}": kv_init_cache(self.cfg, batch, s_max, count, dtype,
                                       device)
                for i, (_, count) in enumerate(stages_meta(self.cfg))}

    def prefill(self, params, batch, s_max: int):
        """Encode a full prompt, returning (last-token logits, filled cache)."""
        tokens = batch["tokens"]
        b = tokens.shape[0]
        device = params["embed"].device
        x = self.embed(params, tokens)
        cache = self.init_cache(b, s_max, _dtype(self.cfg), device)
        pos = torch.zeros((b,), dtype=torch.int32, device=device)
        h, cache = self.backbone(params, x, cache=cache, pos=pos)
        return self.logits_last(params, h), cache

    def decode_step(self, params, token, cache, pos):
        """One token step.  token: (B, 1); pos: (B,) current write index.
        The cache is written in place and returned."""
        x = self.embed(params, token)
        h, cache = self.backbone(params, x, cache=cache, pos=pos)
        return self.logits_last(params, h), cache
