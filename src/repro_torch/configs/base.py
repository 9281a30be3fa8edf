"""Config dataclasses shared by every architecture and the launch stack.

A copy of the reference package's ``configs/base.py`` (plain Python data),
kept here so the port never imports the reference package."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Field semantics follow the assignment table.

    ``layer_pattern`` drives the stage grouping in ``models.transformer``:
    a list of layer-kind strings, e.g. 34 entries of
    ["local"]*5 + ["attn"] repeating for gemma3.  Homogeneous runs of the
    same kind become one stage whose weights are stacked along a leading
    axis.
    """

    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads
    # attention
    attn_pattern: str = "global"   # global | window | local_global
    window: int = 0                # sliding window size for local layers
    local_per_global: int = 0      # gemma3: 5 local then 1 global
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    # block composition
    parallel_block: bool = False   # command-r / GPT-J style attn ∥ mlp
    seq_parallel: bool = False     # Megatron-SP: residual sharded over 'model' on seq
    mlp_dp: bool = False           # replicate FFN weights over 'model', compute on
                                   # seq-sharded activations (needs seq_parallel):
                                   # trades activation ARs for weight-grad ARs
    mlp_act: str = "swiglu"        # swiglu | geglu | gelu | none
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = True
    scale_embed: bool = False   # gemma: embed * sqrt(d_model)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # llama4: MoE every 2nd layer (interleaved)
    capacity_factor: float = 1.25
    expert_sharding: str = "ep"    # ep (experts over data) | tp2d (ffn over data+model)
    moe_dispatch: str = "local"    # local (per-shard sort + a2a) | global (naive)
    expert_split: int = 1          # expert fission: split each expert into N
                                   # half-d_ff slots so E*N divides the EP axis
                                   # (exact for gated FFNs; grok: 8 experts -> 16 slots)
    expert_placement: str = "default"   # default | greedy — Eclat-style balancing
    # SSM / recurrent
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0           # xlstm: one sLSTM per this many mLSTM blocks
    # hybrid (hymba): attention and SSM heads in parallel in every block
    hybrid: bool = False
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_len: int = 0           # fixed encoder frames (whisper: 1500)
    # modality frontend stub: input_specs() supplies precomputed embeddings
    frontend: Optional[str] = None  # None | audio | vision
    frontend_len: int = 0          # prefix embedding length for vlm
    dtype: str = "bfloat16"
    # which shapes are skipped, with reason (DESIGN.md §4)
    skip_shapes: Tuple[Tuple[str, str], ...] = ()
    # exact layer-kind pattern override (scan-calibration variants only)
    pattern_override: Tuple[str, ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def layer_pattern(self) -> List[str]:
        """Per-layer kind list for the decoder stack."""
        if self.pattern_override:
            return list(self.pattern_override)
        kinds: List[str] = []
        for i in range(self.n_layers):
            if self.n_encoder_layers:
                kind = "xdec"
            elif self.hybrid:
                kind = "hybrid"
            elif self.family == "ssm" and self.slstm_every:
                kind = "slstm" if (i % self.slstm_every == self.slstm_every - 1) else "mlstm"
            elif self.family == "ssm":
                kind = "mlstm"
            elif self.attn_pattern == "local_global" and self.local_per_global:
                kind = "local" if (i % (self.local_per_global + 1)) < self.local_per_global else "attn"
            elif self.attn_pattern == "window":
                kind = "local"
            else:
                kind = "attn"
            if self.n_experts and (i % self.moe_every == self.moe_every - 1):
                kind += "+moe"
            kinds.append(kind)
        return kinds

    def _counts(self):
        d, f = self.d_model, self.d_ff
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.mlp_act in ("swiglu", "geglu"):
            mlp = 3 * d * f
        elif self.mlp_act == "none":
            mlp = 0
        else:
            mlp = 2 * d * f
        pattern = self.layer_pattern()
        n_moe = sum(1 for k in pattern if k.endswith("+moe"))
        return attn, mlp, n_moe, pattern

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stack), for 6ND."""
        d, v = self.d_model, self.vocab_size
        attn, mlp, n_moe, pattern = self._counts()
        total = v * d + (0 if self.tie_embeddings else v * d)
        if self.family == "ssm":
            din = 2 * d
            hd = din // self.n_heads
            mlstm = (d * 2 * din + self.n_heads * 3 * hd * hd
                     + din * 2 * self.n_heads + din * d + d)
            slstm = d * 4 * d + d + d * d + d
            for k in pattern:
                total += mlstm if k == "mlstm" else slstm
            return int(total)
        for k in pattern:
            total += attn + 2 * d
            if k.endswith("+moe"):
                total += self.n_experts * mlp + d * self.n_experts
            else:
                total += mlp
            if k.startswith("hybrid"):
                din = self.ssm_expand * d
                total += 2 * d * din + din * d + din * (2 * self.ssm_state + 2)
            if k.startswith("xdec"):
                total += attn  # cross-attention
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + mlp + 2 * d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        _, mlp, n_moe, _ = self._counts()
        dense = self.param_count() - n_moe * self.n_experts * mlp
        return int(dense + n_moe * self.top_k * mlp)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient accumulation
    remat: str = "dots"              # none | dots | full
    zero1: bool = True               # shard optimizer state over data axes
    opt_dtype: str = "float32"       # AdamW moment dtype (bfloat16 halves opt memory)
    grad_compression: str = "none"   # none | int8 | topk
    checkpoint_every: int = 100
    seed: int = 0
