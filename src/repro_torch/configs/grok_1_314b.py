"""grok-1-314b [moe]: 64L d6144 48H GQA(kv=8) d_ff 32768, MoE 8 experts
top-2, vocab 131072 [hf:xai-org/grok-1; unverified].  8 experts don't divide
the 16-wide EP axis -> expert_sharding=tp2d (each expert's 32k d_ff sharded
over data x model; DESIGN.md §2).  long_500k skipped."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131_072,
    n_experts=8, top_k=2, expert_sharding="tp2d",
    mlp_act="geglu", norm="rmsnorm", tie_embeddings=True,
    attn_logit_softcap=30.0,
    skip_shapes=(("long_500k", "pure full attention — see DESIGN.md §4"),),
))
