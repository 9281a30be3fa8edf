"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H GQA(kv=8) d_ff 8192/expert,
MoE 128 experts top-1, vocab 202048, early fusion (stubbed)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  128 experts shard over
the EP (data) axis; Eclat-style greedy expert placement is this framework's
paper-technique integration (DESIGN.md §4).  long_500k skipped (assigned
config treated as full attention per its spec line)."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202_048,
    n_experts=128, top_k=1, moe_every=2, expert_sharding="ep", expert_placement="greedy",
    mlp_act="swiglu", norm="rmsnorm", tie_embeddings=False,
    rope_theta=500_000.0,
    skip_shapes=(("long_500k", "assigned config is full attention — "
                  "see DESIGN.md §4"),),
))
