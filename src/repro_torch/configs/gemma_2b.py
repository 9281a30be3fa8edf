"""gemma-2b [dense]: 18L d2048 8H MQA(kv=1) d_ff 16384 GeGLU vocab 256000,
head_dim 256 [arXiv:2403.08295; hf].  Pure full attention -> long_500k skipped."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16384, vocab_size=256_000,
    mlp_act="geglu", norm="rmsnorm", tie_embeddings=True, scale_embed=True,
    rope_theta=10_000.0,
    skip_shapes=(("long_500k", "pure full attention; quadratic prefill and "
                  "un-windowed KV growth — see DESIGN.md §4"),),
))
