"""gemma3-4b [dense]: 34L d2560 8H GQA(kv=4) d_ff 10240 vocab 262144,
5:1 local:global (window 1024), head_dim 256
[hf:google/gemma-3-1b-pt; unverified].  Sub-quadratic (5/6 of layers are
sliding-window) -> long_500k RUNS for this arch."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=10240, vocab_size=262_144,
    attn_pattern="local_global", local_per_global=5, window=1024,
    mlp_act="geglu", norm="rmsnorm", tie_embeddings=True, scale_embed=True,
    rope_theta=1_000_000.0, qk_norm=True,
))
