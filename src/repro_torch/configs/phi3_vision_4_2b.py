"""phi-3-vision-4.2b [vlm]: 32L d3072 32H GQA(kv=32) d_ff 8192 vocab 32064,
phi3-mini backbone + CLIP frontend STUB (input_specs supplies 256 precomputed
patch embeddings, early fusion) [hf:microsoft/Phi-3-vision-128k-instruct; hf].
long_500k skipped (full attention)."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_064,
    mlp_act="swiglu", norm="rmsnorm", tie_embeddings=False,
    frontend="vision", frontend_len=256, rope_theta=10_000.0,
    skip_shapes=(("long_500k", "pure full attention — see DESIGN.md §4"),),
))
