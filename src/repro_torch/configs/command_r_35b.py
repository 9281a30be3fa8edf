"""command-r-35b [dense]: 40L d8192 64H GQA(kv=8) d_ff 22528 vocab 256000,
parallel attn∥FFN blocks, LayerNorm, no biases
[hf:CohereForAI/c4ai-command-r-v01; unverified].  long_500k skipped."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab_size=256_000,
    parallel_block=True, mlp_act="swiglu", norm="layernorm",
    tie_embeddings=True, rope_theta=8_000_000.0,
    skip_shapes=(("long_500k", "pure full attention — see DESIGN.md §4"),),
))
