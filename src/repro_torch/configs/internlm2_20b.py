"""internlm2-20b [dense]: 48L d6144 48H GQA(kv=8) d_ff 16384 vocab 92544
[arXiv:2403.17297; hf].  Pure full attention -> long_500k skipped."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92_544,
    mlp_act="swiglu", norm="rmsnorm", tie_embeddings=False,
    rope_theta=1_000_000.0,
    skip_shapes=(("long_500k", "pure full attention — see DESIGN.md §4"),),
))
