"""hymba-1.5b [hybrid]: 32L d1600 25H GQA(kv=5) d_ff 5504 vocab 32001,
parallel attention + mamba heads per block, ssm_state 16
[arXiv:2411.13676; hf].  Hybrid/state-based -> long_500k RUNS.
Attention branch uses a 2048 sliding window (Hymba's global-local scheme,
meta-tokens stubbed out — DESIGN.md §4)."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32_001,
    hybrid=True, window=2048, ssm_state=16, ssm_expand=2,
    mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True,
))
