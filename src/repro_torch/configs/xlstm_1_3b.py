"""xlstm-1.3b [ssm]: 48L d2048 4H, sLSTM + mLSTM blocks (7:1), d_ff=0
(blocks carry their own 2x up/down projection) vocab 50304
[arXiv:2405.04517; unverified].  State-based -> long_500k RUNS."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    mlp_act="none", norm="rmsnorm", tie_embeddings=True,
    slstm_every=8, rope_theta=0.0,
))
