"""whisper-base [audio]: 6L enc + 6L dec, d512 8H d_ff 2048 vocab 51865,
conv frontend STUB (input_specs supplies 1500 precomputed frame embeddings)
[arXiv:2212.04356; unverified].  Backbone-only per the assignment; decode_32k
is lowered mechanically (32k self-KV is architecturally meaningless for 30 s
audio — noted in DESIGN.md §4); long_500k skipped (enc-dec, full attention).
Adaptation: RoPE replaces Whisper's learned positions in the decoder (noted)."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51_865,
    mlp_act="gelu", norm="layernorm", tie_embeddings=True,
    n_encoder_layers=6, encoder_len=1500, frontend="audio",
    skip_shapes=(("long_500k", "enc-dec full attention over 30 s audio; "
                  "500k-token decode is architecturally meaningless"),),
))
