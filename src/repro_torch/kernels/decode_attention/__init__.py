from .decode_attention import decode_attention
from .ops import grouped_decode_attention
from .ref import decode_attention_ref

__all__ = ["decode_attention", "grouped_decode_attention", "decode_attention_ref"]
