from .flash_attention import flash_attention
from .ops import multi_head_attention
from .ref import attention_ref, attention_split_p_ref

__all__ = ["flash_attention", "multi_head_attention", "attention_ref",
           "attention_split_p_ref"]
