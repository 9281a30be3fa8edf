from .flash_attention import flash_attention, flash_attention_bwd
from .ops import FlashAttentionFunction, multi_head_attention
from .ref import (attention_lse_ref, attention_ref, attention_ref_bwd,
                  attention_split_p_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "multi_head_attention",
           "FlashAttentionFunction", "attention_ref", "attention_ref_bwd",
           "attention_lse_ref", "attention_split_p_ref"]
