from .flash_attention import (BwdPlan, F32Plan, bwd_dkdv_blocks, bwd_plan,
                              f32_ds_blocks, f32_fwd_blocks, f32_grad_blocks,
                              f32_plan, f32_tile_index, flash_attention,
                              flash_attention_bwd)
from .ops import FlashAttentionFunction, multi_head_attention
from .ref import (attention_bwd_bf16_ref, attention_lse_ref, attention_ref,
                  attention_ref_bwd, attention_split_p_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "multi_head_attention",
           "FlashAttentionFunction", "attention_ref", "attention_ref_bwd",
           "attention_lse_ref", "attention_split_p_ref",
           "attention_bwd_bf16_ref", "bwd_plan", "bwd_dkdv_blocks", "BwdPlan",
           "f32_plan", "F32Plan", "f32_fwd_blocks", "f32_ds_blocks",
           "f32_grad_blocks", "f32_tile_index"]
