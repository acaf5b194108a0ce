from .flash_attn import (LAUNCHES, attention_costs, build, build_bwd,
                         flash_attention, flash_attention_bwd,
                         flash_attention_bwd_dkv, flash_attention_bwd_dq,
                         flash_attention_fwd, reset_launch_counts,
                         rows_aligned)
from .ref import mha as mha_ref

__all__ = ["LAUNCHES", "attention_costs", "build", "build_bwd",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_fwd", "mha_ref", "reset_launch_counts",
           "rows_aligned"]
