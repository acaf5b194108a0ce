from .flash_attn import (LAUNCHES, attention_costs, build, flash_attention,
                         reset_launch_counts)
from .ref import mha as mha_ref

__all__ = ["LAUNCHES", "attention_costs", "build", "flash_attention",
           "mha_ref", "reset_launch_counts"]
