"""Public entry points of the flash-attention kernels (port of
`repro.kernels.flash_attn.ops`)."""
from .flash_attn import (attention_costs, flash_attention,
                         flash_attention_bwd, flash_attention_fwd)
from .ref import mha as mha_ref

__all__ = ["attention_costs", "flash_attention", "flash_attention_bwd",
           "flash_attention_fwd", "mha_ref"]
