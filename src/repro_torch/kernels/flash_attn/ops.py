"""Public entry points of the flash-attention kernel (port of
`repro.kernels.flash_attn.ops`)."""
from .flash_attn import attention_costs, flash_attention
from .ref import mha as mha_ref

__all__ = ["attention_costs", "flash_attention", "mha_ref"]
