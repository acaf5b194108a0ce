"""Public entry points of the fused sLSTM kernel (port of
`repro.kernels.slstm.ops`)."""
from .ref import slstm as slstm_ref
from .slstm import slstm_fused

__all__ = ["slstm_fused", "slstm_ref"]
