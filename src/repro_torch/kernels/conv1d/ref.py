"""Plain PyTorch version of the strided 1-D convolution kernel.

Port of `repro.kernels.conv1d.ref`: a VALID strided cross-correlation plus
bias, summed tap-major, then C_in ascending, one product at a time, bias
last — the order the fused equalizer already fixes
(`kernels.cnn_eq.ref.conv_valid_taps`, reused here), and the order of the
CUDA kernel (csrc/conv1d.cu), so on the card the two are bitwise equal.
Against `F.conv1d` (cuDNN or oneDNN, their own order) it differs by
rounding only.
"""
from __future__ import annotations

import torch

from ..cnn_eq.ref import conv_valid_taps


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int) -> torch.Tensor:
    """x: (B, C_in, W), w: (C_out, C_in, K), b: (C_out,)
    → (B, C_out, (W − K)//stride + 1)."""
    n_out = (x.shape[-1] - w.shape[-1]) // stride + 1
    return conv_valid_taps(x, w, b, stride, n_out).to(x.dtype)
