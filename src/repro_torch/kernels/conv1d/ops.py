"""Public entry point of the conv1d kernel (port of
`repro.kernels.conv1d.ops`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...device import DeviceLike, as_float, resolve_device
from . import conv1d as _kernel
from .conv1d import conv1d as conv1d_kernel
from .ref import conv1d as conv1d_ref


def conv1d_same_lower(x, w, b, stride: int = 1, use_kernel: bool = True,
                      tile_w: int = 256,
                      device: DeviceLike = "cuda") -> torch.Tensor:
    """SAME_LOWER-padded strided conv used by the equalizer layers: pads
    (K//2, K−1−K//2), then the VALID kernel (the register-blocked one reads
    the padding as zeros, with no copy). Inputs move to ``device``; a
    float32, bfloat16 or float16 tensor keeps its type (anything else
    becomes float32) and the result has x's; ``use_kernel=False`` runs the
    plain version there."""
    dev = resolve_device(device)
    x, w, b = (as_float(t, dev) for t in (x, w, b))
    k = w.shape[-1]
    pad = (k // 2, k - 1 - k // 2)
    if use_kernel:
        return _kernel._conv1d(x, w, b, stride, tile_w, pad)
    return conv1d_ref(F.pad(x, pad), w, b, stride)


__all__ = ["conv1d_kernel", "conv1d_ref", "conv1d_same_lower"]
