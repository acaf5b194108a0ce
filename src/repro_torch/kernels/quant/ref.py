"""Plain PyTorch version of the fixed-point quantization kernel.

Port of `repro.kernels.quant.ref`: signed Q(int_bits).(frac_bits) rounding
(half to even, `torch.round`) and saturation, in the kernel's order —
scale = 2^f, hi = 2^i − 1/scale (a true division), lo = −2^i,
y = min(max(round(x·scale)/scale, lo), hi), in float32, rounded once to
x's type — so on the card the kernels (csrc/quant.cu) equal this version
bitwise.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def fixed_point_quantize(x: torch.Tensor, int_bits,
                         frac_bits) -> torch.Tensor:
    """Signed Q(int_bits).(frac_bits) fixed-point rounding + saturation.
    The widths may be numbers or 0-d tensors."""
    i = torch.as_tensor(int_bits, dtype=torch.float32, device=x.device)
    f = torch.as_tensor(frac_bits, dtype=torch.float32, device=x.device)
    scale = torch.exp2(f)
    hi = torch.exp2(i) - torch.ones_like(scale) / scale
    lo = -torch.exp2(i)
    xq = torch.round(x.float() * scale) / scale
    return torch.minimum(torch.maximum(xq, lo), hi).to(x.dtype)


def fixed_point_quantize_many(xs: Sequence[torch.Tensor],
                              widths: Sequence[tuple]
                              ) -> List[torch.Tensor]:
    """`fixed_point_quantize` of each xs[k] at widths[k] = (int_bits,
    frac_bits)."""
    return [fixed_point_quantize(x, i, f) for x, (i, f) in zip(xs, widths)]
