"""The fixed-point quantization kernel on Hopper: wrapper, build, binding.

Port of `repro.kernels.quant.quant`. One CUDA source (csrc/quant.cu, built
for sm_90a at first use by `kernels._build`, bound with ctypes). The two
widths travel as a 2-float tensor on the input's device, read by the
kernel through a pointer (the TPU kernel holds them in SMEM): widths that
live on the card cost no device→host sync, and no width needs a rebuild.

Where the work runs. On a CUDA tensor the wrapper launches the kernel, or
raises (a failed build, a refused launch): there is no fallback. On a CPU
tensor it runs the plain version (`ref.fixed_point_quantize`).

`LAUNCHES` counts kernel launches (bumped only where the kernel is
launched); `reset_launch_counts` zeroes it.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, Tuple

import torch

from .. import _build
from . import ref

__all__ = ["LAUNCHES", "build", "fixed_point_quantize",
           "reset_launch_counts"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "quant.cu"

LAUNCHES: Dict[str, int] = {"fixed_point_quantize": 0}


def reset_launch_counts() -> None:
    LAUNCHES["fixed_point_quantize"] = 0


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/quant.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


def _bind(lib: ctypes.CDLL) -> None:
    lib.quant_launch.restype = ctypes.c_int
    lib.quant_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long,
                                                         ctypes.c_void_p]


def _bits(int_bits, frac_bits, device: torch.device) -> torch.Tensor:
    """(int_bits, frac_bits) → a (2,) float32 tensor on ``device``; widths
    already on the device are stacked there, with no host round trip."""
    return torch.stack([torch.as_tensor(v, dtype=torch.float32).to(
        device).reshape(()) for v in (int_bits, frac_bits)])


def fixed_point_quantize(x: torch.Tensor, int_bits,
                         frac_bits) -> torch.Tensor:
    """Quantize a float32 tensor of any shape to Q(int_bits).(frac_bits)."""
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    bits = _bits(int_bits, frac_bits, x.device)
    if not x.is_cuda:
        return ref.fixed_point_quantize(x, bits[0], bits[1])
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    lib = _build.load(CSRC, _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quant_launch(xc.data_ptr(), out.data_ptr(),
                              bits.data_ptr(), xc.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"fixed_point_quantize: kernel launch failed "
                           f"with code {rc}")
    LAUNCHES["fixed_point_quantize"] += 1
    return out
