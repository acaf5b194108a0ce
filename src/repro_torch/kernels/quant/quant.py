"""The fixed-point quantization kernels on Hopper: wrappers, build, binding.

Port of `repro.kernels.quant.quant`. One CUDA source (csrc/quant.cu, built
for sm_90a at first use by `kernels._build`, bound with ctypes) with two
kernels:

  * `fixed_point_quantize(x, int_bits, frac_bits)` — one tensor, the
    reference's entry point: `quant_kernel`, 16-byte accesses.
  * `fixed_point_quantize_many(xs, widths)` — several tensors, each with
    its own widths, in one launch of `quant_many_kernel` (up to
    `MAX_SEGMENTS` tensors a launch): the deploy path's `quantize_params`
    quantizes the trained CNN's six tensors with one launch.

Types, as the reference's: x is float32, bfloat16 or float16 and the
result has x's type, computed in float32. Each width is a number or a
one-value tensor: a float32 one on x's card travels to the kernel as a
pointer, read there (the TPU kernel holds the widths in SMEM), so widths
that live on the card cost no device→host sync and no stack kernel; a
number or a host tensor travels as a float32 value with the launch. No
width needs a rebuild.

Where the work runs. On a CUDA tensor the wrapper launches the kernel, or
raises (a failed build, a refused launch): there is no fallback. On a CPU
tensor it runs the plain version (`ref.fixed_point_quantize`).

`LAUNCHES` counts kernel launches and `INSTANCE_LAUNCHES` those of each
kernel, "tensor" and "many" (bumped only where a kernel is launched);
`reset_launch_counts` zeroes both.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, List, Sequence, Tuple

import torch

from ...device import FLOAT_DTYPES
from .. import _build
from . import ref

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "MAX_SEGMENTS", "build",
           "fixed_point_quantize", "fixed_point_quantize_many",
           "reset_launch_counts"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "quant.cu"
MAX_SEGMENTS = 16                 # csrc/quant.cu's QM_MAX_SEGS
_ALIGN = 16                       # bytes of the kernel's vector accesses

LAUNCHES: Dict[str, int] = {"fixed_point_quantize": 0}
INSTANCE_LAUNCHES: Dict[str, int] = {"tensor": 0, "many": 0}


def reset_launch_counts() -> None:
    for table in (LAUNCHES, INSTANCE_LAUNCHES):
        for name in table:
            table[name] = 0


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/quant.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


def _bind(lib: ctypes.CDLL) -> None:
    lib.quant_launch.restype = ctypes.c_int
    lib.quant_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.quant_many_launch.restype = ctypes.c_int
    lib.quant_many_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9


def _load() -> ctypes.CDLL:
    return _build.load(CSRC, _bind)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in FLOAT_DTYPES:
        raise ValueError(f"x must be float32, bfloat16 or float16, got "
                         f"{x.dtype}")


def _width(v, device: torch.device) -> Tuple[int, float, object]:
    """(device pointer, value, tensor) of one width for a launch on
    ``device``: a one-value tensor on that card goes by pointer (as float32;
    a float32 one is used in place; the caller holds the tensor until the
    launch is queued), a number or a host tensor by value."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"a width must hold one value, got "
                             f"{tuple(v.shape)}")
        if v.device == device:
            if v.dtype != torch.float32:
                v = v.float()
            return v.data_ptr(), 0.0, v
        if v.device.type != "cpu":
            raise ValueError(f"a width on {v.device} for a tensor on "
                             f"{device}")
    return 0, float(v), None


def _out_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of x's shape and type whose data sit at x's offset
    within 16 bytes, so that the kernel's vector accesses line up in both
    (x is a contiguous view at any storage offset)."""
    el = x.element_size()
    buf = torch.empty(x.numel() + _ALIGN // el, dtype=x.dtype,
                      device=x.device)
    off = ((x.data_ptr() - buf.data_ptr()) % _ALIGN) // el
    return buf[off:off + x.numel()].view(x.shape)


def fixed_point_quantize(x: torch.Tensor, int_bits,
                         frac_bits) -> torch.Tensor:
    """Quantize a float32, bfloat16 or float16 tensor of any shape to
    Q(int_bits).(frac_bits); the result has x's type."""
    _check(x)
    if not x.is_cuda:
        return ref.fixed_point_quantize(x, int_bits, frac_bits)
    xc = x.contiguous()
    out = _out_like(xc)
    if xc.numel() == 0:
        return out
    wi, wf = _width(int_bits, x.device), _width(frac_bits, x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quant_launch(_build.DTYPE_CODE[x.dtype], xc.data_ptr(),
                              out.data_ptr(), *wi[:2], *wf[:2], xc.numel(),
                              stream)
    if rc != 0:
        raise RuntimeError(f"fixed_point_quantize: kernel launch failed "
                           f"with code {rc}")
    LAUNCHES["fixed_point_quantize"] += 1
    INSTANCE_LAUNCHES["tensor"] += 1
    return out


def _launch_many(lib: ctypes.CDLL, xs: List[torch.Tensor],
                 ys: List[torch.Tensor], widths, stream: int) -> int:
    """Marshal one call of `quant_many_launch` over len(xs) ≤ MAX_SEGMENTS
    nonempty contiguous tensors; returns its code."""
    n = len(xs)
    dev = xs[0].device
    wi = [_width(i, dev) for i, _ in widths]
    wf = [_width(f, dev) for _, f in widths]
    ptrs = ctypes.c_void_p * n
    rc = lib.quant_many_launch(
        n, (ctypes.c_int * n)(*(_build.DTYPE_CODE[x.dtype] for x in xs)),
        ptrs(*(x.data_ptr() for x in xs)), ptrs(*(y.data_ptr() for y in ys)),
        (ctypes.c_longlong * n)(*(x.numel() for x in xs)),
        ptrs(*(w[0] for w in wi)), (ctypes.c_float * n)(*(w[1] for w in wi)),
        ptrs(*(w[0] for w in wf)), (ctypes.c_float * n)(*(w[1] for w in wf)),
        stream)
    return rc


def fixed_point_quantize_many(xs: Sequence[torch.Tensor],
                              widths: Sequence[tuple]
                              ) -> List[torch.Tensor]:
    """Quantize each xs[k] to Q(widths[k][0]).(widths[k][1]), as
    `fixed_point_quantize` does it: on the card with one launch for every
    MAX_SEGMENTS tensors. All xs lie on one device; returns a list of
    tensors of their shapes and types."""
    xs, widths = list(xs), list(widths)
    if len(xs) != len(widths):
        raise ValueError(f"{len(xs)} tensors and {len(widths)} widths")
    for x in xs:
        _check(x)
        if x.device != xs[0].device:
            raise ValueError(f"tensors on {xs[0].device} and {x.device}")
    if not xs or not xs[0].is_cuda:
        return ref.fixed_point_quantize_many(xs, widths)
    xcs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xcs]
    todo = [k for k, x in enumerate(xcs) if x.numel() > 0]
    lib = _load()
    dev = xs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c in range(0, len(todo), MAX_SEGMENTS):
            ks = todo[c:c + MAX_SEGMENTS]
            rc = _launch_many(lib, [xcs[k] for k in ks],
                              [outs[k] for k in ks],
                              [widths[k] for k in ks], stream)
            if rc != 0:
                raise RuntimeError(f"fixed_point_quantize_many: kernel "
                                   f"launch failed with code {rc}")
            LAUNCHES["fixed_point_quantize"] += 1
            INSTANCE_LAUNCHES["many"] += 1
    return outs
