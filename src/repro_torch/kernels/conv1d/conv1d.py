"""The strided 1-D convolution kernel on Hopper: wrapper, build, binding.

Port of `repro.kernels.conv1d.conv1d`. One CUDA source (csrc/conv1d.cu,
built for sm_90a at first use by `kernels._build`, bound with ctypes) with
two kernels, one chosen by the plan (`_plan(dims)`, mirrored by the
library's `conv1d_plan`): a plain function of the layer shape, with no
switch and no fallback.

  * "rb" — `conv1d_kernel_rb`, register-blocked and specialized to the three
    layer shapes of the deployed equalizer ((K, C_in, C_out, stride) = (9,
    1, 5, 8), (9, 5, 5, 1), (9, 5, 8, 2)). It reads the unpadded input,
    takes zeros outside it at a left offset (0 for `conv1d`, K // 2 for
    `ops.conv1d_same_lower`, which then runs no padding copy), splits each
    row into its own runs of output positions (the library's plan gives
    their length) and ignores `tile_w`.
  * "generic" — `conv1d_kernel`, for every other shape. It tiles as the
    reference's wrapper does: the grid is (n_tiles, B), each tile of
    `tile_w` output positions reads its own window of (tile_w−1)·stride + K
    samples per input channel, and the input's right edge is padded so
    every window is in bounds. `tile_w` is never shrunk to the output
    width.

Types, as the reference's: x, w and b may be float32, bfloat16 or
float16; the arithmetic is float32 and the result has x's type. Both
kernels are float32 instances: on the card a 16-bit x is widened to
float32 before the launch (exact), and the float32 result rounded once to
x's type after it, which is the plain version's one rounding.

Where the work runs. On a CUDA tensor the wrapper launches the planned
kernel, or raises (a failed build, a refused launch): there is no
fallback. On a CPU tensor it runs the plain version (`ref.conv1d`), which
sums in the same fixed order.

`LAUNCHES` counts kernel launches and `INSTANCE_LAUNCHES` those of each
kernel, "rb" and "generic" (bumped only where a kernel is launched);
`reset_launch_counts` zeroes both.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ...device import FLOAT_DTYPES
from .. import _build
from . import ref

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "build", "conv1d",
           "reset_launch_counts"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "conv1d.cu"
_MAX_ROWS = 65535                 # gridDim.y
_MAX_SMEM_BYTES = 232448          # 227 KB: one block's opt-in limit

LAUNCHES: Dict[str, int] = {"conv1d": 0}
INSTANCE_LAUNCHES: Dict[str, int] = {"rb": 0, "generic": 0}

# the shapes conv1d_kernel_rb is instantiated for, as (k, c_in, c_out,
# stride): the deployed equalizer's three layers (K = 9, C = 5, V_p = 8,
# N_os = 2)
_RB_DIMS = ((9, 1, 5, 8), (9, 5, 5, 1), (9, 5, 8, 2))


def reset_launch_counts() -> None:
    for table in (LAUNCHES, INSTANCE_LAUNCHES):
        for name in table:
            table[name] = 0


class Plan(NamedTuple):
    """The library's plan of a layer shape (`_lib_plan`): `instance` "rb" or
    "generic"; for "rb" the output positions a block `w_run`, the positions
    a thread `p`, the block's `threads` and its dynamic shared memory
    `smem` in bytes (all 0 for "generic")."""
    instance: str
    w_run: int
    p: int
    threads: int
    smem: int


def _dims(w: torch.Tensor, stride: int) -> Tuple[int, int, int, int]:
    """(k, c_in, c_out, stride) of a layer."""
    return (int(w.shape[2]), int(w.shape[1]), int(w.shape[0]), int(stride))


def _plan(dims) -> str:
    """The kernel a layer of shape dims = (k, c_in, c_out, stride) runs:
    "rb" at the deployed equalizer's three shapes, "generic" elsewhere. The
    geometry of "rb" is the library's (`_lib_plan`)."""
    return "rb" if tuple(dims) in _RB_DIMS else "generic"


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/conv1d.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


# conv1d_rb_launch's argument types (`_rb_call` marshals them)
RB_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
               + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6
               + [ctypes.c_void_p])


def _bind(lib: ctypes.CDLL) -> None:
    lib.conv1d_launch.restype = ctypes.c_int
    lib.conv1d_launch.argtypes = ([ctypes.c_void_p] * 4
                                  + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.conv1d_rb_launch.restype = ctypes.c_int
    lib.conv1d_rb_launch.argtypes = RB_ARGTYPES
    lib.conv1d_rb_launch_at.restype = ctypes.c_int
    lib.conv1d_rb_launch_at.argtypes = [ctypes.c_int] + RB_ARGTYPES
    lib.conv1d_plan.restype = ctypes.c_int
    lib.conv1d_plan.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]


def _load() -> ctypes.CDLL:
    return _build.load(CSRC, _bind)


def _lib_plan(lib: ctypes.CDLL, dims) -> Plan:
    """The plan the built library's `conv1d_plan` gives for dims = (k,
    c_in, c_out, stride)."""
    k, c_in, c_out, stride = (int(v) for v in dims)
    geom = (ctypes.c_int * 4)()
    rb = lib.conv1d_plan(c_in, c_out, k, stride, geom)
    return Plan("rb" if rb else "generic", *geom)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int, pad: Tuple[int, int] = (0, 0)) -> None:
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError(f"need x (B, C_in, W), w (C_out, C_in, K), b "
                         f"(C_out,), got {tuple(x.shape)}, {tuple(w.shape)},"
                         f" {tuple(b.shape)}")
    if w.shape[1] != x.shape[1] or b.shape[0] != w.shape[0]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype not in FLOAT_DTYPES or t.device != x.device:
            raise ValueError(f"{name} must be float32, bfloat16 or float16 "
                             f"on {x.device}, got {t.dtype} on {t.device}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per launch, got "
                         f"{int(x.shape[0])}")
    if stride < 1 or x.shape[2] + sum(pad) < w.shape[2]:
        raise ValueError(f"need stride >= 1 and W >= K, got stride {stride}, "
                         f"W {int(x.shape[2]) + sum(pad)}, K "
                         f"{int(w.shape[2])}")


def _call_generic(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  stride: int, tile_w: int) -> torch.Tensor:
    """Launch conv1d_kernel on the current stream (x already padded);
    raises on any error."""
    batch, c_in, width = x.shape
    c_out, _, kernel = w.shape
    w_out = (width - kernel) // stride + 1
    tile_w = max(1, int(tile_w))
    n_tiles = -(-w_out // tile_w)
    needed = ((n_tiles - 1) * tile_w + tile_w - 1) * stride + kernel
    xp = F.pad(x, (0, max(0, needed - width))).contiguous()
    wc, bc = w.contiguous(), b.contiguous()
    out = torch.empty((batch, c_out, n_tiles * tile_w), dtype=torch.float32,
                      device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv1d_launch(xp.data_ptr(), wc.data_ptr(), bc.data_ptr(),
                               out.data_ptr(), batch, n_tiles, xp.shape[2],
                               out.shape[2], c_in, c_out, kernel, stride,
                               tile_w, stream)
    if rc == -2:
        raise ValueError(f"conv1d: tile_w={tile_w} needs more than "
                         f"{_MAX_SMEM_BYTES} bytes of shared memory per "
                         f"block; use a smaller tile_w")
    if rc != 0:
        raise RuntimeError(f"conv1d: kernel launch failed with code {rc}")
    LAUNCHES["conv1d"] += 1
    INSTANCE_LAUNCHES["generic"] += 1
    return out[:, :, :w_out]


def _rb_call(lib: ctypes.CDLL, x: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor, out: torch.Tensor, stride: int, pad_lo: int,
             stream: int, w_run=None) -> int:
    """Marshal one call of `conv1d_rb_launch`, or with a run of w_run
    output positions a block of `conv1d_rb_launch_at`; returns its code.
    x: (B, C_in, W) fp32 with unit stride along W; w, b contiguous; out:
    (B, C_out, w_out) contiguous."""
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            int(x.shape[0]), int(x.shape[2]), int(x.stride(0)),
            int(x.stride(1)), int(pad_lo), int(out.shape[2]),
            int(x.shape[1]), int(w.shape[0]), int(w.shape[2]), int(stride),
            stream)
    if w_run is None:
        return lib.conv1d_rb_launch(*args)
    return lib.conv1d_rb_launch_at(int(w_run), *args)


def _call_rb(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
             pad: Tuple[int, int], w_run=None) -> torch.Tensor:
    """Launch conv1d_kernel_rb on the current stream, on x padded by
    pad = (left, right) zeros that the kernel reads as zeros (at the plan's
    run, or at runs of w_run positions); raises on any error."""
    w_out = (int(x.shape[2]) + sum(pad) - int(w.shape[2])) // stride + 1
    if x.stride(2) != 1:
        x = x.contiguous()
    wc, bc = w.contiguous(), b.contiguous()
    out = torch.empty((x.shape[0], w.shape[0], w_out), dtype=torch.float32,
                      device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _rb_call(lib, x, wc, bc, out, stride, pad[0], stream, w_run)
    if rc == -2:
        raise ValueError(f"conv1d: runs of {w_run} positions need more than "
                         f"{_MAX_SMEM_BYTES} bytes of shared memory per "
                         f"block")
    if rc != 0:
        raise RuntimeError(f"conv1d: kernel launch failed with code {rc}")
    LAUNCHES["conv1d"] += 1
    INSTANCE_LAUNCHES["rb"] += 1
    return out


def _in_f32(call, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           *args) -> torch.Tensor:
    """call(x, w, b, *args) on float32 copies of 16-bit tensors (float32
    ones as they are), its float32 result rounded once to x's type."""
    f32 = [t.float() for t in (x, w, b)]
    return call(*f32, *args).to(x.dtype)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
            tile_w: int, pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """VALID strided conv of x padded by pad = (left, right) zeros: the
    planned kernel on a CUDA tensor (the rb kernel pads in the kernel, the
    generic one runs on an F.pad copy), the plain version on a CPU one."""
    _check(x, w, b, stride, pad)
    if not x.is_cuda:
        return ref.conv1d(F.pad(x, pad) if any(pad) else x, w, b, stride)
    if _plan(_dims(w, stride)) == "rb":
        return _in_f32(_call_rb, x, w, b, stride, pad)
    return _in_f32(_call_generic, F.pad(x, pad) if any(pad) else x, w, b,
                   stride, tile_w)


def _forced(instance: str, x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor, stride: int, tile_w: int = 256,
            pad: Tuple[int, int] = (0, 0), w_run=None) -> torch.Tensor:
    """The wrapper's call on a CUDA tensor with the kernel named, not
    planned: "generic" at tile_w (on an F.pad copy), or "rb" at the plan's
    run or at runs of w_run positions. For the card tests, chip_smoke.py
    and the sweep, which hold the two kernels against each other; the
    wrappers never call it."""
    if not x.is_cuda:
        raise ValueError(f"a forced {instance!r} launch needs a CUDA tensor, "
                         f"got one on {x.device}")
    _check(x, w, b, stride, pad)
    if instance == "rb":
        return _in_f32(_call_rb, x, w, b, stride, pad, w_run)
    return _in_f32(_call_generic, F.pad(x, pad) if any(pad) else x, w, b,
                   stride, tile_w)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1, tile_w: int = 256) -> torch.Tensor:
    """VALID strided conv: x (B, C_in, W), w (C_out, C_in, K), b (C_out,)
    → (B, C_out, (W − K)//stride + 1), of x's type."""
    return _conv1d(x, w, b, stride, tile_w)
