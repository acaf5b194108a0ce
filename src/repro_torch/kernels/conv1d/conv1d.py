"""The strided 1-D convolution kernel on Hopper: wrapper, build, binding.

Port of `repro.kernels.conv1d.conv1d`. One CUDA source (csrc/conv1d.cu,
built for sm_90a at first use by `kernels._build`, bound with ctypes). The
wrapper tiles as the reference's does: the grid is (n_tiles, B), each tile
of `tile_w` output positions reads its own window of (tile_w−1)·stride + K
samples per input channel, and the input's right edge is padded so every
window is in bounds. `tile_w` is never shrunk to the output width.

Where the work runs. On a CUDA tensor the wrapper launches the kernel, or
raises (a failed build, a refused launch): there is no fallback. On a CPU
tensor it runs the plain version (`ref.conv1d`), which sums in the same
fixed order.

`LAUNCHES` counts kernel launches (bumped only where the kernel is
launched); `reset_launch_counts` zeroes it.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from . import ref

__all__ = ["LAUNCHES", "build", "conv1d", "reset_launch_counts"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "conv1d.cu"
_MAX_ROWS = 65535                 # gridDim.y
_MAX_SMEM_BYTES = 232448          # 227 KB: one block's opt-in limit

LAUNCHES: Dict[str, int] = {"conv1d": 0}


def reset_launch_counts() -> None:
    LAUNCHES["conv1d"] = 0


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/conv1d.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


def _bind(lib: ctypes.CDLL) -> None:
    lib.conv1d_launch.restype = ctypes.c_int
    lib.conv1d_launch.argtypes = ([ctypes.c_void_p] * 4
                                  + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int) -> None:
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError(f"need x (B, C_in, W), w (C_out, C_in, K), b "
                         f"(C_out,), got {tuple(x.shape)}, {tuple(w.shape)},"
                         f" {tuple(b.shape)}")
    if w.shape[1] != x.shape[1] or b.shape[0] != w.shape[0]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per launch, got "
                         f"{int(x.shape[0])}")
    if stride < 1 or x.shape[2] < w.shape[2]:
        raise ValueError(f"need stride >= 1 and W >= K, got stride {stride}, "
                         f"W {int(x.shape[2])}, K {int(w.shape[2])}")


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1, tile_w: int = 256) -> torch.Tensor:
    """VALID strided conv: x (B, C_in, W), w (C_out, C_in, K), b (C_out,)
    → (B, C_out, (W − K)//stride + 1), float32."""
    _check(x, w, b, stride)
    if not x.is_cuda:
        return ref.conv1d(x, w, b, stride)
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
    lib = _build.load(CSRC, _bind)
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
    return out[:, :, :w_out]
