"""The Volterra equalizer kernel on Hopper: wrapper, build and binding.

Port of `repro.kernels.volterra.volterra`. One CUDA source
(csrc/volterra.cu, built for sm_90a at first use by `kernels._build`, bound
with ctypes). The wrapper pads and tiles as the reference's does: the input
is padded by the common halo max(m//2) on the left and up to the last
tile's window on the right; the grid is (n_tiles, B); each tile of `tile`
output symbols computes from its own window of (tile−1)·stride + 2·halo + 1
samples. `tile` is never shrunk to the stream length.

Where the work runs. On a CUDA tensor the wrapper launches the kernel, or
raises (a failed build, a refused launch): there is no fallback. On a CPU
tensor it runs the plain version (`ref.volterra`), which sums in the same
fixed order, so the result depends on neither the tile nor the device.

`LAUNCHES` counts kernel launches (bumped only where the kernel is
launched); `reset_launch_counts` zeroes it.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from . import ref

__all__ = ["LAUNCHES", "build", "reset_launch_counts", "volterra"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "volterra.cu"
_MAX_ROWS = 65535                 # gridDim.y
_MAX_SMEM_BYTES = 232448          # 227 KB: one block's opt-in limit

LAUNCHES: Dict[str, int] = {"volterra": 0}


def reset_launch_counts() -> None:
    LAUNCHES["volterra"] = 0


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/volterra.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


def _bind(lib: ctypes.CDLL) -> None:
    lib.volterra_launch.restype = ctypes.c_int
    lib.volterra_launch.argtypes = ([ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 11
                                    + [ctypes.c_void_p])


def _check(x: torch.Tensor, weights) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a (B, W) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per launch, got "
                         f"{int(x.shape[0])}")
    for name, w, dims in zip(("w0", "w1", "w2", "w3"), weights,
                             (None, 1, 2, 3)):
        if w is None:
            continue
        if w.dtype != torch.float32 or w.device != x.device:
            raise ValueError(f"{name} must be float32 on {x.device}, got "
                             f"{w.dtype} on {w.device}")
        if dims is None and w.numel() != 1:
            raise ValueError(f"w0 must hold one value, got {tuple(w.shape)}")
        if dims is not None and (w.dim() != dims or len(set(w.shape)) != 1
                                 or w.shape[0] < 1):
            raise ValueError(f"{name} must be a nonempty cube of rank "
                             f"{dims}, got {tuple(w.shape)}")


def volterra(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
             w2: Optional[torch.Tensor] = None,
             w3: Optional[torch.Tensor] = None, stride: int = 2,
             tile: int = 128) -> torch.Tensor:
    """x: (B, W) float32 → (B, W//stride). Orders 2/3 off when None."""
    _check(x, (w0, w1, w2, w3))
    batch, width = x.shape
    n_out = width // stride
    if n_out == 0 or batch == 0:
        return x.new_zeros((batch, n_out))
    if not x.is_cuda:
        return ref.volterra(x, w0, w1, w2, w3, stride)

    m1, m2, m3 = ref.memory_lengths(w1, w2, w3)
    halo = max(m1 // 2, m2 // 2, m3 // 2)
    tile = max(1, int(tile))
    n_tiles = -(-n_out // tile)
    in_tile = (tile - 1) * stride + 2 * halo + 1
    needed = (n_tiles - 1) * tile * stride + in_tile
    xp = F.pad(x, (halo, max(0, needed - width - halo))).contiguous()
    ws = [None if w is None else w.contiguous() for w in (w0, w1, w2, w3)]
    out = torch.empty((batch, n_tiles * tile), dtype=torch.float32,
                      device=x.device)
    lib = _build.load(CSRC, _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.volterra_launch(
            xp.data_ptr(), out.data_ptr(),
            *[0 if w is None else w.data_ptr() for w in ws],
            batch, n_tiles, xp.shape[1], out.shape[1], tile, stride, m1, m2,
            m3, halo, in_tile, stream)
    if rc == -2:
        raise ValueError(f"volterra: tile={tile} with memory lengths "
                         f"({m1}, {m2}, {m3}) needs more than "
                         f"{_MAX_SMEM_BYTES} bytes of shared memory per "
                         f"block; use a smaller tile")
    if rc != 0:
        raise RuntimeError(f"volterra: kernel launch failed with code {rc}")
    LAUNCHES["volterra"] += 1
    return out[:, :n_out]
