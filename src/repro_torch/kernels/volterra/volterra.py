"""The Volterra equalizer kernel on Hopper: wrapper, build and binding.

Port of `repro.kernels.volterra.volterra`. One CUDA source (csrc/volterra.cu,
built for sm_90a at first use by `kernels._build`, bound with ctypes) with
two kernels, one chosen by the plan (`_plan(dims)`, mirrored by the
library's `volterra_plan`): a plain function of the shape, with no switch
and no fallback.

  * "rb" — `volterra_kernel_rb`, register-blocked and specialized to the
    deployed baseline, `VolterraConfig()` = (M1, M2, M3) = (25, 9, 0) at
    N_os = 2. It reads the unpadded input (any row stride), takes zeros
    outside it, splits each row into its own runs of output symbols (the
    library's plan gives their length) and ignores `tile`.
  * "generic" — `volterra_kernel`, for every other shape. It pads and
    tiles as the reference's wrapper does: the input is padded by the
    common halo max(m//2) on the left and up to the last tile's window on
    the right; the grid is (n_tiles, B); each tile of `tile` output symbols
    computes from its own window of (tile−1)·stride + 2·halo + 1 samples.
    `tile` is never shrunk to the stream length.

Types, as the reference's: x is float32, bfloat16 or float16 and the
result has x's type; the weights may be any of the three. Both kernels
read and write x's type themselves and compute in float32; the weights are
widened to float32 (exact) before the launch.

Where the work runs. On a CUDA tensor the wrapper launches the planned
kernel, or raises (a failed build, a refused launch): there is no
fallback. On a CPU tensor it runs the plain version (`ref.volterra`), which
sums in the same fixed order, so the result depends on neither the tile,
the kernel nor the device.

`LAUNCHES` counts kernel launches and `INSTANCE_LAUNCHES` those of each
kernel, "rb" and "generic" (bumped only where a kernel is launched);
`reset_launch_counts` zeroes both.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...device import FLOAT_DTYPES
from .. import _build
from . import ref

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "build", "reset_launch_counts",
           "volterra"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "volterra.cu"
_MAX_ROWS = 65535                 # gridDim.y
_MAX_SMEM_BYTES = 232448          # 227 KB: one block's opt-in limit

LAUNCHES: Dict[str, int] = {"volterra": 0}
INSTANCE_LAUNCHES: Dict[str, int] = {"rb": 0, "generic": 0}

# the shape volterra_kernel_rb is instantiated for, as (m1, m2, m3,
# stride): the deployed baseline VolterraConfig()
_RB_DIMS = ((25, 9, 0, 2),)


def reset_launch_counts() -> None:
    for table in (LAUNCHES, INSTANCE_LAUNCHES):
        for name in table:
            table[name] = 0


class Plan(NamedTuple):
    """The library's plan of a shape (`_lib_plan`): `instance` "rb" or
    "generic"; for "rb" the output symbols a block `w_run`, the symbols a
    thread `p`, the block's `threads` and its dynamic shared memory `smem`
    in bytes (all 0 for "generic")."""
    instance: str
    w_run: int
    p: int
    threads: int
    smem: int


def _dims(w1: torch.Tensor, w2: Optional[torch.Tensor],
          w3: Optional[torch.Tensor], stride: int) -> Tuple[int, ...]:
    """(m1, m2, m3, stride) of a weight set."""
    return (*ref.memory_lengths(w1, w2, w3), int(stride))


def _plan(dims) -> str:
    """The kernel a shape dims = (m1, m2, m3, stride) runs: "rb" at the
    deployed baseline, "generic" elsewhere. The geometry of "rb" is the
    library's (`_lib_plan`)."""
    return "rb" if tuple(dims) in _RB_DIMS else "generic"


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/volterra.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


# volterra_rb_launch's argument types (`_rb_call` marshals them)
RB_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5
               + [ctypes.c_int] * 2 + [ctypes.c_longlong]
               + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _bind(lib: ctypes.CDLL) -> None:
    lib.volterra_launch.restype = ctypes.c_int
    lib.volterra_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 11
                                    + [ctypes.c_void_p])
    lib.volterra_rb_launch.restype = ctypes.c_int
    lib.volterra_rb_launch.argtypes = RB_ARGTYPES
    lib.volterra_rb_launch_at.restype = ctypes.c_int
    lib.volterra_rb_launch_at.argtypes = [ctypes.c_int] + RB_ARGTYPES
    lib.volterra_plan.restype = ctypes.c_int
    lib.volterra_plan.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]


def _load() -> ctypes.CDLL:
    return _build.load(CSRC, _bind)


def _lib_plan(lib: ctypes.CDLL, dims) -> Plan:
    """The plan the built library's `volterra_plan` gives for dims = (m1,
    m2, m3, stride)."""
    geom = (ctypes.c_int * 4)()
    rb = lib.volterra_plan(*(int(v) for v in dims), geom)
    return Plan("rb" if rb else "generic", *geom)


def _check(x: torch.Tensor, weights) -> None:
    if x.dim() != 2 or x.dtype not in FLOAT_DTYPES:
        raise ValueError(f"x must be a (B, W) float32, bfloat16 or float16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per launch, got "
                         f"{int(x.shape[0])}")
    for name, w, dims in zip(("w0", "w1", "w2", "w3"), weights,
                             (None, 1, 2, 3)):
        if w is None:
            continue
        if w.dtype not in FLOAT_DTYPES or w.device != x.device:
            raise ValueError(f"{name} must be float32, bfloat16 or float16 "
                             f"on {x.device}, got {w.dtype} on {w.device}")
        if dims is None and w.numel() != 1:
            raise ValueError(f"w0 must hold one value, got {tuple(w.shape)}")
        if dims is not None and (w.dim() != dims or len(set(w.shape)) != 1
                                 or w.shape[0] < 1):
            raise ValueError(f"{name} must be a nonempty cube of rank "
                             f"{dims}, got {tuple(w.shape)}")


def _f32(weights) -> list:
    """The weights as contiguous float32 (a no-op for float32 ones)."""
    return [None if w is None else w.to(torch.float32).contiguous()
            for w in weights]


def _raise(rc: int, what: str) -> None:
    if rc == -2:
        raise ValueError(f"volterra: {what} needs more than "
                         f"{_MAX_SMEM_BYTES} bytes of shared memory per "
                         f"block; use a smaller one")
    if rc != 0:
        raise RuntimeError(f"volterra: kernel launch failed with code {rc}")


def _call_generic(x: torch.Tensor, weights, stride: int,
                  tile: int) -> torch.Tensor:
    """Launch volterra_kernel on the current stream, on an F.pad copy of x;
    raises on any error."""
    batch, width = x.shape
    n_out = width // stride
    m1, m2, m3 = ref.memory_lengths(*weights[1:])
    halo = max(m1 // 2, m2 // 2, m3 // 2)
    tile = max(1, int(tile))
    n_tiles = -(-n_out // tile)
    in_tile = (tile - 1) * stride + 2 * halo + 1
    needed = (n_tiles - 1) * tile * stride + in_tile
    xp = F.pad(x, (halo, max(0, needed - width - halo))).contiguous()
    ws = _f32(weights)
    out = torch.empty((batch, n_tiles * tile), dtype=x.dtype,
                      device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.volterra_launch(
            _build.DTYPE_CODE[x.dtype], xp.data_ptr(), out.data_ptr(),
            *[0 if w is None else w.data_ptr() for w in ws],
            batch, n_tiles, xp.shape[1], out.shape[1], tile, stride, m1, m2,
            m3, halo, in_tile, stream)
    _raise(rc, f"tile={tile} with memory lengths ({m1}, {m2}, {m3})")
    LAUNCHES["volterra"] += 1
    INSTANCE_LAUNCHES["generic"] += 1
    return out[:, :n_out]


def _rb_call(lib: ctypes.CDLL, x: torch.Tensor, w0: torch.Tensor,
             w1: torch.Tensor, w2: torch.Tensor, out: torch.Tensor,
             stride: int, stream: int, w_run=None, m3: int = 0) -> int:
    """Marshal one call of `volterra_rb_launch`, or with a run of w_run
    output symbols a block of `volterra_rb_launch_at`; returns its code.
    x: (B, W) with unit stride along W; w0, w1, w2 contiguous float32; out:
    (B, n_out) contiguous, of x's type; m3 the third order's length."""
    args = (_build.DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
            w0.data_ptr(), w1.data_ptr(), w2.data_ptr(), int(x.shape[0]),
            int(x.shape[1]), int(x.stride(0)), int(out.shape[1]),
            int(w1.shape[0]), int(w2.shape[0]), int(m3), int(stride),
            stream)
    if w_run is None:
        return lib.volterra_rb_launch(*args)
    return lib.volterra_rb_launch_at(int(w_run), *args)


def _call_rb(x: torch.Tensor, weights, stride: int,
             w_run=None) -> torch.Tensor:
    """Launch volterra_kernel_rb on the current stream (at the plan's run,
    or at runs of w_run symbols); raises on any error."""
    if x.stride(1) != 1:
        x = x.contiguous()
    w0, w1, w2, w3 = _f32(weights)
    if w2 is None:
        raise ValueError("volterra: the register-blocked kernel needs order "
                         "2 on")
    out = torch.empty((x.shape[0], x.shape[1] // stride), dtype=x.dtype,
                      device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _rb_call(lib, x, w0, w1, w2, out, stride, stream, w_run,
                      0 if w3 is None else int(w3.shape[0]))
    _raise(rc, f"a run of {w_run} symbols")
    LAUNCHES["volterra"] += 1
    INSTANCE_LAUNCHES["rb"] += 1
    return out


def _forced(instance: str, x: torch.Tensor, w0: torch.Tensor,
            w1: torch.Tensor, w2: Optional[torch.Tensor] = None,
            w3: Optional[torch.Tensor] = None, stride: int = 2,
            tile: int = 128, w_run=None) -> torch.Tensor:
    """The wrapper's call on a CUDA tensor with the kernel named, not
    planned: "generic" at `tile`, or "rb" at the plan's run or at runs of
    w_run symbols. For the card tests, chip_smoke.py and the sweep, which
    hold the two kernels against each other; the wrappers never call
    it."""
    if not x.is_cuda:
        raise ValueError(f"a forced {instance!r} launch needs a CUDA tensor, "
                         f"got one on {x.device}")
    weights = (w0, w1, w2, w3)
    _check(x, weights)
    if instance == "rb":
        return _call_rb(x, weights, stride, w_run)
    return _call_generic(x, weights, stride, tile)


def volterra(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
             w2: Optional[torch.Tensor] = None,
             w3: Optional[torch.Tensor] = None, stride: int = 2,
             tile: int = 128) -> torch.Tensor:
    """x: (B, W) → (B, W//stride), of x's type. Orders 2/3 off when
    None."""
    weights = (w0, w1, w2, w3)
    _check(x, weights)
    batch, width = x.shape
    n_out = width // stride
    if n_out == 0 or batch == 0:
        return x.new_zeros((batch, n_out))
    if not x.is_cuda:
        return ref.volterra(x, w0, w1, w2, w3, stride)
    if _plan(_dims(w1, w2, w3, stride)) == "rb":
        return _call_rb(x, weights, stride)
    return _call_generic(x, weights, stride, tile)
