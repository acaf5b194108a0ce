"""The flash-attention forward kernel on Hopper: wrapper, build, binding.

Port of `repro.kernels.flash_attn.flash_attn.flash_attention`. One CUDA
source (csrc/flash_attn.cu, built for sm_90a at first use by
`kernels._build`, bound with ctypes). The kernel reads q (B, Sq, H, D) and
k/v (B, Sk, Hkv, D) in place through their strides, so the wrapper pads,
moves and repeats nothing: it checks, allocates the output and launches.

Where the work runs. On a CUDA tensor the wrapper launches the kernel, or
raises (a failed build, a refused launch): there is no fallback. On a CPU
tensor it runs the plain version (`ref.flash_attention`), which has the
kernel's semantics (GQA by index, 0 for a row with no valid key).

What it takes: f32 or bf16, one type for q, k and v; a head dim that is a
multiple of 16 up to 128 (`HEAD_DIMS`); Hkv dividing H; unit stride along
D. Anything else raises, on either device.

`LAUNCHES` counts kernel launches (bumped only where the kernel is
launched); `reset_launch_counts` zeroes it. `attention_costs` is the
reference's analytical flop and byte count of one call.
"""
from __future__ import annotations

import ctypes
import math
import pathlib
from typing import Dict, Tuple

import torch

from .. import _build
from . import ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "attention_costs", "build",
           "flash_attention", "reset_launch_counts"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
HEAD_DIMS = tuple(range(16, 129, 16))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535                   # gridDim.y = B·H
_INT32 = 2 ** 31

LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/flash_attn.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attn_launch.restype = ctypes.c_int
    lib.flash_attn_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, H, D) and k, v (B, Sk, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if hkv < 1 or h % hkv:
        raise ValueError(f"kv heads ({hkv}) must divide q heads ({h})")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported: one of {HEAD_DIMS}")
    if sq < 1 or sk < 1 or b < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if b * h > _MAX_BH:
        raise ValueError(f"at most {_MAX_BH} (batch · heads) per launch, got "
                         f"{b * h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"q, k, v must share one type of {list(_DTYPES)}"
                             f", got {name} {t.dtype} (q {q.dtype})")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride along D, got strides "
                             f"{t.stride()}")
    if not isinstance(window, int) or not isinstance(q_offset, int):
        raise TypeError(f"window and q_offset must be python ints, got "
                        f"{type(window).__name__}, {type(q_offset).__name__}")
    if window < 0 or not -_INT32 < q_offset < _INT32 or window >= _INT32:
        raise ValueError(f"need 0 <= window < 2^31 and |q_offset| < 2^31, "
                         f"got {window}, {q_offset}")


def _launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, out: torch.Tensor, causal: bool, window: int,
            q_offset: int, stream: int) -> int:
    """Marshal one call of `flash_attn_launch`; returns its code."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                        for s in t.stride()[:3]))
    return lib.flash_attn_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, sk, h, hkv, d, strides, int(bool(causal)),
        window, q_offset, 1.0 / math.sqrt(d), stream)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D) → (B, Sq, H, D) in q.dtype.

    GQA: query head h reads kv head h // (H / Hkv). Softmax numerics in
    f32. Query row i sits at position q_offset + i; ``window > 0`` keeps
    keys j > q_offset + i − window. A row with no valid key is 0.
    """
    _check(q, k, v, window, q_offset)
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal, window, q_offset)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.load(CSRC, _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launch(lib, q, k, v, out, causal, window, q_offset, stream)
    if rc == -3:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} has no "
                         f"kernel instance")
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with code "
                           f"{rc}")
    LAUNCHES["flash_attention"] += 1
    return out


def attention_costs(b: int, sq: int, sk: int, h: int, d: int,
                    causal: bool = True, window: int = 0,
                    dtype_bytes: int = 2) -> dict:
    """Analytical roofline terms for the kernel (per invocation, global):
    the reference's count (`repro.kernels.flash_attn.flash_attn.
    attention_costs`), q·kᵀ and p·v flops over the visible pairs, and the
    q, o, k, v streams at H heads."""
    if window > 0:
        pairs = min(window, sk) * sq
    elif causal:
        pairs = sq * sk / 2 if sq == sk else sq * sk - sq * (sq - 1) / 2
    else:
        pairs = sq * sk
    flops = 4.0 * b * h * pairs * d                 # QKᵀ + PV
    hbm = dtype_bytes * b * h * d * (2 * sq + 2 * sk)   # q,o + k,v streams
    return {"flops": flops, "hbm_bytes": hbm}
