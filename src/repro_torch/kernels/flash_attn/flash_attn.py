"""The flash-attention kernels on Hopper: wrappers, build, binding.

Port of `repro.kernels.flash_attn.flash_attn`: `flash_attention` (serving
forward), `flash_attention_fwd` (training forward, also returning the row
logsumexp) and `flash_attention_bwd` (dq, dk, dv), whose two kernels also
have their own wrappers, `flash_attention_bwd_dkv` and
`flash_attention_bwd_dq`. Two CUDA sources, each built for sm_90a at first
use by `kernels._build` and bound with ctypes: csrc/flash_attn.cu (the
forward, with and without lse) and csrc/flash_attn_bwd.cu (the dK/dV and
dQ kernels). The kernels read q, do (B, Sq, H, D) and k/v (B, Sk, Hkv, D)
in place through their strides, so the wrappers pad, move and repeat
nothing: they check, allocate the outputs and launch. The backward's
delta = rowsum(do ⊙ o) is computed in plain PyTorch before its launches,
as the reference computes it outside Pallas.

Where the work runs. On a CUDA tensor a wrapper launches its kernel, or
raises (a failed build, a refused launch): there is no fallback. On a CPU
tensor it runs the plain version of the same name in `ref`, which has the
kernel's semantics (GQA by index, 0 for a row with no valid key, NEG_INF
lse for it, dk/dv summed over the GQA group).

What they take: f32 or bf16, one type for q, k, v (and do); a head dim
that is a multiple of 16 up to 128 (`HEAD_DIMS`); Hkv dividing H; unit
stride along D; lse and delta (B, Sq, H) f32. Anything else raises, on
either device. The bf16 kernels stage rows with 16-byte asynchronous
copies, so on the card every wrapper also needs each bf16 q, k and v (and
do, for the backward) to start on a 16-byte boundary and every (b, s, h)
stride of a dimension longer than 1 to be a multiple of 8 elements
(`rows_aligned`); otherwise it raises ValueError naming the tensor (no
copy, no fallback).

`LAUNCHES` counts kernel launches, one key per kernel (bumped only where
that kernel is launched): ``flash_attention`` (serving), and the training
path's ``flash_attention_fwd``, ``flash_attention_bwd_dkv`` and
``flash_attention_bwd_dq``; `reset_launch_counts` zeroes them.
`attention_costs` is the reference's analytical flop and byte count of one
forward call.
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
           "build_bwd", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_fwd", "reset_launch_counts", "rows_aligned"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
CSRC_BWD = CSRC.with_name("flash_attn_bwd.cu")
HEAD_DIMS = tuple(range(16, 129, 16))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535                   # gridDim.y = B·H
_INT32 = 2 ** 31

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_fwd": 0,
                            "flash_attention_bwd_dkv": 0,
                            "flash_attention_bwd_dq": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/flash_attn.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


def build_bwd() -> Tuple[pathlib.Path, str]:
    """Compile csrc/flash_attn_bwd.cu for sm_90a."""
    return _build.build(CSRC_BWD)


_SHAPE_ARGS = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
_TAIL_ARGS = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attn_launch.restype = ctypes.c_int
    lib.flash_attn_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + _SHAPE_ARGS + _TAIL_ARGS)
    lib.flash_attn_fwd_lse_launch.restype = ctypes.c_int
    lib.flash_attn_fwd_lse_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + _SHAPE_ARGS + _TAIL_ARGS)


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.flash_attn_bwd_dkv_launch.restype = ctypes.c_int
    lib.flash_attn_bwd_dkv_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + _SHAPE_ARGS + _TAIL_ARGS)
    lib.flash_attn_bwd_dq_launch.restype = ctypes.c_int
    lib.flash_attn_bwd_dq_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + _SHAPE_ARGS + _TAIL_ARGS)


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


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels take ``t``'s rows as they lie: always for f32;
    for bf16 (cp.async staging) each row must start on a 16-byte boundary:
    the pointer, and every (b, s, h) stride the kernel steps along."""
    if t.dtype != torch.bfloat16:
        return True
    steps = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    return t.data_ptr() % 16 == 0 and not any(
        st * t.element_size() % 16 for st in steps)


def _check_rows_aligned(name: str, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, do=None) -> None:
    """Raise unless `rows_aligned` holds for q, k, v (and do)."""
    named = (("q", q), ("k", k), ("v", v)) + (() if do is None
                                              else (("do", do),))
    for tname, t in named:
        if not rows_aligned(t):
            raise ValueError(
                f"{name}: bf16 {tname} rows must start on 16-byte "
                f"boundaries (data_ptr % 16 == 0 and (b, s, h) strides "
                f"multiples of 8 elements), got data_ptr % 16 = "
                f"{t.data_ptr() % 16}, strides {t.stride()}")


def _check_bwd(q: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
               delta: torch.Tensor) -> None:
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: got {tuple(do.shape)} {do.dtype}"
                         f" on {do.device}, q {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}")
    if do.stride(-1) != 1:
        raise ValueError(f"do needs unit stride along D, got strides "
                         f"{do.stride()}")
    rows = tuple(q.shape[:3])
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != rows or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 (B, Sq, H) = "
                             f"{rows} tensor on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _strides(*ts: torch.Tensor):
    """(b, s, h) element strides of each tensor, as a C long long array."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _shape_args(q: torch.Tensor, k: torch.Tensor) -> tuple:
    b, sq, h, d = q.shape
    return b, sq, k.shape[1], h, k.shape[2], d


def _launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, out: torch.Tensor, causal: bool, window: int,
            q_offset: int, stream: int, lse=None) -> int:
    """Marshal one call of `flash_attn_launch` (or, with ``lse``, of
    `flash_attn_fwd_lse_launch`); returns its code."""
    tail = (_strides(q, k, v), int(bool(causal)), window, q_offset,
            1.0 / math.sqrt(q.shape[-1]), stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if lse is None:
        return lib.flash_attn_launch(_DTYPES[q.dtype], *ptrs,
                                     *_shape_args(q, k), *tail)
    return lib.flash_attn_fwd_lse_launch(_DTYPES[q.dtype], *ptrs,
                                         lse.data_ptr(), *_shape_args(q, k),
                                         *tail)


def _launch_bwd(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                delta: torch.Tensor, outs, causal: bool, window: int,
                q_offset: int, stream: int) -> int:
    """Marshal one call of `flash_attn_bwd_dq_launch` (``outs`` = (dq,))
    or `flash_attn_bwd_dkv_launch` (``outs`` = (dk, dv)); returns its
    code."""
    fn = (lib.flash_attn_bwd_dq_launch if len(outs) == 1
          else lib.flash_attn_bwd_dkv_launch)
    return fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
              do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              *(t.data_ptr() for t in outs), *_shape_args(q, k),
              _strides(q, k, v, do), int(bool(causal)), window, q_offset,
              1.0 / math.sqrt(q.shape[-1]), stream)


def _raise_on(rc: int, name: str, d: int) -> None:
    if rc == -3:
        raise ValueError(f"{name}: head dim {d} has no kernel instance")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with code {rc}")


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
    _check_rows_aligned("flash_attention", q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.load(CSRC, _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launch(lib, q, k, v, out, causal, window, q_offset, stream)
    _raise_on(rc, "flash_attention", q.shape[-1])
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention`'s output and the row logsumexp of the scaled
    scores: (o (B, Sq, H, D) in q.dtype, lse (B, Sq, H) f32), lse NEG_INF
    (−1e30) for a row with no valid key. The training forward."""
    _check(q, k, v, window, q_offset)
    if not q.is_cuda:
        return ref.flash_attention_fwd(q, k, v, causal, window, q_offset)
    _check_rows_aligned("flash_attention_fwd", q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _build.load(CSRC, _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launch(lib, q, k, v, out, causal, window, q_offset, stream,
                     lse=lse)
    _raise_on(rc, "flash_attention_fwd", q.shape[-1])
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Sk, Hkv, D) in q.dtype, the GQA group summed in
    f32: the dK/dV kernel. ``delta`` is rowsum(do ⊙ o) (B, Sq, H) f32."""
    _check(q, k, v, window, q_offset)
    _check_bwd(q, do, lse, delta)
    if not q.is_cuda:
        return ref.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                           window, q_offset)
    _check_rows_aligned("flash_attention_bwd_dkv", q, k, v, do)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    lib = _build.load(CSRC_BWD, _bind_bwd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launch_bwd(lib, q, k, v, do, lse, delta, (dk, dv), causal,
                         window, q_offset, stream)
    _raise_on(rc, "flash_attention_bwd_dkv", q.shape[-1])
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           causal: bool = True, window: int = 0,
                           q_offset: int = 0) -> torch.Tensor:
    """dq (B, Sq, H, D) in q.dtype: the dQ kernel."""
    _check(q, k, v, window, q_offset)
    _check_bwd(q, do, lse, delta)
    if not q.is_cuda:
        return ref.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                          window, q_offset)
    _check_rows_aligned("flash_attention_bwd_dq", q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.load(CSRC_BWD, _bind_bwd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launch_bwd(lib, q, k, v, do, lse, delta, (dq,), causal,
                         window, q_offset, stream)
    _raise_on(rc, "flash_attention_bwd_dq", q.shape[-1])
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """(dq, dk, dv) of `flash_attention_fwd` at output cotangent ``do``:
    dq at H heads, dk and dv at Hkv heads (the GQA group summed). delta is
    computed here in plain PyTorch, then the dK/dV and the dQ kernels
    run."""
    if o.shape != q.shape:
        raise ValueError(f"o must match q: got {tuple(o.shape)}, q "
                         f"{tuple(q.shape)}")
    delta = ref.attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, window,
                                     q_offset)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, window,
                                q_offset)
    return dq, dk, dv


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
