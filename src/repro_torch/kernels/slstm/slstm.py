"""The fused sLSTM recurrence kernel on Hopper: wrapper, build, binding.

Port of `repro.kernels.slstm.slstm`. One CUDA source (csrc/slstm.cu, built
for sm_90a at first use by `kernels._build`, bound with ctypes): one block
per (head, batch row) runs the whole sequence, its state in shared memory.
The kernel reads xg in place through its batch and sequence strides, so the
wrapper copies nothing: it checks, allocates the outputs and launches.

Where the work runs. On a CUDA tensor `slstm_fused` launches the kernel, or
raises (a failed build, a refused launch): there is no fallback. On a CPU
tensor it runs the plain version (`ref.slstm_fused`). The kernel has no
backward (neither has the TPU kernel), so on a CUDA tensor under autograd
(grad mode on and an input that requires grad) it raises
NotImplementedError instead of returning a result that no gradient would
reach: xlstm training is ROADMAP Queue 1 item 13.

What it takes: xg (B, S, 4·d) f32 or bf16 with unit stride along 4·d; r
(4, nh, dh, dh) f32 or bf16, contiguous, with d = nh·dh; the state (c, n,
h, m), each a contiguous (B, d) f32 tensor; S ≥ 1, B ≤ 65535, dh ≤ 1024.
Anything else raises, on either device.

`LAUNCHES` counts kernel launches (bumped only where the kernel is
launched); `reset_launch_counts` zeroes it. `slstm_costs` gives the bytes
and operations of one call for the bound.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, Tuple

import torch

from .. import _build
from . import ref

__all__ = ["LAUNCHES", "build", "reset_launch_counts", "slstm_costs",
           "slstm_fused"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "slstm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 1024
_MAX_ROWS = 65535                 # gridDim.y = B

LAUNCHES: Dict[str, int] = {"slstm_fused": 0}


def reset_launch_counts() -> None:
    LAUNCHES["slstm_fused"] = 0


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/slstm.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


def _bind(lib: ctypes.CDLL) -> None:
    lib.slstm_launch.restype = ctypes.c_int
    lib.slstm_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_longlong]
        + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(xg: torch.Tensor, r: torch.Tensor, state, nh: int) -> None:
    if not isinstance(nh, int) or nh < 1:
        raise ValueError(f"nh must be a positive python int, got {nh!r}")
    if xg.dim() != 3 or r.dim() != 4:
        raise ValueError(f"need xg (B, S, 4·d) and r (4, nh, dh, dh), got "
                         f"{tuple(xg.shape)}, {tuple(r.shape)}")
    b, s, d4 = xg.shape
    g, rnh, dh, dh2 = r.shape
    if (g, rnh, dh2) != (4, nh, dh) or d4 != 4 * nh * dh:
        raise ValueError(f"r {tuple(r.shape)} does not fit xg "
                         f"{tuple(xg.shape)} with nh = {nh}: need r "
                         f"(4, nh, dh, dh) and 4·nh·dh = {d4}")
    if b < 1 or s < 1:
        raise ValueError(f"empty input: xg {tuple(xg.shape)}")
    if b > _MAX_ROWS or dh > MAX_DH:
        raise ValueError(f"at most {_MAX_ROWS} rows and a head dim of "
                         f"{MAX_DH}, got B = {b}, dh = {dh}")
    for name, t in (("xg", xg), ("r", r)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be one of {list(_DTYPES)}, got "
                             f"{t.dtype}")
    if xg.stride(-1) != 1:
        raise ValueError(f"xg needs unit stride along 4·d, got strides "
                         f"{xg.stride()}")
    if r.device != xg.device or not r.is_contiguous():
        raise ValueError(f"r must be contiguous on {xg.device}")
    if len(state) != 4:
        raise ValueError(f"state must be (c, n, h, m), got {len(state)} "
                         f"tensors")
    for name, t in zip("cnhm", state):
        if (tuple(t.shape) != (b, d4 // 4) or t.dtype != torch.float32
                or t.device != xg.device or not t.is_contiguous()):
            raise ValueError(f"state {name} must be a contiguous f32 "
                             f"(B, d) = {(b, d4 // 4)} tensor on "
                             f"{xg.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def _launch(lib: ctypes.CDLL, xg: torch.Tensor, r: torch.Tensor, state,
            hs: torch.Tensor, out, stream: int) -> int:
    """Marshal one call of `slstm_launch`; returns its code."""
    b, s, _ = xg.shape
    _, nh, dh, _ = r.shape
    return lib.slstm_launch(
        _DTYPES[xg.dtype], _DTYPES[r.dtype], xg.data_ptr(), xg.stride(0),
        xg.stride(1), r.data_ptr(), *(t.data_ptr() for t in state),
        hs.data_ptr(), *(t.data_ptr() for t in out), b, s, nh, dh, stream)


def slstm_fused(xg: torch.Tensor, r: torch.Tensor, state, nh: int):
    """xg: (B, S, 4·d) pre-activations [z, i, f, o]; r: (4, nh, dh, dh);
    state: (c, n, h, m) each (B, d) f32. Returns (hs (B, S, d) f32,
    (c, n, h, m)), each state tensor new."""
    _check(xg, r, state, nh)
    if not xg.is_cuda:
        return ref.slstm_fused(xg, r, state, nh)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xg, r, *state)):
        raise NotImplementedError(
            "slstm_fused has no backward on the card: xlstm training is "
            "not ported yet (ROADMAP Queue 1 item 13)")
    b, s, d4 = xg.shape
    hs = torch.empty((b, s, d4 // 4), dtype=torch.float32, device=xg.device)
    out = tuple(torch.empty_like(t) for t in state)
    lib = _build.load(CSRC, _bind)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        rc = _launch(lib, xg, r, state, hs, out, stream)
    if rc != 0:
        raise RuntimeError(f"slstm_fused: kernel launch failed with code "
                           f"{rc}")
    LAUNCHES["slstm_fused"] += 1
    return hs, out


def slstm_costs(b: int, s: int, nh: int, dh: int,
                xg_dtype: torch.dtype = torch.bfloat16,
                r_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Bytes and operations of one call, for the bound: xg read once, hs
    (f32) written once, r read once, four (B, d) f32 states read and
    four written; the recurrent product's 2·B·S·4d·dh operations (the
    gates' few dozen a column and step are left out)."""
    d = nh * dh
    xb = torch.tensor([], dtype=xg_dtype).element_size()
    rb = torch.tensor([], dtype=r_dtype).element_size()
    n_bytes = (b * s * 4 * d * xb + b * s * d * 4 + 4 * nh * dh * dh * rb
               + 8 * b * d * 4)
    return {"bytes": float(n_bytes), "flops": 2.0 * b * s * 4 * d * dh}
