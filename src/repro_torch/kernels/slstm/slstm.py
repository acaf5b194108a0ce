"""The fused sLSTM recurrence kernel on Hopper: wrapper, build, binding.

Port of `repro.kernels.slstm.slstm`. One CUDA source (csrc/slstm.cu, built
for sm_90a at first use by `kernels._build`, bound with ctypes) holds two
kernels, and the shape alone chooses between them (`_plan`, which the
source's `plan` mirrors):
- `slstm_kernel_cluster`, for dh ≤ 256 (the served xlstm shapes among
  them): a cluster of Q CTAs per head and group of RB batch rows, each
  CTA holding its columns' R on chip, in registers, for the whole launch
  and handing h to its peers through distributed shared memory, counted
  on the receiver's mbarrier (no barrier across the cluster in the loop);
- `slstm_kernel_stream`, for the rest (dh up to 1024): one block per
  (head, batch row), R read from device memory every step.
Both run the whole sequence in one launch and read xg in place through
its batch and sequence strides, so the wrapper copies nothing: it checks,
allocates the outputs and launches.

Where the work runs. On a CUDA tensor `slstm_fused` launches a kernel, or
raises (a failed build, a refused launch): there is no fallback, neither
to the plain version nor from one kernel to the other. On a CPU tensor it
runs the plain version (`ref.slstm_fused`). The kernels have no backward
(neither has the TPU kernel), so on a CUDA tensor under autograd (grad
mode on and an input that requires grad) it raises NotImplementedError
instead of returning a result that no gradient would reach: xlstm
training is ROADMAP Queue 1 item 10.

What it takes: xg (B, S, 4·d) f32 or bf16 with unit stride along 4·d; r
(4, nh, dh, dh) f32 or bf16, contiguous, with d = nh·dh; the state (c, n,
h, m), each a contiguous (B, d) f32 tensor; S ≥ 1, B ≤ 65535, dh ≤ 1024.
Anything else raises, on either device.

`LAUNCHES` counts kernel launches and `INSTANCE_LAUNCHES` the launches of
each kernel (both bumped only where a kernel is launched);
`reset_launch_counts` zeroes both. `slstm_costs` gives the bytes and
operations of one call for the bound.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, List, NamedTuple, Tuple

import torch

from .. import _build
from . import ref

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "build", "reset_launch_counts",
           "slstm_costs", "slstm_fused"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "slstm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 1024
_MAX_ROWS = 65535                 # gridDim.y = B
# the cluster kernel's limits (csrc/slstm.cu: CL_MAX_THREADS, CL_MAX_KP,
# CL_GPCS, CL_GPC_SMS)
_CL_MAX_THREADS = 512
_CL_MAX_KP = 32                   # k a lane, R in registers: dh <= 256
_CL_GPCS, _CL_GPC_SMS = 8, 14     # H100 SXM: GPCs, and the fewest SMs of one

LAUNCHES: Dict[str, int] = {"slstm_fused": 0}
INSTANCE_LAUNCHES: Dict[str, int] = {"cluster": 0, "stream": 0}


def reset_launch_counts() -> None:
    LAUNCHES["slstm_fused"] = 0
    for name in INSTANCE_LAUNCHES:
        INSTANCE_LAUNCHES[name] = 0


class Plan(NamedTuple):
    """How a shape runs: `instance` "cluster" or "stream"; for the cluster
    kernel the cluster size `q` and the batch rows a CTA `rb` (0 for
    stream); `smem` the dynamic shared memory of a block in bytes."""
    instance: str
    q: int
    rb: int
    smem: int


def _layout(dh: int, q: int, rb: int) -> Tuple[int, int, int]:
    """The cluster kernel's (threads, shared-memory bytes, k a lane) at
    head dim dh, cluster size q and rb rows a CTA (csrc/slstm.cu's
    `cluster_layout`): a warp per two columns, eight lanes a gate each
    summing a k-block of kp (a multiple of 4); two mbarriers, then two h
    buffers of rb rows, their k-blocks at a stride ≡ 4 (mod 32) floats."""
    nw = (-(-dh // q) + 1) // 2
    kp = (-(-dh // 8) + 3) // 4 * 4
    hp = kp + (4 - kp) % 32
    return 32 * nw, 16 + 4 * 2 * rb * 8 * hp, kp


def _fits(dh: int, q: int, rb: int) -> bool:
    threads, _, kp = _layout(dh, q, rb)
    return threads <= _CL_MAX_THREADS and kp <= _CL_MAX_KP


def _columns(dh: int, q: int) -> List[Tuple[int, int]]:
    """(first column, count) of each CTA of a cluster of q: the ragged
    split [i·dh/q, (i+1)·dh/q) that csrc/slstm.cu uses."""
    return [(i * dh // q, (i + 1) * dh // q - i * dh // q) for i in range(q)]


def _plan(b: int, nh: int, dh: int) -> Plan:
    """The kernel and its geometry for xg (b, S, 4·nh·dh) (csrc/slstm.cu's
    `plan`, which slstm_launch runs): the cluster kernel where it fits
    (dh ≤ 256), with the fewest CTAs a head the thread limit allows (Q =
    ceil(dh / 32)) and RB the fewest rows a CTA (1, 2, 4) that keep all
    clusters on the card at once (a CTA an SM, a cluster within one of 8
    GPCs of at least 14 SMs); the stream kernel everywhere else."""
    if nh <= 65535:
        q, rb = -(-dh // 32), 1
        fit = _CL_GPCS * (_CL_GPC_SMS // q)
        while rb < 4 and nh * -(-b // rb) > fit:
            rb *= 2
        if _fits(dh, q, rb):
            return Plan("cluster", q, rb, _layout(dh, q, rb)[1])
    return Plan("stream", 0, 0, 8 * dh * 4)


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/slstm.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


# slstm_launch's argument types (`_args` marshals them)
LAUNCH_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_longlong]
                   + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])


def _bind(lib: ctypes.CDLL) -> None:
    lib.slstm_launch.restype = ctypes.c_int
    lib.slstm_launch.argtypes = LAUNCH_ARGTYPES
    lib.slstm_cluster_launch.restype = ctypes.c_int
    lib.slstm_cluster_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] + LAUNCH_ARGTYPES)
    lib.slstm_plan.restype = ctypes.c_int
    lib.slstm_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]


def _lib() -> ctypes.CDLL:
    """The built library, opened once per process (`kernels._build.load`)."""
    return _build.load(CSRC, _bind)


def _lib_plan(lib: ctypes.CDLL, b: int, nh: int, dh: int) -> Plan:
    """The plan the built library's `slstm_plan` gives (what slstm_launch
    runs), to hold `_plan` to it on the card."""
    out = (ctypes.c_int * 3)()
    cluster = lib.slstm_plan(b, nh, dh, out)
    return Plan("cluster" if cluster else "stream", *out)


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


def _args(xg: torch.Tensor, r: torch.Tensor, state, hs: torch.Tensor, out,
          stream: int) -> tuple:
    b, s, _ = xg.shape
    _, nh, dh, _ = r.shape
    return (_DTYPES[xg.dtype], _DTYPES[r.dtype], xg.data_ptr(), xg.stride(0),
            xg.stride(1), r.data_ptr(), *(t.data_ptr() for t in state),
            hs.data_ptr(), *(t.data_ptr() for t in out), b, s, nh, dh, stream)


def _launch(lib: ctypes.CDLL, xg: torch.Tensor, r: torch.Tensor, state,
            hs: torch.Tensor, out, stream: int) -> int:
    """Marshal one call of `slstm_launch`; returns its code."""
    return lib.slstm_launch(*_args(xg, r, state, hs, out, stream))


def _launch_cluster(lib: ctypes.CDLL, q: int, rb: int, xg: torch.Tensor,
                    r: torch.Tensor, state, hs: torch.Tensor, out,
                    stream: int,
                    max_clusters: "ctypes.c_int | None" = None) -> int:
    """Marshal one call of `slstm_cluster_launch`: the cluster kernel with
    an explicit Q and RB (the sweep in `sweep.py`, and the card tests of
    instances the plan rarely takes). With
    `max_clusters` (a ctypes.c_int) it launches nothing and sets it to how
    many such clusters the card holds at once. Returns its code."""
    ref_ = None if max_clusters is None else ctypes.byref(max_clusters)
    return lib.slstm_cluster_launch(q, rb, ref_,
                                    *_args(xg, r, state, hs, out, stream))


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
            "not ported yet (ROADMAP Queue 1 item 10)")
    b, s, d4 = xg.shape
    plan = _plan(b, nh, d4 // (4 * nh))
    hs = torch.empty((b, s, d4 // 4), dtype=torch.float32, device=xg.device)
    out = tuple(torch.empty_like(t) for t in state)
    lib = _lib()
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        rc = _launch(lib, xg, r, state, hs, out, stream)
    if rc != 0:
        raise RuntimeError(f"slstm_fused: kernel launch failed with code "
                           f"{rc}")
    LAUNCHES["slstm_fused"] += 1
    INSTANCE_LAUNCHES[plan.instance] += 1
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
