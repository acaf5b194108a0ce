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
runs the plain version (`ref.slstm_fused`). The bare wrapper has no
backward (neither has the TPU kernel), so on a CUDA tensor under autograd
(grad mode on and an input that requires grad) it raises
NotImplementedError instead of returning a result that no gradient would
reach: training goes through `models.xlstm.slstm_scan`, a
`torch.autograd.Function` whose backward is `slstm_fused_bwd`.

The backward. `slstm_fused_bwd` recomputes the gate pre-activations from
hs by one batched product (`ref.recompute`) and hands them, with R
transposed, to a second source (csrc/slstm_bwd.cu), which runs the whole
reverse sequence in one launch and also recomputes c, n, m into a scratch
buffer; dr is one einsum over h_{t−1} and the kernel's dpre. Its plan
(`_plan_bwd`, which the source's `bwd_plan` mirrors) takes, by shape alone:
- `slstm_bwd_kernel_cluster` for dh ≤ 256 (the trained xlstm shapes among
  them): the forward's cluster layout transposed, a cluster of Q CTAs per
  head and group of RB rows, each lane holding its slice of R in
  registers for the whole launch, the four gates' dpre of each step
  handed to every peer with st.async counted on the peer's mbarrier;
- `slstm_bwd_kernel`, the stream kernel, for the rest: one block per
  (head, batch row), R read from device memory every step.
A failed launch raises; neither falls back to the other or to the plain
loop. On a CPU tensor it runs `ref.slstm_fused_bwd`. It takes f32 or bf16
xg and r, returns dxg in xg's type and dr in r's (the rounding autograd
gives a cast), and refuses what `slstm_fused` refuses.

What it takes: xg (B, S, 4·d) f32 or bf16 with unit stride along 4·d; r
(4, nh, dh, dh) f32 or bf16, contiguous, with d = nh·dh; the state (c, n,
h, m), each a contiguous (B, d) f32 tensor; S ≥ 1, B ≤ 65535, dh ≤ 1024.
Anything else raises, on either device.

Opaque ops. `slstm_fused` and `slstm_fused_bwd` run through
`torch.library.custom_op`s (``torch.ops.repro_torch.slstm_fused`` and
``slstm_fused_bwd``): a fake kernel gives their outputs' shapes and types
and launches nothing, and a flop formula (`torch.utils.flop_counter`)
counts the work of the call, from `slstm_costs` (the forward) and from
`slstm_bwd_costs` plus the backward's two batched products (the
recompute of pre and dr's einsum). A DTensor reaching an op raises, and
the launchers refuse any tensor without device memory of its own (a
DTensor or a FakeTensor): nothing launches from one.

`LAUNCHES` counts kernel launches ("slstm_fused", "slstm_fused_bwd") and
`INSTANCE_LAUNCHES` the launches of each kernel ("cluster", "stream",
"bwd_cluster", "bwd_stream"; all bumped only where a kernel is launched);
`reset_launch_counts` zeroes both. `slstm_costs` and `slstm_bwd_costs`
give the bytes and operations of one call for the bound.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from . import ref

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "build", "build_bwd",
           "reset_launch_counts", "slstm_bwd_costs", "slstm_costs",
           "slstm_fused", "slstm_fused_bwd"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "slstm.cu"
CSRC_BWD = CSRC.with_name("slstm_bwd.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 1024
_MAX_ROWS = 65535                 # gridDim.y = B
# the cluster kernel's limits (csrc/slstm.cu: CL_MAX_THREADS, CL_MAX_KP,
# CL_GPCS, CL_GPC_SMS)
_CL_MAX_THREADS = 512
_CL_MAX_KP = 32                   # k a lane, R in registers: dh <= 256
_CL_GPCS, _CL_GPC_SMS = 8, 14     # H100 SXM: GPCs, and the fewest SMs of one

LAUNCHES: Dict[str, int] = {"slstm_fused": 0, "slstm_fused_bwd": 0}
INSTANCE_LAUNCHES: Dict[str, int] = {"cluster": 0, "stream": 0,
                                     "bwd_cluster": 0, "bwd_stream": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in INSTANCE_LAUNCHES:
        INSTANCE_LAUNCHES[name] = 0


class Plan(NamedTuple):
    """How a shape runs: `instance` "cluster" or "stream" (the backward's
    "bwd_cluster" or "bwd_stream"); for a cluster kernel the cluster size
    `q` and the batch rows a CTA `rb` (0 for stream); `smem` the dynamic
    shared memory of a block in bytes."""
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


def _layout_bwd(dh: int, q: int, rb: int) -> Tuple[int, int, int]:
    """The backward cluster kernel's (threads, shared-memory bytes, e a
    lane) at head dim dh, cluster size q and rb rows a CTA
    (csrc/slstm_bwd.cu's `bwd_layout`): the forward's warps and lanes with
    k and e swapped, a warp per two rows k, eight lanes a gate each summing
    an e-block of kp (a multiple of 4); two mbarriers, then two dpre
    buffers of rb rows, each row eight e-blocks of kp columns' four gates
    at a stride ≡ 4 (mod 32) floats."""
    threads, _, kp = _layout(dh, q, rb)
    eb = 4 * kp + (4 - 4 * kp) % 32
    return threads, 16 + 4 * 2 * rb * 8 * eb, kp


def _plan_bwd(b: int, nh: int, dh: int) -> Plan:
    """The backward's kernel and geometry for xg (b, S, 4·nh·dh)
    (csrc/slstm_bwd.cu's `bwd_plan`, which slstm_bwd_launch runs): the
    cluster kernel for dh ≤ 256 with the forward's Q and RB, the stream
    kernel everywhere else."""
    fwd = _plan(b, nh, dh)
    if fwd.instance == "cluster":
        return Plan("bwd_cluster", fwd.q, fwd.rb,
                    _layout_bwd(dh, fwd.q, fwd.rb)[1])
    return Plan("bwd_stream", 0, 0, 12 * dh * 4)


def build() -> Tuple[pathlib.Path, str]:
    """Compile csrc/slstm.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC)


def build_bwd() -> Tuple[pathlib.Path, str]:
    """Compile csrc/slstm_bwd.cu for sm_90a (`kernels._build.build`)."""
    return _build.build(CSRC_BWD)


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


# slstm_bwd_launch's argument types (`_launch_bwd` marshals them)
BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])


def _bind_bwd(lib: ctypes.CDLL) -> None:
    for name in ("slstm_bwd_launch", "slstm_bwd_stream_launch"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = BWD_ARGTYPES
    lib.slstm_bwd_cluster_launch.restype = ctypes.c_int
    lib.slstm_bwd_cluster_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] + BWD_ARGTYPES)
    lib.slstm_bwd_plan.restype = ctypes.c_int
    lib.slstm_bwd_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]


def _lib() -> ctypes.CDLL:
    """The built library, opened once per process (`kernels._build.load`)."""
    return _build.load(CSRC, _bind)


def _lib_bwd() -> ctypes.CDLL:
    """The backward's built library, opened once per process."""
    return _build.load(CSRC_BWD, _bind_bwd)


def _lib_plan(lib: ctypes.CDLL, b: int, nh: int, dh: int) -> Plan:
    """The plan the built library's `slstm_plan` gives (what slstm_launch
    runs), to hold `_plan` to it on the card."""
    out = (ctypes.c_int * 3)()
    cluster = lib.slstm_plan(b, nh, dh, out)
    return Plan("cluster" if cluster else "stream", *out)


def _lib_plan_bwd(lib: ctypes.CDLL, b: int, nh: int, dh: int) -> Plan:
    """The plan the backward library's `slstm_bwd_plan` gives (what
    slstm_bwd_launch runs), to hold `_plan_bwd` to it on the card."""
    out = (ctypes.c_int * 3)()
    cluster = lib.slstm_bwd_plan(b, nh, dh, out)
    return Plan("bwd_cluster" if cluster else "bwd_stream", *out)


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
    ptr = _build.device_ptr
    return (_DTYPES[xg.dtype], _DTYPES[r.dtype], ptr("xg", xg),
            xg.stride(0), xg.stride(1), ptr("r", r),
            *(ptr(f"state {n}", t) for n, t in zip("cnhm", state)),
            ptr("hs", hs), *(ptr(f"out {n}", t) for n, t in zip("cnhm", out)),
            b, s, nh, dh, stream)


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
    if xg.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in (xg, r, *state)):
        raise NotImplementedError(
            "slstm_fused has no backward of its own: differentiate through "
            "models.xlstm.slstm_scan, whose backward is slstm_fused_bwd")
    hs, *out = torch.ops.repro_torch.slstm_fused(xg, r, *state, nh)
    return hs, tuple(out)


_STATE_ARGS = "Tensor c, Tensor n, Tensor h, Tensor m"


@torch.library.custom_op(
    "repro_torch::slstm_fused", mutates_args=(),
    schema=f"(Tensor xg, Tensor r, {_STATE_ARGS}, int nh) -> "
           f"(Tensor, Tensor, Tensor, Tensor, Tensor)")
def _slstm_fused_op(xg, r, c, n, h, m, nh):
    state = (c, n, h, m)
    if not xg.is_cuda:
        hs, out = ref.slstm_fused(xg, r, state, nh)
        return (hs, *out)
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
    return (hs, *out)


@_slstm_fused_op.register_fake
def _(xg, r, c, n, h, m, nh):
    b, s, d4 = xg.shape
    return (xg.new_empty((b, s, d4 // 4), dtype=torch.float32),
            *(t.new_empty(t.shape) for t in (c, n, h, m)))


def _launch_bwd(lib: ctypes.CDLL, pre: torch.Tensor, r_t: torch.Tensor,
                hs: torch.Tensor, dhs: torch.Tensor, state, dstate,
                cnm: torch.Tensor, dpre: torch.Tensor, dstate0,
                nh: int, stream: int, forced=None,
                max_clusters: "ctypes.c_int | None" = None) -> int:
    """Marshal one call of `slstm_bwd_launch` (every tensor contiguous; r_t
    is R transposed, (4, nh, dh, dh) with [g, hd, e, k] = r[g, hd, k, e]);
    with ``forced`` "stream" of `slstm_bwd_stream_launch`, with a (q, rb)
    of `slstm_bwd_cluster_launch` (which, given `max_clusters`, a
    ctypes.c_int, launches nothing and sets it to how many such clusters
    the card holds at once). Returns its code."""
    b, s, d4 = pre.shape
    dh = d4 // (4 * nh)
    c0, n0, _, m0 = state
    ptrs = [_build.device_ptr(n, t) for n, t in (
        ("pre", pre), ("r_t", r_t), ("hs", hs), ("dhs", dhs), ("c0", c0),
        ("n0", n0), ("m0", m0), *((f"dstate {k}", t)
                                  for k, t in zip("cnhm", dstate)),
        ("cnm", cnm), ("dpre", dpre),
        *((f"dstate0 {k}", t) for k, t in zip("cnhm", dstate0)))]
    args = (_DTYPES[r_t.dtype], *ptrs, b, s, nh, dh, stream)
    if forced is None:
        return lib.slstm_bwd_launch(*args)
    if forced == "stream":
        return lib.slstm_bwd_stream_launch(*args)
    ref_ = None if max_clusters is None else ctypes.byref(max_clusters)
    return lib.slstm_bwd_cluster_launch(*forced, ref_, *args)


def _f32c(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _check_bwd(xg: torch.Tensor, r: torch.Tensor, state, nh: int,
               hs: torch.Tensor, dhs: torch.Tensor, dstate) -> None:
    _check(xg, r, state, nh)
    b, s, d4 = xg.shape
    for name, t, shape in (("hs", hs, (b, s, d4 // 4)),
                           ("dhs", dhs, (b, s, d4 // 4)),
                           *((f"dstate {k}", t, (b, d4 // 4))
                             for k, t in zip("cnhm", dstate))):
        if tuple(t.shape) != shape or t.device != xg.device:
            raise ValueError(f"{name} must be {shape} on {xg.device}, got "
                             f"{tuple(t.shape)} on {t.device}")


def _bwd_call(xg: torch.Tensor, r: torch.Tensor, state, nh: int,
              hs: torch.Tensor, dhs: torch.Tensor, dstate, forced=None):
    """The backward on a CUDA tensor: the recompute, one kernel launch
    (the plan's, or ``forced``: "stream" or a cluster (q, rb)), dr's
    einsum. Raises where the launch fails."""
    b, s, d4 = xg.shape
    dh = d4 // (4 * nh)
    if forced is None:
        instance = _plan_bwd(b, nh, dh).instance
    else:
        instance = "bwd_stream" if forced == "stream" else "bwd_cluster"
    with torch.no_grad():
        pre, h_prev = ref.recompute(xg, r, state, nh, hs)
        r_t = r.transpose(2, 3).contiguous()
        hs_, dhs_ = _f32c(hs), _f32c(dhs)
        dst_in = tuple(_f32c(t) for t in dstate)
        cnm = torch.empty((3, b, s, d4 // 4), dtype=torch.float32,
                          device=xg.device)
        dpre = torch.empty_like(pre)
        dst0 = tuple(torch.empty_like(t) for t in dst_in)
        lib = _lib_bwd()
        with torch.cuda.device(xg.device):
            stream = torch.cuda.current_stream(xg.device).cuda_stream
            rc = _launch_bwd(lib, pre, r_t, hs_, dhs_, state, dst_in, cnm,
                             dpre, dst0, nh, stream, forced)
        if rc != 0:
            raise RuntimeError(f"slstm_fused_bwd: {instance} kernel launch "
                               f"failed with code {rc}")
        LAUNCHES["slstm_fused_bwd"] += 1
        INSTANCE_LAUNCHES[instance] += 1
        del cnm, pre
        dr = torch.einsum("bshk,bsghe->ghke",
                          h_prev.reshape(b, s, nh, dh),
                          dpre.reshape(b, s, 4, nh, dh))
        return dpre.to(xg.dtype), dr.to(r.dtype), dst0


def slstm_fused_bwd(xg: torch.Tensor, r: torch.Tensor, state, nh: int,
                    hs: torch.Tensor, dhs: torch.Tensor, dstate):
    """The backward of `slstm_fused` at its inputs (xg, r, state) and its
    hs (B, S, d) f32: given dhs (B, S, d) and the final state's
    cotangents (dc, dn, dh, dm), each (B, d), returns (dxg in xg's type,
    dr in r's type, (dc0, dn0, dh0, dm0) f32). One launch of the plan's
    backward kernel on a CUDA tensor (or a raise); `ref.slstm_fused_bwd`
    on a CPU tensor."""
    _check_bwd(xg, r, state, nh, hs, dhs, dstate)
    dxg, dr, *dst = torch.ops.repro_torch.slstm_fused_bwd(
        xg, r, *state, hs, dhs, *dstate, nh)
    return dxg, dr, tuple(dst)


@torch.library.custom_op(
    "repro_torch::slstm_fused_bwd", mutates_args=(),
    schema=f"(Tensor xg, Tensor r, {_STATE_ARGS}, Tensor hs, Tensor dhs, "
           f"Tensor dc, Tensor dn, Tensor dh, Tensor dm, int nh) -> "
           f"(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
def _slstm_fused_bwd_op(xg, r, c, n, h, m, hs, dhs, dc, dn, dh, dm, nh):
    state, dstate = (c, n, h, m), (dc, dn, dh, dm)
    if not xg.is_cuda:
        dxg, dr, dst = ref.slstm_fused_bwd(xg, r, state, nh, hs, dhs,
                                           dstate)
        return (dxg.to(xg.dtype), dr.to(r.dtype), *dst)
    dxg, dr, dst = _bwd_call(xg, r, state, nh, hs, dhs, dstate)
    return (dxg, dr, *dst)


@_slstm_fused_bwd_op.register_fake
def _(xg, r, c, n, h, m, hs, dhs, dc, dn, dh, dm, nh):
    return (xg.new_empty(xg.shape), r.new_empty(r.shape),
            *(t.new_empty(t.shape, dtype=torch.float32)
              for t in (c, n, h, m)))


def _slstm_shape(xg_shape, r_shape):
    b, s, _ = xg_shape
    _, nh, dh, _ = r_shape
    return b, s, nh, dh


def _register_flops() -> None:
    """The calls' work for `FlopCounterMode` (and the dry run): the
    forward's recurrent product (`slstm_costs`); the backward's transpose
    product (`slstm_bwd_costs`) plus its recompute of pre and dr's einsum,
    each as many operations again. Registered once per process."""
    from torch.utils.flop_counter import flop_registry
    fwd = torch.ops.repro_torch.slstm_fused
    bwd = torch.ops.repro_torch.slstm_fused_bwd
    if fwd not in flop_registry:
        @register_flop_formula(fwd)
        def _fwd(xg_shape, r_shape, *rest, out_shape=None, **kw):
            return int(slstm_costs(*_slstm_shape(xg_shape,
                                                 r_shape))["flops"])
    if bwd not in flop_registry:
        @register_flop_formula(bwd)
        def _bwd(xg_shape, r_shape, *rest, out_shape=None, **kw):
            return int(3 * slstm_bwd_costs(*_slstm_shape(
                xg_shape, r_shape))["flops"])


_register_flops()


def _forced_bwd(forced, xg: torch.Tensor, r: torch.Tensor, state, nh: int,
                hs: torch.Tensor, dhs: torch.Tensor, dstate):
    """`slstm_fused_bwd` on a CUDA tensor with the kernel named, not
    planned: "stream", or the cluster kernel at a (q, rb). For the card
    tests, chip_smoke.py and the sweep, which hold the two designs against
    each other; the model never calls it."""
    if not xg.is_cuda:
        raise ValueError(f"a forced {forced!r} backward needs a CUDA "
                         f"tensor, got one on {xg.device}")
    _check_bwd(xg, r, state, nh, hs, dhs, dstate)
    return _bwd_call(xg, r, state, nh, hs, dhs, dstate, forced)


def slstm_bwd_costs(b: int, s: int, nh: int, dh: int,
                    r_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Bytes and operations of one backward launch, for the bound: the
    saved values it needs read once (pre (B, S, 4d), c, n, m, hs and dhs
    (B, S, d) each, f32), dpre (f32) written once, R read once (as if it
    stayed on chip), four (B, d) f32 states read and four written; the
    transpose product's 2·B·S·4d·dh operations (the gates' few dozen a
    column and step are left out)."""
    d = nh * dh
    rb = torch.tensor([], dtype=r_dtype).element_size()
    n_bytes = (b * s * (4 * d + 5 * d) * 4 + b * s * 4 * d * 4
               + 4 * nh * dh * dh * rb + 8 * b * d * 4)
    return {"bytes": float(n_bytes), "flops": 2.0 * b * s * 4 * d * dh}


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
