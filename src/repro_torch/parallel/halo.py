"""Halo-exchange stream sharding: the paper's stream partitioning
(SSM/MSM/OGM/ORM, §5.3) spread over ranks.

Port of `repro.parallel.halo`. The reference runs one `shard_map` from a
single controller; the port is SPMD over `torch.distributed`, one rank per
CNN instance:

    N_i CNN instances            →  the ranks along one mesh dim
    SSM/MSM binary split tree    →  the mesh dim itself (each rank already
                                    holds its contiguous piece of the stream)
    OGM overlap generation       →  the halo exchange: each rank sends its
                                    left and right boundary samples to its
                                    neighbours (`dist.batch_isend_irecv`, the
                                    reference's two `ppermute`s without the
                                    wrap-around), 2·o_act symbols a rank in
                                    place of re-streaming overlapped windows
    ORM overlap removal          →  each rank drops the halo after compute

The halo width is the receptive-field formula of paper §6.1
(`core.stream_partition.actual_overlap`, in samples by `halo_samples`).
Rank 0's left halo and the last rank's right halo are zeros, as the engine
pads the whole stream, so `halo_apply` equals the engine on the unsplit
stream at every position, and bitwise on every datapath: the port's
kernels fix each output's order of accumulation wherever it sits in a
launch. Each rank's engine runs its own fused kernel launch on its chunk,
so the paper's two parallelisms compose: N_i instances (ranks) × the
kernel's tiling.

With a fused_int8 engine the halo itself travels as int8: the boundary
samples are requantized to the engine's layer-0 activation grid
(`kernels.cnn_eq.ref.requant_int8`) before they are sent and dequantized
on arrival: 4× fewer bytes, and the output stays bitwise, because the
kernel requantizes its input to the same grid and requantization is
idempotent.

Transport: NCCL moves the edges device to device. Any other backend gets a
CUDA tensor's edges copied to the host before the send and back after the
receive (gloo, whose point-to-point takes CPU tensors only; a host with one
card runs its ranks over gloo, since NCCL refuses two ranks on one GPU).
The choice is `launch.mesh.stages_through_host`, made from the group's
backend and the tensor's device.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.equalizer import CNNEqConfig
from ..core.stream_partition import actual_overlap, chunk_lengths
from ..kernels.cnn_eq.cnn_eq import dequant_int8
from ..kernels.cnn_eq.ref import requant_int8
from ..launch.mesh import stages_through_host
from .sharding import mesh_axes


def halo_exchange(x: torch.Tensor, halo: int, group=None,
                  quant: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """This rank's chunk (..., W) → (..., W + 2·halo), the neighbours'
    boundary samples attached (zeros at the stream edges).

    group: the process group of the ranks that hold the stream, in stream
    order (None: the default group). With one rank, or ``halo == 0``, it
    only pads. quant: optional (a_int, a_frac), the consumer's LAYER-0
    activation format: the edges then travel as int8 on that grid.
    """
    n = dist.get_world_size(group)
    if halo == 0 or n == 1:
        return F.pad(x, (halo, halo))
    if x.shape[-1] < halo:
        raise ValueError(f"a chunk of {x.shape[-1]} samples cannot give a "
                         f"halo of {halo}")
    if quant is not None:
        a_int, a_frac = quant
        pack = lambda e: requant_int8(e, a_int, a_frac)      # fp32 → int8
        unpack = lambda q: dequant_int8(q, a_frac)           # int8 → fp32
    else:
        pack = lambda e: e.contiguous()
        unpack = lambda e: e
    me = dist.get_rank(group)
    peer = (lambda r: r) if group is None else (
        lambda r: dist.get_global_rank(group, r))
    host = stages_through_host(group, x.device)
    wire = torch.device("cpu") if host else x.device
    # my RIGHT edge becomes my right neighbour's LEFT halo, and back
    right_edge = pack(x[..., -halo:]).to(wire)
    left_edge = pack(x[..., :halo]).to(wire)
    left_halo = torch.zeros_like(left_edge)
    right_halo = torch.zeros_like(right_edge)
    ops = []
    if me + 1 < n:
        ops += [dist.P2POp(dist.isend, right_edge, peer(me + 1), group),
                dist.P2POp(dist.irecv, right_halo, peer(me + 1), group)]
    if me > 0:
        ops += [dist.P2POp(dist.isend, left_edge, peer(me - 1), group),
                dist.P2POp(dist.irecv, left_halo, peer(me - 1), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([unpack(left_halo.to(x.device)), x,
                      unpack(right_halo.to(x.device))], dim=-1)


def _engine_halo_quant(apply_fn) -> Optional[Tuple[int, int]]:
    """(a_int, a_frac) of the engine's FIRST layer when the int8 exchange
    is lossless: apply_fn is a fused_int8 `EqualizerEngine` (duck-typed)."""
    if getattr(apply_fn, "backend", None) != "fused_int8":
        return None
    formats = getattr(apply_fn, "formats", None)
    if not formats:
        return None
    _, _, a_int, a_frac = formats[0]
    return (int(a_int), int(a_frac))


def halo_samples(cfg: CNNEqConfig, n_inst: int) -> int:
    """o_act in SAMPLES (the paper's o_act is in symbols; the waveform
    carries N_os samples per symbol)."""
    return actual_overlap(cfg, n_inst) * cfg.n_os


def _axis(mesh, axis: str):
    """(process group, ranks, this rank's index) of ``axis`` of a
    `DeviceMesh`."""
    return mesh.get_group(axis), mesh_axes(mesh)[axis], \
        mesh.get_local_rank(axis)


def local_shard(x, cfg: CNNEqConfig, mesh, axis: str = "data"
                ) -> torch.Tensor:
    """This rank's contiguous piece of a whole waveform (..., S·N_os): the
    shard `halo_apply` takes. The stream's S symbols must divide by the
    ranks along ``axis`` (the reference's P(axis) requires it), else
    ValueError."""
    _, n, idx = _axis(mesh, axis)
    x = torch.as_tensor(x)
    if x.shape[-1] % cfg.n_os:
        raise ValueError(f"a waveform of {x.shape[-1]} samples is not whole "
                         f"symbols of {cfg.n_os} samples")
    w = chunk_lengths(x.shape[-1] // cfg.n_os, n) * cfg.n_os
    return x[..., idx * w:(idx + 1) * w]


def _halo_call(apply_fn, x_local, cfg: CNNEqConfig, mesh, axis: str
               ) -> torch.Tensor:
    group, n, _ = _axis(mesh, axis)
    x = torch.as_tensor(x_local, device=getattr(apply_fn, "device", None))
    if x.dtype != torch.float32:
        raise TypeError(f"waveform must be float32, got {x.dtype}")
    if x.shape[-1] % cfg.n_os:
        raise ValueError(f"a shard of {x.shape[-1]} samples is not whole "
                         f"symbols of {cfg.n_os} samples")
    o_samp = halo_samples(cfg, n)
    o_sym = o_samp // cfg.n_os
    ext = halo_exchange(x, o_samp, group, _engine_halo_quant(apply_fn))  # OGM
    y = apply_fn(ext)                                     # CNN instance
    return y[:, o_sym:y.shape[1] - o_sym]                 # ORM


def halo_apply(apply_fn: Callable[[torch.Tensor], torch.Tensor], x_local,
               cfg: CNNEqConfig, mesh, axis: str = "data") -> torch.Tensor:
    """Equalize this rank's shard of a stream sharded over ``axis`` of
    ``mesh`` (a `DeviceMesh`; `local_shard` cuts the shard).

    apply_fn: an `EqualizerEngine` (the production path; the shard moves to
    its device) or any callable (batch, W) waveform → (batch, W // N_os)
    symbols whose receptive field is within the §6.1 overlap (true for the
    CNN equalizer by construction). x_local: (W,) float32 samples, whole
    symbols. Returns this rank's (W // N_os,) symbols: the ranks' outputs in
    rank order are apply_fn on the unsplit stream.
    """
    x = torch.as_tensor(x_local)
    if x.dim() != 1:
        raise ValueError(f"x_local must be one stream shard (W,), got "
                         f"{tuple(x.shape)}")
    return _halo_call(apply_fn, x[None, :], cfg, mesh, axis)[0]


def halo_apply_batched(apply_fn: Callable, x_local, cfg: CNNEqConfig, mesh,
                       axis: str = "data") -> torch.Tensor:
    """(B, W) variant: B streams, each sharded the same way over ``axis``;
    returns (B, W // N_os)."""
    x = torch.as_tensor(x_local)
    if x.dim() != 2:
        raise ValueError(f"x_local must be (B, W) stream shards, got "
                         f"{tuple(x.shape)}")
    return _halo_call(apply_fn, x, cfg, mesh, axis)
