"""Error-feedback gradient compression for slow interconnects.

Port of `repro.optim.grad_comp`. At multi-pod scale the cross-pod gradient
all-reduce is the slowest collective. The standard mitigation is 8-bit
compression with ERROR FEEDBACK (Seide et al. / EF-SGD): the quantization
error is carried to the next step, so the compressed-SGD fixed point
matches full-precision SGD:

    c_t   = Q(g_t + e_t)           # int8 + per-tensor scale
    e_t+1 = (g_t + e_t) − D(c_t)   # residual stays local
    step uses D(AllReduce(c_t))

`compressed_psum` runs on every rank of a process group (the pod dim of a
mesh: ``mesh.get_group("pod")``): only the int8 payloads and one f32 scale
a tensor cross the group, 4× fewer bytes than f32. Payloads are
all-gathered (a sum of int8 overflows), then decompressed and averaged on
each rank, as the reference does. CUDA tensors cross a non-NCCL group
through host memory (`launch.mesh.stages_through_host`).

`compress` equals the reference bit for bit: the scale is max|g| in f32
over qmax, floored at 1e-12; `torch.round` rounds half to even like
`jnp.round`; the clip to ±qmax comes before the cast to int8. Stochastic
rounding draws from a `torch.Generator` where the reference takes a JAX
key; the two cannot agree draw for draw.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..interop import tree_leaves, tree_unflatten
from ..launch.mesh import stages_through_host


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8
    stochastic: bool = False     # stochastic rounding of the quantizer


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def compress(g: torch.Tensor, cfg: CompressionConfig = CompressionConfig(),
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g → (int8 payload, f32 scale). Stochastic rounding needs both
    ``cfg.stochastic`` and a ``generator`` on g's device."""
    qm = _qmax(cfg.bits)
    scale = g.abs().max().float() / qm
    scale = torch.clamp_min(scale, 1e-12)
    x = g.float() / scale
    if cfg.stochastic and generator is not None:
        x = torch.floor(x + torch.rand(x.shape, generator=generator,
                                       device=x.device))
    else:
        x = torch.round(x)
    return torch.clamp(x, -qm, qm).to(torch.int8), scale


def decompress(payload: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return payload.float() * scale


def ef_compress_tree(grads: Any, error: Any,
                     cfg: CompressionConfig = CompressionConfig()):
    """Error-feedback compression over a gradient tree.

    Returns (payloads, scales, new_error): decompress(payload, scale) is
    what the collective carries; new_error stays on the rank.
    """
    ps, ss, es = [], [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(error)):
        corrected = g.float() + e
        payload, scale = compress(corrected, cfg)
        ps.append(payload)
        ss.append(scale)
        es.append(corrected - decompress(payload, scale))
    return (tree_unflatten(grads, ps), tree_unflatten(grads, ss),
            tree_unflatten(grads, es))


def init_error(params: Any) -> Any:
    return tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)])


def _all_gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in rank order, on t's device."""
    wire = t.cpu() if stages_through_host(group, t.device) else t
    out = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(out, wire.contiguous(), group)
    return torch.stack(out).to(t.device)


def compressed_psum(grads: Any, error: Any, group=None,
                    cfg: CompressionConfig = CompressionConfig()):
    """All-reduce a gradient tree with int8 payloads over ``group`` (None:
    the default group); every rank of the group calls it.

    Returns (mean_grads, new_error): the mean over the ranks of each
    decompressed, error-corrected gradient, and this rank's residual.
    """
    n = dist.get_world_size(group)
    payloads, scales, new_error = ef_compress_tree(grads, error, cfg)
    means = []
    for p, s in zip(tree_leaves(payloads), tree_leaves(scales)):
        ps = _all_gather(p, n, group)                   # (n, …) int8
        ss = _all_gather(s.reshape(1), n, group)[:, 0]  # (n,)  f32
        means.append(torch.tensordot(ss, ps.float(), dims=([0], [0])) / n)
    return tree_unflatten(grads, means), new_error
