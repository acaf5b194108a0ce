"""Minimal AdamW on plain tensor trees (port of `repro.optim.adam`).

Written as functions on trees (dicts, lists, tuples and NamedTuples of
tensors), not as a `torch.optim.Optimizer`: the state is a tree shaped like
the parameters, and the update is the reference's arithmetic,

    mhat = m / (1 − b1^t),  vhat = v / (1 − b2^t)
    p ← p − lr · mhat / (sqrt(vhat) + eps)

with b^t in float32. `torch.optim.Adam` puts eps after its bias correction
(sqrt(v)/sqrt(1 − b2^t) + eps), which is a different update.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from ..interop import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor     # scalar int32, on the parameters' device
    mu: Any                # first moment, like params
    nu: Any                # second moment, like params


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    # dtype for the moments; f32 master moments are standard
    state_dtype: torch.dtype = torch.float32

    def init(self, params: Any) -> AdamState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None

        def zeros(p):
            return torch.zeros(p.shape, dtype=self.state_dtype,
                               device=p.device)
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads: Any, state: AdamState, params: Any):
        """Returns (new_params, new_state). Pure: nothing is updated in
        place."""
        step = state.step + 1
        if self.grad_clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)

        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.to(v.dtype)), state.nu, grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self._lr(step)

        def upd(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(delta.dtype)
            return (p.float() - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamState(step=step, mu=mu, nu=nu)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))
