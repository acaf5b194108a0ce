"""Volterra-series equalizer baseline up to order 3 (paper §3.3), in PyTorch.

Port of `repro.core.volterra`:

y_i = w0 + Σ x_{i+m1} w1(m1)
        + Σ Σ x_{i+m1} x_{i+m2} w2(m1, m2)
        + Σ Σ Σ x_{i+m1} x_{i+m2} x_{i+m3} w3(m1, m2, m3)

Memory lengths (M1, M2, M3) per order, each order padded on its own
(m//2 left, m−1−m//2 right). Windowed gathers and einsums, which autograd
differentiates; this is the training-time forward. The deployed kernel
(`kernels.volterra`) pads once by the common halo max(m//2) instead; both
pad with zeros, so every window holds the same samples and the two differ
by rounding only, edges included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ..device import DeviceLike, fp32_exact, resolve_device


@dataclasses.dataclass(frozen=True)
class VolterraConfig:
    m1: int = 25
    m2: int = 9
    m3: int = 0              # 0 disables the 3rd-order kernel
    n_os: int = 2
    levels: int = 2

    def mac_per_symbol(self) -> float:
        macs = float(self.m1)
        if self.m2 > 0:
            macs += float(self.m2) ** 2
        if self.m3 > 0:
            macs += float(self.m3) ** 3
        return macs


def init(generator: torch.Generator, cfg: VolterraConfig,
         device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Centre-spike linear kernel, small random higher orders. Draws on the
    CPU from ``generator`` (a seed gives the same weights on any device)."""
    dev = resolve_device(device)
    w1 = torch.zeros(cfg.m1, dtype=torch.float32)
    w1[cfg.m1 // 2] = 1.0
    params = {"w0": torch.zeros((), dtype=torch.float32), "w1": w1}
    if cfg.m2 > 0:
        params["w2"] = 0.01 * torch.randn((cfg.m2, cfg.m2),
                                          generator=generator)
    if cfg.m3 > 0:
        params["w3"] = 0.001 * torch.randn((cfg.m3, cfg.m3, cfg.m3),
                                           generator=generator)
    return {k: v.to(dev) for k, v in params.items()}


def _windows(x: torch.Tensor, m: int, stride: int) -> torch.Tensor:
    """(batch, W) → (batch, W//stride, m) sliding windows centred per output."""
    xp = F.pad(x, (m // 2, m - 1 - m // 2))
    return xp.unfold(1, m, stride)[:, :x.shape[1] // stride]


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
          cfg: VolterraConfig) -> torch.Tensor:
    """x: (S·N_os,) or (batch, S·N_os) → (…, S) symbol estimates."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    y = params["w0"].expand(x.shape[0], x.shape[1] // cfg.n_os)
    with fp32_exact():
        win1 = _windows(x, cfg.m1, cfg.n_os)
        y = y + torch.einsum("bnm,m->bn", win1, params["w1"])
        if cfg.m2 > 0 and "w2" in params:
            win2 = _windows(x, cfg.m2, cfg.n_os)
            y = y + torch.einsum("bni,bnj,ij->bn", win2, win2, params["w2"])
        if cfg.m3 > 0 and "w3" in params:
            win3 = _windows(x, cfg.m3, cfg.n_os)
            y = y + torch.einsum("bni,bnj,bnk,ijk->bn", win3, win3, win3,
                                 params["w3"])
    return y[0] if squeeze else y
