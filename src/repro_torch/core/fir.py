"""Linear feedforward (FIR) equalizer baseline (paper §3.2), in PyTorch.

Port of `repro.core.fir`:

y_i = Σ_{m=-M*}^{M*} x_{i+m} · w(m + M*),  M* = ⌊M/2⌋,

evaluated at every N_os-th sample (one symbol estimate per symbol). Trained
with MSE + Adam exactly like the CNN (`core.train_eq`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ..device import DeviceLike, fp32_exact, resolve_device


@dataclasses.dataclass(frozen=True)
class FIRConfig:
    taps: int = 25           # M
    n_os: int = 2
    levels: int = 2

    def mac_per_symbol(self) -> float:
        # the paper counts the MACs of ONE output symbol: M
        return float(self.taps)


def init(generator: torch.Generator, cfg: FIRConfig,
         device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Centre-spike start (identity-ish, helps convergence); draws nothing,
    ``generator`` is taken for the common init signature."""
    dev = resolve_device(device)
    w = torch.zeros(cfg.taps, dtype=torch.float32, device=dev)
    w[cfg.taps // 2] = 1.0
    return {"w": w, "b": torch.zeros((), dtype=torch.float32, device=dev)}


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
          cfg: FIRConfig) -> torch.Tensor:
    """x: waveform (S·N_os,) or (batch, S·N_os) → symbol estimates (…, S)."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    k = cfg.taps
    xp = F.pad(x[:, None, :], (k // 2, k - 1 - k // 2))
    with fp32_exact():
        y = F.conv1d(xp, params["w"][None, None, :], stride=cfg.n_os)[:, 0]
    y = y + params["b"]
    return y[0] if squeeze else y
