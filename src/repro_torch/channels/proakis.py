"""Simulated magnetic-recording channel (paper §2.2): Proakis-B, in PyTorch.

Port of `repro.channels.proakis`: h_ch = [0.407, 0.815, 0.407] (severe
linear ISI, spectral null), RC pulse shaping, AWGN, N_os = 2. As for
`imdd`, `simulate` is split into the draws (symbols, the AWGN normal) and
the deterministic `_propagate`, and works on a leading batch of frames.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .common import (add_awgn, bits_to_pam, fir_same, normalize, rc_taps,
                     upsample)

PROAKIS_B = (0.407, 0.815, 0.407)


@dataclasses.dataclass(frozen=True)
class ProakisConfig:
    n_os: int = 2
    rc_beta: float = 0.3
    rc_taps: int = 65
    snr_db: float = 20.0
    levels: int = 2


def _propagate(syms: torch.Tensor, noise: torch.Tensor,
               cfg: ProakisConfig) -> torch.Tensor:
    """syms (..., n_syms) int, noise (..., n_syms·N_os) standard normal →
    rx (..., n_syms·N_os)."""
    amps = bits_to_pam(syms, cfg.levels)
    # pulse shaping at N_os
    x = fir_same(upsample(amps, cfg.n_os),
                 rc_taps(cfg.rc_taps, cfg.rc_beta, cfg.n_os))
    # the channel acts at symbol rate; at N_os it is zero-stuffed so the ISI
    # couples neighbouring symbols
    h = torch.tensor(PROAKIS_B, dtype=torch.float32, device=syms.device)
    y = fir_same(x, upsample(h, cfg.n_os)[: 2 * cfg.n_os + 1])
    return normalize(add_awgn(y, noise, cfg.snr_db))


def simulate(generator: torch.Generator, cfg: ProakisConfig, n_syms: int,
             batch: Optional[int] = None, device: DeviceLike = "cuda"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (rx[(batch,) n_syms·n_os], syms[(batch,) n_syms]) like
    `imdd.simulate`; ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    lead = () if batch is None else (batch,)
    syms = torch.randint(0, cfg.levels, (*lead, n_syms), generator=generator,
                         device=dev)
    noise = torch.randn((*lead, n_syms * cfg.n_os), generator=generator,
                        device=dev)
    return _propagate(syms, noise, cfg), syms
