"""Shared DSP building blocks for the simulated channels, in PyTorch.

Port of `repro.channels.common`. Everything works on the last dimension of
its input, so a whole batch of frames (rows) goes through in one call on
the card. The random parts take their normal draws as arguments
(`add_awgn`) or from an explicit `torch.Generator` (`awgn`), which lets a
test feed both packages the same noise.

`fir_same` is a true convolution, as `jnp.convolve` is: `F.conv1d` is a
cross-correlation, so the taps are flipped first.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, fp32_exact, resolve_device

# ---------------------------------------------------------------------------
# Symbol mapping
# ---------------------------------------------------------------------------


def pam_constellation(levels: int,
                      device: DeviceLike = "cuda") -> torch.Tensor:
    """Gray-free PAM-`levels` constellation, unit average power."""
    pts = torch.arange(levels, dtype=torch.float32,
                       device=resolve_device(device))
    pts = 2.0 * pts - (levels - 1)
    return pts / torch.sqrt(torch.mean(pts ** 2))


def bits_to_pam(bits: torch.Tensor, levels: int = 2) -> torch.Tensor:
    """Map integer symbols in [0, levels) to PAM amplitudes."""
    return pam_constellation(levels, bits.device)[bits]


def pam_decision(y: torch.Tensor, levels: int = 2) -> torch.Tensor:
    """Hard decision: nearest constellation point, returns symbol indices."""
    const = pam_constellation(levels, y.device)
    return torch.argmin(torch.abs(y[..., None] - const), dim=-1)


# ---------------------------------------------------------------------------
# Pulse shaping (numpy taps, built once per configuration)
# ---------------------------------------------------------------------------

def rrc_taps(n_taps: int, beta: float, sps: int) -> np.ndarray:
    """Root-raised-cosine filter taps."""
    assert n_taps % 2 == 1, "use an odd number of taps"
    t = (np.arange(n_taps) - (n_taps - 1) / 2) / sps
    taps = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            taps[i] = 1.0 - beta + 4 * beta / np.pi
        elif beta > 0 and abs(abs(ti) - 1 / (4 * beta)) < 1e-9:
            taps[i] = (beta / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = (np.sin(np.pi * ti * (1 - beta))
                   + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta)))
            den = np.pi * ti * (1 - (4 * beta * ti) ** 2)
            taps[i] = num / den
    taps = taps / np.sqrt(np.sum(taps**2))
    return taps.astype(np.float32)


def rc_taps(n_taps: int, beta: float, sps: int) -> np.ndarray:
    """Raised-cosine filter taps."""
    assert n_taps % 2 == 1
    t = (np.arange(n_taps) - (n_taps - 1) / 2) / sps
    taps = np.sinc(t) * np.cos(np.pi * beta * t)
    den = 1.0 - (2.0 * beta * t) ** 2
    # limit at the singular points
    sing = np.abs(den) < 1e-8
    taps = np.where(sing, (np.pi / 4) * np.sinc(1 / (2 * beta)),
                    taps / np.where(sing, 1.0, den))
    taps = taps / np.max(np.abs(taps))
    return taps.astype(np.float32)


def upsample(x: torch.Tensor, sps: int) -> torch.Tensor:
    """Insert sps-1 zeros between samples (expander), on the last dim."""
    out = x.new_zeros((*x.shape[:-1], x.shape[-1] * sps))
    out[..., ::sps] = x
    return out


def fir_same(x: torch.Tensor, taps) -> torch.Tensor:
    """'same'-mode FIR filtering (a true convolution) along the last dim."""
    taps = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    k = taps.shape[0]
    pad = k // 2
    rows = x.reshape(-1, 1, x.shape[-1])
    w = torch.flip(taps, (0,)).reshape(1, 1, k)
    with fp32_exact():
        y = F.conv1d(F.pad(rows, (pad, k - 1 - pad)), w)
    return y.reshape(x.shape)


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------

def add_awgn(x: torch.Tensor, noise: torch.Tensor, snr_db: float,
             signal_power: Optional[float] = None) -> torch.Tensor:
    """x plus standard-normal ``noise`` scaled to the SNR of each row."""
    p_sig = (torch.mean(x ** 2, dim=-1, keepdim=True)
             if signal_power is None else signal_power)
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return x + (p_noise ** 0.5) * noise


def awgn(generator: torch.Generator, x: torch.Tensor, snr_db: float,
         signal_power: Optional[float] = None) -> torch.Tensor:
    """Add white Gaussian noise at the given SNR (per-sample, real signal),
    drawn from ``generator`` on x's device."""
    noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=x.device)
    return add_awgn(x, noise, snr_db, signal_power)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit (population) variance per row."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    std = torch.std(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) / (std + 1e-9)


# ---------------------------------------------------------------------------
# BER
# ---------------------------------------------------------------------------

def ber(pred_syms: torch.Tensor, true_syms: torch.Tensor,
        bits_per_sym: int = 1) -> torch.Tensor:
    """Symbol-error-based BER (PAM2 ⇒ symbol errors == bit errors)."""
    errs = torch.sum(pred_syms != true_syms)
    return errs / (pred_syms.numel() * bits_per_sym)


def ber_from_soft(y: torch.Tensor, true_syms: torch.Tensor,
                  levels: int = 2) -> torch.Tensor:
    return ber(pam_decision(y, levels), true_syms)
