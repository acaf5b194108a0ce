"""Simulated 40 GBd IM/DD optical fiber channel (paper §2.1), in PyTorch.

Port of `repro.channels.imdd`, with the same link:

    * 40 GBd PAM-2 (OOK), RRC pulse shaping, N_os = 2 samples/symbol
    * MZM biased at quadrature → field amplitude modulation
    * 31.5 km SSMF, CD 16 ps/(nm km) @ 1550 nm, applied by FFT on the field
    * ASE (complex AWGN) on the field before the square-law photodetector:
      signal × ASE beat noise after |·|² is signal-dependent
    * 40 GHz photodetector low-pass, receiver AWGN, decimation to N_os,
      zero mean / unit variance

`simulate` is split in two: the draws (symbols, the two ASE normals, the
receiver AWGN normal) and the deterministic `_propagate`, so a test can
feed the port the arrays that JAX drew. Every function works on a leading
batch of frames; complex64 throughout, as the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, fp32_exact, resolve_device
from .common import (add_awgn, bits_to_pam, fir_same, normalize, rrc_taps,
                     upsample)

C_LIGHT = 299_792_458.0  # m/s


@dataclasses.dataclass(frozen=True)
class IMDDConfig:
    baud_rate: float = 40e9          # 40 GBd
    n_os: int = 2                    # oversampling at the equalizer input
    sim_os: int = 4                  # internal simulation oversampling
    fiber_km: float = 31.5
    cd_ps_nm_km: float = 16.0
    wavelength_nm: float = 1550.0
    rrc_beta: float = 0.2
    rrc_taps: int = 129
    snr_db: float = 20.0             # electrical (post-PD) SNR
    osnr_db: float = 28.0            # optical SNR (ASE before the PD)
    mzm_vpi_frac: float = 1.0        # drive swing as fraction of Vpi (OOK)
    pd_bw_hz: float = 40e9           # photodetector bandwidth (paper: 40 GHz)
    levels: int = 2                  # PAM2


def _cd_phase(n_fft: int, fs: float, cfg: IMDDConfig) -> np.ndarray:
    """Frequency-domain chromatic-dispersion all-pass phase response."""
    lam = cfg.wavelength_nm * 1e-9
    d = cfg.cd_ps_nm_km * 1e-12 / 1e-9 / 1e3          # s/m/m
    length = cfg.fiber_km * 1e3
    f = np.fft.fftfreq(n_fft, d=1.0 / fs)
    phase = np.pi * lam**2 * d * length / C_LIGHT * f**2
    return phase.astype(np.float64)


@functools.lru_cache(maxsize=16)
def _responses(n: int, cfg: IMDDConfig, device: torch.device):
    """(RRC taps, CD all-pass, PD low-pass) for n samples, on ``device``.

    The CD phase is rounded to float32 first and exponentiated in complex64,
    as the reference's `jnp.exp(1j * phase)` does.
    """
    fs = cfg.baud_rate * cfg.sim_os
    taps = torch.from_numpy(rrc_taps(cfg.rrc_taps, cfg.rrc_beta, cfg.sim_os))
    phase = torch.from_numpy(_cd_phase(n, fs, cfg).astype(np.float32))
    cd = torch.exp(1j * phase.to(torch.complex64))
    f = np.fft.fftfreq(n, d=1.0 / fs)
    pd_lpf = torch.from_numpy(
        (1.0 / np.sqrt(1.0 + (f / cfg.pd_bw_hz) ** 8)).astype(np.float32))
    return taps.to(device), cd.to(device), pd_lpf.to(device)


def _propagate(syms: torch.Tensor, ase_re: torch.Tensor,
               ase_im: torch.Tensor, noise: torch.Tensor,
               cfg: IMDDConfig) -> torch.Tensor:
    """The link on given draws: syms (..., n_syms) int; ase_re, ase_im and
    noise (..., n_syms·sim_os) standard normals → rx (..., n_syms·N_os)."""
    taps, cd, pd_lpf = _responses(syms.shape[-1] * cfg.sim_os, cfg,
                                  syms.device)
    with fp32_exact():
        # transmitter: upsample + RRC shape at the simulation oversampling
        amps = bits_to_pam(syms, cfg.levels)
        x = fir_same(upsample(amps, cfg.sim_os), taps) \
            * float(np.sqrt(cfg.sim_os))

        # MZM at quadrature: field E ∝ cos(π/4 + drive)
        drive = cfg.mzm_vpi_frac * (np.pi / 2.0) * x
        field = torch.cos(np.pi / 4.0 - drive / 2.0)

        # fiber: chromatic dispersion on the optical field
        field_out = torch.fft.ifft(torch.fft.fft(field.to(torch.complex64))
                                   * cd)

        # amplifier ASE: complex AWGN on the field (pre-detection)
        p_sig = torch.mean(torch.abs(field_out) ** 2, dim=-1, keepdim=True)
        p_ase = p_sig / (10.0 ** (cfg.osnr_db / 10.0))
        ase = torch.complex(torch.sqrt(p_ase / 2.0) * ase_re,
                            torch.sqrt(p_ase / 2.0) * ase_im)
        field_out = field_out + ase

        # receiver: square-law photodetector, its 40 GHz low-pass, AWGN
        current = torch.abs(field_out) ** 2
        current = torch.real(torch.fft.ifft(
            torch.fft.fft(current.to(torch.complex64)) * pd_lpf))
        current = add_awgn(current.float(), noise, cfg.snr_db)

    # resample to N_os samples/symbol + normalize
    return normalize(current[..., ::cfg.sim_os // cfg.n_os])


def _draws(generator: torch.Generator, cfg: IMDDConfig, n_syms: int,
           batch: Optional[int], device: torch.device):
    """(syms, ase_re, ase_im, noise) from ``generator`` on ``device``."""
    lead = () if batch is None else (batch,)
    n_sim = n_syms * cfg.sim_os
    syms = torch.randint(0, cfg.levels, (*lead, n_syms), generator=generator,
                         device=device)
    normal = [torch.randn((*lead, n_sim), generator=generator, device=device)
              for _ in range(3)]
    return (syms, *normal)


def simulate(generator: torch.Generator, cfg: IMDDConfig, n_syms: int,
             batch: Optional[int] = None, device: DeviceLike = "cuda"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulate one frame, or ``batch`` frames in one call.

    Returns:
      rx:   received electrical waveform at N_os samples/symbol, length
            n_syms · n_os (with a leading batch dim when ``batch`` is set),
            normalized to zero mean / unit variance per frame.
      syms: transmitted symbol indices, aligned with rx.
    ``generator`` must live on ``device``.
    """
    dev = resolve_device(device)
    syms, ase_re, ase_im, noise = _draws(generator, cfg, n_syms, batch, dev)
    return _propagate(syms, ase_re, ase_im, noise, cfg), syms
