"""Frozen channel simulators that make the benchmark's waveforms.

A copy, kept with the benchmark, of the two links of the paper (§2.1 and
§2.2), so that a change to the program cannot move the inputs the
benchmark feeds it. Every function works on a leading batch of frames
(rows) on the generator's device and draws only from the generator it is
given, so a seed gives the same waveform on every run.

  * IM/DD: 40 GBd PAM-2, RRC pulse shaping at the simulation oversampling,
    a Mach-Zehnder modulator at quadrature, chromatic dispersion of the
    fiber on the optical field (FFT), ASE before the square-law
    photodetector, the photodetector's low-pass, receiver AWGN, then
    decimation to N_os samples a symbol.
  * Proakis-B: h = [0.407, 0.815, 0.407] at symbol rate (a spectral null),
    raised-cosine pulse shaping at N_os, AWGN.

Each frame comes out at zero mean and unit variance.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

C_LIGHT = 299_792_458.0
PROAKIS_B = (0.407, 0.815, 0.407)


def _rrc_taps(n_taps: int, beta: float, sps: int) -> np.ndarray:
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
            taps[i] = num / (np.pi * ti * (1 - (4 * beta * ti) ** 2))
    return (taps / np.sqrt(np.sum(taps ** 2))).astype(np.float32)


def _rc_taps(n_taps: int, beta: float, sps: int) -> np.ndarray:
    t = (np.arange(n_taps) - (n_taps - 1) / 2) / sps
    den = 1.0 - (2.0 * beta * t) ** 2
    sing = np.abs(den) < 1e-8
    taps = np.where(sing, (np.pi / 4) * np.sinc(1 / (2 * beta)),
                    np.sinc(t) * np.cos(np.pi * beta * t)
                    / np.where(sing, 1.0, den))
    return (taps / np.max(np.abs(taps))).astype(np.float32)


def _upsample(x: torch.Tensor, sps: int) -> torch.Tensor:
    out = x.new_zeros((*x.shape[:-1], x.shape[-1] * sps))
    out[..., ::sps] = x
    return out


def _fir_same(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """'same'-mode true convolution along the last dim, fp32 without TF32."""
    k = len(taps)
    w = torch.from_numpy(np.ascontiguousarray(taps[::-1])).to(x.device)
    rows = x.reshape(-1, 1, x.shape[-1])
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=False, deterministic=True,
                                    allow_tf32=False):
        y = F.conv1d(F.pad(rows, (k // 2, k - 1 - k // 2)), w.view(1, 1, k))
    return y.reshape(x.shape)


def _pam(syms: torch.Tensor, levels: int) -> torch.Tensor:
    pts = 2.0 * torch.arange(levels, dtype=torch.float32,
                             device=syms.device) - (levels - 1)
    return (pts / torch.sqrt(torch.mean(pts ** 2)))[syms]


def _awgn(x: torch.Tensor, noise: torch.Tensor, snr_db: float):
    p_sig = torch.mean(x ** 2, dim=-1, keepdim=True)
    return x + (p_sig / 10.0 ** (snr_db / 10.0)) ** 0.5 * noise


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    std = torch.std(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) / (std + 1e-9)


def imdd(gen: torch.Generator, ch: dict, frames: int,
         n_syms: int) -> torch.Tensor:
    """(frames, n_syms·N_os) received IM/DD waveforms."""
    dev = gen.device
    sim_os, n_os = int(ch["sim_os"]), int(ch["n_os"])
    n = n_syms * sim_os
    fs = ch["baud_rate"] * sim_os
    syms = torch.randint(0, int(ch["levels"]), (frames, n_syms),
                         generator=gen, device=dev)
    ase_re, ase_im, noise = (torch.randn((frames, n), generator=gen,
                                         device=dev) for _ in range(3))
    f = np.fft.fftfreq(n, d=1.0 / fs)
    lam = ch["wavelength_nm"] * 1e-9
    disp = ch["cd_ps_nm_km"] * 1e-12 / 1e-9 / 1e3
    phase = (np.pi * lam ** 2 * disp * ch["fiber_km"] * 1e3 / C_LIGHT
             * f ** 2).astype(np.float32)
    cd = torch.exp(1j * torch.from_numpy(phase).to(dev, torch.complex64))
    lpf = torch.from_numpy((1.0 / np.sqrt(1.0 + (f / ch["pd_bw_hz"]) ** 8))
                           .astype(np.float32)).to(dev)
    x = _fir_same(_upsample(_pam(syms, int(ch["levels"])), sim_os),
                  _rrc_taps(int(ch["rrc_taps"]), ch["rrc_beta"], sim_os)) \
        * float(np.sqrt(sim_os))
    field = torch.cos(np.pi / 4.0
                      - ch["mzm_vpi_frac"] * (np.pi / 2.0) * x / 2.0)
    field = torch.fft.ifft(torch.fft.fft(field.to(torch.complex64)) * cd)
    p_ase = (torch.mean(torch.abs(field) ** 2, dim=-1, keepdim=True)
             / 10.0 ** (ch["osnr_db"] / 10.0))
    field = field + torch.complex(torch.sqrt(p_ase / 2) * ase_re,
                                  torch.sqrt(p_ase / 2) * ase_im)
    current = torch.real(torch.fft.ifft(
        torch.fft.fft((torch.abs(field) ** 2).to(torch.complex64)) * lpf))
    current = _awgn(current.float(), noise, ch["snr_db"])
    return _normalize(current[..., ::sim_os // n_os]).contiguous()


def proakis(gen: torch.Generator, ch: dict, frames: int,
            n_syms: int) -> torch.Tensor:
    """(frames, n_syms·N_os) Proakis-B read-back waveforms."""
    dev = gen.device
    n_os = int(ch["n_os"])
    syms = torch.randint(0, int(ch["levels"]), (frames, n_syms),
                         generator=gen, device=dev)
    noise = torch.randn((frames, n_syms * n_os), generator=gen, device=dev)
    x = _fir_same(_upsample(_pam(syms, int(ch["levels"])), n_os),
                  _rc_taps(int(ch["rc_taps"]), ch["rc_beta"], n_os))
    h = _upsample(torch.tensor(PROAKIS_B), n_os)[:2 * n_os + 1].numpy()
    y = _fir_same(x, h)
    return _normalize(_awgn(y, noise, ch["snr_db"])).contiguous()


SIMULATORS = {"imdd": imdd, "proakis": proakis}


def waveforms(gen: torch.Generator, ch: dict, frames: int, n_syms: int,
              group: int = 64) -> torch.Tensor:
    """``frames`` frames of ``n_syms`` symbols of the channel ``ch["kind"]``,
    simulated ``group`` frames at a time so that the FFTs' temporaries stay
    small."""
    sim = SIMULATORS[ch["kind"]]
    return torch.cat([sim(gen, ch, min(group, frames - f0), n_syms)
                      for f0 in range(0, frames, group)])
