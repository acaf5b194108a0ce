"""Time-varying channel wrappers — the in-the-field drift scenario.

Port of `repro.channels.drift`. Optical and magnetic channels DRIFT —
temperature changes the fiber's effective CD, heads age, components get
replaced — and a frozen equalizer's BER degrades until someone retrains
it. This module turns the stationary channel simulators
(`channels.proakis`, `channels.imdd`) into piecewise-stationary drifting
ones, so online adaptation has a scenario to close the loop on.

Model: a drift coordinate t ∈ [0, 1] selects the channel state.

  * `DriftingProakis` — tap rotation: the impulse response blends from
    Proakis-B toward a rotated (postcursor-heavy) tap vector, plus an SNR
    ramp.
  * `DriftingIMDD` — fiber-length ramp (the accumulated chromatic
    dispersion, i.e. the strength of the nonlinear CD × square-law ISI)
    plus an SNR ramp.
  * `DriftSchedule` — burst index → t mapping (hold, then linear ramp,
    then hold at 1): the piecewise-stationary trace `serve.loadgen`'s
    drift replay walks through.

As the stationary simulators, each is split in two: the draws (the
stationary simulator's own `_draws`, so one generator state gives the
same symbols and normals at every t and in the stationary simulator) and
the deterministic propagation with the taps, the SNR and the fiber length
as arguments (`proakis._propagate`, `imdd._propagate` with the CD
all-pass computed here). `at(t, device=…)` returns a channel function of
the port's form, ``channel_fn(generator, n_syms, batch=None)`` (as
`core.train_eq` and `data.equalizer_data.channel_fn` use), drawing on
that device; a fixed generator state gives bitwise the same frame call
to call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import imdd, proakis
from .imdd import C_LIGHT, IMDDConfig
from .proakis import PROAKIS_B, ProakisConfig

# a channel function, as consumed by core.train_eq and the loadgen:
# (generator, n_syms, batch=None) → (rx waveform at n_os samples/symbol,
# tx symbol indices)
ChannelFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DriftSchedule:
    """Burst index → drift coordinate t ∈ [0, 1].

    hold_bursts: bursts at t=0 (the stationary regime the equalizer was
                 trained for) before the ramp starts.
    ramp_bursts: bursts over which t ramps linearly 0 → 1; after the ramp
                 the channel holds at t=1 (the fully drifted state).
    """
    hold_bursts: int = 8
    ramp_bursts: int = 8

    def t_at(self, burst: int) -> float:
        if burst < self.hold_bursts:
            return 0.0
        if self.ramp_bursts <= 0:
            return 1.0
        return min(1.0, (burst - self.hold_bursts) / self.ramp_bursts)

    @property
    def total_to_settle(self) -> int:
        """First burst index at which the channel is fully drifted."""
        return self.hold_bursts + self.ramp_bursts


# ---------------------------------------------------------------------------
# Proakis-B with tap rotation + SNR ramp
# ---------------------------------------------------------------------------

def simulate_proakis_taps(generator: torch.Generator, cfg: ProakisConfig,
                          n_syms: int, h, snr_db: float,
                          batch: Optional[int] = None,
                          device: DeviceLike = "cuda"):
    """`proakis.simulate` with given channel taps ``h`` (shape (3,)) and
    SNR: the identical DSP chain (RC shaping at N_os, zero-stuffed
    symbol-rate ISI, AWGN, normalization with std + 1e-9)."""
    syms, noise = proakis._draws(generator, cfg, n_syms, batch,
                                 resolve_device(device))
    return proakis._propagate(syms, noise, cfg, h, snr_db), syms


class DriftingProakis:
    """Proakis-B magnetic-recording channel under tap rotation + SNR ramp.

    cfg:          the stationary `ProakisConfig` (t=0 state).
    taps_from:    impulse response at t=0 (default: Proakis-B). Passing
                  e.g. (1, 0, 0) with taps_to equal gives an AWGN-only
                  channel where ONLY the SNR ramp drifts.
    taps_to:      impulse response at t=1 (default: the base taps rotated
                  one position — the channel's energy migrates to the
                  postcursor). Blends linearly with the base taps and is
                  renormalized to unit energy at every t, so only the ISI
                  STRUCTURE drifts, not the signal power.
    snr_delta_db: SNR change at t=1 (default −4 dB — aging adds noise).
    """

    def __init__(self, cfg: ProakisConfig = ProakisConfig(),
                 taps_to: Tuple[float, ...] = None,
                 snr_delta_db: float = -4.0,
                 taps_from: Tuple[float, ...] = None):
        self.cfg = cfg
        h0 = (np.asarray(taps_from, np.float32) if taps_from is not None
              else np.asarray(PROAKIS_B, np.float32))
        h1 = (np.asarray(taps_to, np.float32) if taps_to is not None
              else np.roll(h0, 1))
        self._h0 = h0 / np.linalg.norm(h0)
        self._h1 = h1 / np.linalg.norm(h1)
        self.snr_delta_db = float(snr_delta_db)

    @property
    def n_os(self) -> int:
        return self.cfg.n_os

    @property
    def levels(self) -> int:
        return self.cfg.levels

    def taps_at(self, t: float) -> np.ndarray:
        h = (1.0 - t) * self._h0 + t * self._h1
        return (h / np.linalg.norm(h)).astype(np.float32)

    def snr_at(self, t: float) -> float:
        return self.cfg.snr_db + t * self.snr_delta_db

    def at(self, t: float, device: DeviceLike = "cuda") -> ChannelFn:
        """The channel function frozen at drift coordinate t, drawing on
        ``device`` (its generator must live there)."""
        t = float(min(1.0, max(0.0, t)))
        dev = resolve_device(device)
        h = torch.from_numpy(self.taps_at(t)).to(dev)
        snr = float(np.float32(self.snr_at(t)))    # the reference's float32

        def fn(generator: torch.Generator, n_syms: int,
               batch: Optional[int] = None):
            return simulate_proakis_taps(generator, self.cfg, n_syms, h, snr,
                                         batch=batch, device=dev)
        return fn


# ---------------------------------------------------------------------------
# IM/DD with fiber-length (CD) + SNR ramp
# ---------------------------------------------------------------------------

def _cd_allpass(n: int, cfg: IMDDConfig, fiber_km: float,
                device: torch.device) -> torch.Tensor:
    """exp(+j·(π λ² D L / c)·f²) with the phase in float32 from a float32
    fiber length, as the reference computes it from its traced length."""
    fs = cfg.baud_rate * cfg.sim_os
    lam = cfg.wavelength_nm * 1e-9
    d = cfg.cd_ps_nm_km * 1e-12 / 1e-9 / 1e3
    f = torch.from_numpy(np.fft.fftfreq(n, d=1.0 / fs).astype(np.float32))
    length_m = torch.tensor(fiber_km, dtype=torch.float32) * 1e3
    phase = (np.pi * lam**2 * d / C_LIGHT) * length_m * f**2
    return torch.exp(1j * phase.to(torch.complex64)).to(device)


def simulate_imdd_fiber(generator: torch.Generator, cfg: IMDDConfig,
                        n_syms: int, fiber_km: float, snr_db: float,
                        batch: Optional[int] = None,
                        device: DeviceLike = "cuda"):
    """`imdd.simulate` with a given fiber length and electrical SNR: the
    CD all-pass comes from the length (`_cd_allpass`); everything else is
    the stationary simulator's chain."""
    dev = resolve_device(device)
    draws = imdd._draws(generator, cfg, n_syms, batch, dev)
    cd = _cd_allpass(n_syms * cfg.sim_os, cfg, fiber_km, dev)
    return imdd._propagate(*draws, cfg, cd=cd, snr_db=snr_db), draws[0]


class DriftingIMDD:
    """40 GBd IM/DD optical channel under fiber-length (CD) + SNR drift.

    cfg:            the stationary `IMDDConfig` (t=0 state).
    fiber_delta_km: accumulated-dispersion change at t=1 (default +6 km of
                    effective fiber — temperature moves the CD coefficient,
                    which is equivalent to a length change).
    snr_delta_db:   electrical-SNR change at t=1 (default −3 dB).
    """

    def __init__(self, cfg: IMDDConfig = IMDDConfig(),
                 fiber_delta_km: float = 6.0,
                 snr_delta_db: float = -3.0):
        self.cfg = cfg
        self.fiber_delta_km = float(fiber_delta_km)
        self.snr_delta_db = float(snr_delta_db)

    @property
    def n_os(self) -> int:
        return self.cfg.n_os

    @property
    def levels(self) -> int:
        return self.cfg.levels

    def fiber_at(self, t: float) -> float:
        return self.cfg.fiber_km + t * self.fiber_delta_km

    def snr_at(self, t: float) -> float:
        return self.cfg.snr_db + t * self.snr_delta_db

    def at(self, t: float, device: DeviceLike = "cuda") -> ChannelFn:
        """The channel function frozen at drift coordinate t, drawing on
        ``device`` (its generator must live there)."""
        t = float(min(1.0, max(0.0, t)))
        dev = resolve_device(device)
        # float32, as the reference traces the length and the SNR
        fiber = float(np.float32(self.fiber_at(t)))
        snr = float(np.float32(self.snr_at(t)))

        def fn(generator: torch.Generator, n_syms: int,
               batch: Optional[int] = None):
            return simulate_imdd_fiber(generator, self.cfg, n_syms, fiber,
                                       snr, batch=batch, device=dev)
        return fn
