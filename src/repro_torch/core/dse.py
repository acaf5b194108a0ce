"""Design-space exploration framework (paper §3.4–3.5, Fig. 2).

Port of `repro.core.dse`. Sweeps equalizer configurations, trains each
`n_seeds` times, keeps the WORST BER of the seeds (the paper's
conservative choice), pairs it with MAC/symbol, and extracts the Pareto
frontier. A hardware-aware complexity ceiling prunes infeasible models
*before* implementation — the cross-layer trick:

  FPGA (paper):       MAC_sym,max = DSP_avail / T_req · f_clk · 1.2
  accelerator model:  MAC_sym,max = chips · peak_FLOPs · util / (2 · T_req)

The grids, the ceilings, `pareto_front` and `select_operating_point` are
analytic and give the reference's values. `explore` trains through the
port's `train_equalizer`, each (entry, seed) from its own generator
derived from the caller's, so its BERs are the port's own draws.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from .equalizer import CNNEqConfig
from .fir import FIRConfig
from .train_eq import EqTrainConfig, train_equalizer
from .volterra import VolterraConfig


@dataclasses.dataclass
class DSEEntry:
    kind: str
    cfg: object
    mac_per_sym: float
    ber: float
    feasible: bool


def mac_sym_max_fpga(dsp_avail: int = 12_288, t_req: float = 40e9,
                     f_clk: float = 200e6, lut_bonus: float = 1.2) -> float:
    """The paper's ceiling for the XCVU13P (12 288 DSPs, 200 MHz, 40 GBd)."""
    return dsp_avail / t_req * f_clk * lut_bonus


def mac_sym_max_tpu(chips: int = 1, peak_flops: float = 197e12,
                    util: float = 0.4, t_req: float = 40e9) -> float:
    """Roofline analogue: MACs/sym the chip budget supports at T_req.

    The default ``peak_flops`` of 197e12 is the reference's model constant
    (a TPU's bf16 peak), kept so the ceiling equals the reference's; it is
    not a measurement of any card this package runs on."""
    return chips * peak_flops * util / (2.0 * t_req)


def cnn_grid(v_parallel=(1, 2, 4, 8, 16), layers=(3, 4, 5),
             kernel=(9, 15, 21), channels=(3, 4, 5), n_os=2):
    """The paper's 135-model CNN grid."""
    for vp, l, k, c in itertools.product(v_parallel, layers, kernel, channels):
        yield CNNEqConfig(layers=l, kernel=k, channels=c, v_parallel=vp,
                          n_os=n_os)


def fir_grid(taps=(3, 5, 9, 17, 25, 41, 57, 89, 121, 185, 249, 377, 505,
                   761, 1017), n_os=2):
    for m in taps:
        yield FIRConfig(taps=m, n_os=n_os)


def volterra_grid(m1=(3, 9, 15, 25, 35, 55, 75, 89, 121),
                  m2=(1, 3, 9, 15, 25, 30, 35), m3=(1, 3, 9, 15), n_os=2):
    # the paper sweeps each order; the orders are paired diagonally to keep
    # the sweep affordable, covering the same complexity range
    for a, b, c in itertools.product(m1, m2, m3):
        yield VolterraConfig(m1=a, m2=b, m3=c, n_os=n_os)


def _entry_generator(seed: int, i: int, s: int) -> torch.Generator:
    """Seed s of entry i (the reference's fold_in index i·97 + s)."""
    state = np.random.SeedSequence([seed, i * 97 + s]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def explore(generator: torch.Generator,
            entries: Sequence[Tuple[str, object]], channel_fn: Callable,
            train_cfg: EqTrainConfig, mac_ceiling: float, n_seeds: int = 3,
            device: DeviceLike = "cuda") -> List[DSEEntry]:
    """Train every (kind, cfg); keep the worst seed BER (paper §3.4).

    ``channel_fn`` must draw on ``device``; each (entry, seed) trains from
    a generator derived from one draw of ``generator``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    results: List[DSEEntry] = []
    for i, (kind, cfg) in enumerate(entries):
        macs = cfg.mac_per_symbol()
        bers = []
        for s in range(n_seeds):
            _, _, info = train_equalizer(_entry_generator(seed, i, s), kind,
                                         cfg, channel_fn, train_cfg,
                                         device=device)
            bers.append(info["ber"])
        results.append(DSEEntry(kind=kind, cfg=cfg, mac_per_sym=macs,
                                ber=max(bers), feasible=macs <= mac_ceiling))
    return results


def pareto_front(entries: Sequence[DSEEntry]) -> List[DSEEntry]:
    """Non-dominated set under (mac_per_sym ↓, ber ↓)."""
    srt = sorted(entries, key=lambda e: (e.mac_per_sym, e.ber))
    front, best = [], float("inf")
    for e in srt:
        if e.ber < best:
            front.append(e)
            best = e.ber
    return front


def select_operating_point(entries: Sequence[DSEEntry]) -> DSEEntry:
    """Paper §3.5: lowest BER among models meeting the throughput ceiling."""
    feas = [e for e in entries if e.feasible]
    if not feas:
        raise ValueError("no feasible model under the MAC ceiling")
    return min(feas, key=lambda e: e.ber)
