"""Timing model of the parallel equalizer (paper §6.1).

Port of `repro.core.timing_model`: pure Python arithmetic, the same
equations and constants, so every output equals the reference's.

FPGA form (verbatim from the paper):

    t_init  = log2(N_i) · ℓ_ol / (2 · V_p · f_clk)          (pipeline fill)
    λ_sym  ≈ t_init                                          (symbol latency)
    t_p     = ℓ_in / (N_i·V_p·f_clk) · (1 + 2·o_act/ℓ_inst)  (processing time)
    T_net   = N_i·V_p·f_clk / (1 + 2·o_act/ℓ_inst)           (net throughput)
    T_max   = N_i·V_p·f_clk                                  (ceiling)

`tpu_profile` is the reference's accelerator form, kept as it is: an
"instance" is a chip; `f_clk·V_p` (symbols/s/instance) becomes a
roofline-limited symbol rate, and the SSM/MSM split tree becomes halo
exchange whose fill time is the transfer of 2·o_act boundary symbols plus
per-hop latency. Its constants are the reference's model parameters for a
TPU v5e, not measurements, and describe no device this package runs on.
"""
from __future__ import annotations

import dataclasses
import math

from .equalizer import CNNEqConfig
from .stream_partition import actual_overlap


@dataclasses.dataclass(frozen=True)
class HWProfile:
    """Hardware constants for the timing model."""
    name: str
    sym_rate_per_inst: float     # symbols/s produced by one instance (V_p·f_clk)
    link_bw: float               # bytes/s for split/merge or halo traffic
    hop_latency: float           # seconds per tree level / ICI hop
    bytes_per_sym: float = 2.0   # bf16 waveform samples (N_os=2 × 1 B eq.)


def fpga_profile(cfg: CNNEqConfig, f_clk: float = 200e6) -> HWProfile:
    return HWProfile(name="fpga-xcvu13p",
                     sym_rate_per_inst=cfg.v_parallel * f_clk,
                     link_bw=float("inf"), hop_latency=0.0)


def tpu_profile(cfg: CNNEqConfig, peak_flops: float = 197e12,
                mxu_util: float = 0.4, ici_bw: float = 50e9,
                ici_hop_latency: float = 1e-6) -> HWProfile:
    """Roofline-limited symbol rate of the fused CNN equalizer on one TPU
    v5e chip — the reference's model parameters (peak, utilization,
    interconnect), not a measurement."""
    macs_per_sym = cfg.mac_per_symbol()
    sym_rate = mxu_util * peak_flops / (2.0 * macs_per_sym)
    return HWProfile(name="tpu-v5e", sym_rate_per_inst=sym_rate,
                     link_bw=ici_bw, hop_latency=ici_hop_latency)


# ---------------------------------------------------------------------------
# Paper equations
# ---------------------------------------------------------------------------

def t_init(cfg: CNNEqConfig, hw: HWProfile, n_inst: int, l_inst: int) -> float:
    """Time until the last instance starts processing (pipeline fill)."""
    o_act = actual_overlap(cfg, n_inst)
    l_ol = l_inst + 2 * o_act
    if n_inst == 1:
        fill = 0.0
    else:
        fill = math.log2(n_inst) * l_ol / (2.0 * hw.sym_rate_per_inst)
    # accelerator extension: halo bytes over the interconnect + per-hop
    # latency (0 for the FPGA profile)
    halo = 2 * o_act * hw.bytes_per_sym / hw.link_bw if math.isfinite(hw.link_bw) else 0.0
    hops = math.log2(n_inst) * hw.hop_latency if n_inst > 1 else 0.0
    return fill + halo + hops


def symbol_latency(cfg: CNNEqConfig, hw: HWProfile, n_inst: int,
                   l_inst: int) -> float:
    """λ_sym ≈ t_init (paper eq. 3)."""
    return t_init(cfg, hw, n_inst, l_inst)


def processing_time(cfg: CNNEqConfig, hw: HWProfile, n_inst: int,
                    l_inst: int, l_in: int) -> float:
    o_act = actual_overlap(cfg, n_inst)
    return l_in / (n_inst * hw.sym_rate_per_inst) * (1 + 2 * o_act / l_inst)


def net_throughput(cfg: CNNEqConfig, hw: HWProfile, n_inst: int,
                   l_inst: int) -> float:
    """T_net in symbols/s (paper eq. 4)."""
    o_act = actual_overlap(cfg, n_inst)
    return n_inst * hw.sym_rate_per_inst / (1 + 2 * o_act / l_inst)


def max_throughput(hw: HWProfile, n_inst: int) -> float:
    """T_max = N_i · V_p · f_clk (ceiling as ℓ_inst → ∞)."""
    return n_inst * hw.sym_rate_per_inst


def min_instances(hw: HWProfile, t_req: float) -> int:
    """Smallest N_i whose T_max exceeds the required throughput."""
    return max(1, math.ceil(t_req / hw.sym_rate_per_inst))
