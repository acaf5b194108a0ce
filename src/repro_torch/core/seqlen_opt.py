"""Sequence-length optimization framework (paper §6.2, Fig. 11).

Port of `repro.core.seqlen_opt` (pure Python, equal outputs).

Given a hard throughput requirement T_req and latency as the minimization
objective, pick the minimal ℓ_inst with T_net(ℓ_inst) ≥ T_req:

    T_net = T_max / (1 + 2·o_act/ℓ_inst) ≥ T_req
    ⇒ ℓ_inst ≥ 2·o_act / (T_max/T_req − 1)

ℓ_inst must additionally be a positive multiple of the stream granularity
(V_p·N_i symbols, even in N_os units). The FPGA holds the (T_req → ℓ_inst)
mapping in an on-chip LUT so it can adapt per sequence at runtime; here the
LUT is generated by `build_lut` and consumed by the serving path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

from .equalizer import CNNEqConfig
from .stream_partition import actual_overlap
from .timing_model import HWProfile, max_throughput, net_throughput, symbol_latency


@dataclasses.dataclass(frozen=True)
class LInstChoice:
    t_req: float
    l_inst: int
    t_net: float
    latency_s: float


def granularity(cfg: CNNEqConfig, n_inst: int) -> int:
    """ℓ_inst must be a multiple of V_p (one network pass) and N_os.

    (The paper's chosen ℓ_inst = 7320 = 915·8 confirms the granularity is
    V_p, not V_p·N_i — only o_act carries the V_p·N_i·nextEven constraint.)
    """
    g = math.lcm(cfg.v_parallel, 2)
    del n_inst
    return g


def optimal_l_inst(cfg: CNNEqConfig, hw: HWProfile, n_inst: int,
                   t_req: float) -> int:
    """Minimal feasible ℓ_inst for throughput t_req (symbols/s)."""
    t_max = max_throughput(hw, n_inst)
    if t_req >= t_max:
        raise ValueError(
            f"T_req={t_req:.3g} ≥ T_max={t_max:.3g}: no ℓ_inst can satisfy it;"
            " increase N_i (paper: ≥64 instances for 80 GSa/s).")
    o_act = actual_overlap(cfg, n_inst)
    l_min = 2.0 * o_act / (t_max / t_req - 1.0)
    g = granularity(cfg, n_inst)
    return max(g, int(math.ceil(l_min / g)) * g)


def build_lut(cfg: CNNEqConfig, hw: HWProfile, n_inst: int,
              t_reqs: Sequence[float]) -> Dict[float, LInstChoice]:
    """The LUT-generator of Fig. 11: T_req → ℓ_inst (+ predicted metrics)."""
    lut: Dict[float, LInstChoice] = {}
    for t_req in t_reqs:
        l_inst = optimal_l_inst(cfg, hw, n_inst, t_req)
        lut[t_req] = LInstChoice(
            t_req=t_req, l_inst=l_inst,
            t_net=net_throughput(cfg, hw, n_inst, l_inst),
            latency_s=symbol_latency(cfg, hw, n_inst, l_inst))
    return lut
