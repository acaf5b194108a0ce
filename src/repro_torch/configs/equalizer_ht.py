"""High-throughput equalizer operating point (paper §3.5 / §7.2).

The DSE-selected CNN (V_p=8, L=3, K=9, C=5) for the 40 GBd IM/DD optical
channel, deployed at N_i = 64 parallel instances (FPGA: XCVU13P @ 200 MHz;
ℓ_inst = 7320 symbols).
"""
from ..channels.imdd import IMDDConfig
from ..core.equalizer import CNNEqConfig

CNN = CNNEqConfig(layers=3, kernel=9, channels=5, v_parallel=8, n_os=2,
                  levels=2)
CHANNEL = IMDDConfig()
N_INSTANCES = 64
F_CLK = 200e6                 # FPGA clock (timing-model baseline)
T_REQ_SAMPLES = 80e9          # 40 GBd × N_os
L_INST = 7320                 # paper's selected per-instance length (symbols)
