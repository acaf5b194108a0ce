"""Low-power equalizer operating point (paper §5.2 / Fig. 8).

Same CNN topology on the Proakis-B magnetic-recording channel, low-cost
target (FPGA: XC7S25).
"""
from ..channels.proakis import ProakisConfig
from ..core.equalizer import CNNEqConfig

CNN = CNNEqConfig(layers=3, kernel=9, channels=5, v_parallel=8, n_os=2,
                  levels=2)
CHANNEL = ProakisConfig(snr_db=20.0)
N_INSTANCES = 1
DOPS = (1, 5, 10, 25, 225)    # paper's feasible DOP set for K=9, C=5
F_CLK = 100e6
