from .ref import slstm as slstm_ref
from .slstm import (INSTANCE_LAUNCHES, LAUNCHES, build, build_bwd,
                    reset_launch_counts, slstm_bwd_costs, slstm_costs,
                    slstm_fused, slstm_fused_bwd)

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "build", "build_bwd",
           "reset_launch_counts", "slstm_bwd_costs", "slstm_costs",
           "slstm_fused", "slstm_fused_bwd", "slstm_ref"]
