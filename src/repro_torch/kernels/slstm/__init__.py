from .ref import slstm as slstm_ref
from .slstm import (INSTANCE_LAUNCHES, LAUNCHES, build, reset_launch_counts,
                    slstm_costs, slstm_fused)

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "build", "reset_launch_counts",
           "slstm_costs", "slstm_fused", "slstm_ref"]
