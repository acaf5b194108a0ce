from .ops import equalize
from .ref import volterra as volterra_ref
from .volterra import INSTANCE_LAUNCHES, LAUNCHES, build, reset_launch_counts
from .volterra import volterra as volterra_kernel

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "build", "equalize",
           "reset_launch_counts", "volterra_kernel", "volterra_ref"]
