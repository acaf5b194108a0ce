from .conv1d import LAUNCHES, build, reset_launch_counts
from .conv1d import conv1d as conv1d_kernel
from .ops import conv1d_same_lower
from .ref import conv1d as conv1d_ref

__all__ = ["LAUNCHES", "build", "conv1d_kernel", "conv1d_ref",
           "conv1d_same_lower", "reset_launch_counts"]
