from .ops import quantize_params
from .quant import (INSTANCE_LAUNCHES, LAUNCHES, MAX_SEGMENTS, build,
                    fixed_point_quantize, fixed_point_quantize_many,
                    reset_launch_counts)
from .ref import fixed_point_quantize as quantize_ref

__all__ = ["INSTANCE_LAUNCHES", "LAUNCHES", "MAX_SEGMENTS", "build",
           "fixed_point_quantize", "fixed_point_quantize_many",
           "quantize_params", "quantize_ref", "reset_launch_counts"]
