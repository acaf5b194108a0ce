from .ops import quantize_params
from .quant import (LAUNCHES, build, fixed_point_quantize,
                    reset_launch_counts)
from .ref import fixed_point_quantize as quantize_ref

__all__ = ["LAUNCHES", "build", "fixed_point_quantize", "quantize_params",
           "quantize_ref", "reset_launch_counts"]
