from .cnn_eq import (LAUNCHES, build, cast_weights_bf16, cnn_eq_fused,
                     cnn_eq_fused_bf16, cnn_eq_fused_int8, dequant_int8,
                     quantize_weights_int8, requant_int8,
                     reset_launch_counts)
from .ops import equalize, strides_of, weights_of
from .ref import cnn_eq as cnn_eq_ref
from .ref import cnn_eq_bf16 as cnn_eq_bf16_ref
from .ref import cnn_eq_int8 as cnn_eq_int8_ref
from .ref import cnn_eq_quant as cnn_eq_quant_ref

__all__ = ["LAUNCHES", "build", "cast_weights_bf16", "cnn_eq_bf16_ref",
           "cnn_eq_fused", "cnn_eq_fused_bf16", "cnn_eq_fused_int8",
           "cnn_eq_int8_ref", "cnn_eq_quant_ref", "cnn_eq_ref",
           "dequant_int8", "equalize", "quantize_weights_int8",
           "requant_int8", "reset_launch_counts", "strides_of",
           "weights_of"]
