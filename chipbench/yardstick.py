"""The benchmark's fixed arithmetic: the H100's peaks, and the bytes and
operations of the equalizer's work, counted from shapes.

Peaks are NVIDIA's published dense rates of one H100 SXM at its 700 W
limit: HBM3 at 3.35 TB/s; 989 TFLOP/s in bf16 and 1,979 TOP/s in int8 on
the tensor cores; 67 TFLOP/s in fp32 outside them.

Counts, for rows of ``width`` input samples through the CNN (C_out, C_in,
K and stride per layer): a row of W samples gives W // (V_p·N_os) final
positions of V_p symbols each, and layer l computes spans[l + 1]
positions of C_out·C_in·K multiply-accumulates each (the valid stack over
the row padded by half a receptive field, as the stream runs it). An
operation is half a multiply-accumulate. Bytes count each input byte read
once (rows that overlap in memory are one read) and each output byte
written once.
"""
from __future__ import annotations

import math
from typing import List, Tuple

from chipbench.references.cnn_eq import spans

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
BACKEND_PEAK = {"fused_fp32": "fp32", "fused_bf16": "bf16",
                "fused_int8": "int8"}
SAMPLE_BYTES = 4           # float32 waveform in
SYMBOL_BYTES = 4           # float32 soft symbol out


def layers(cnn: dict) -> List[Tuple[int, int, int, int]]:
    """(C_out, C_in, K, stride) of each layer of the configuration."""
    c, k, n = cnn["channels"], cnn["kernel"], cnn["layers"]
    return ([(c, 1, k, cnn["v_parallel"])]
            + [(c, c, k, 1)] * (n - 2)
            + [(cnn["v_parallel"], c, k, cnn["n_os"])])


def macs_per_symbol(cnn: dict) -> float:
    """Multiply-accumulates a kept symbol needs in the steady state: layer
    l runs once per ∏_{j≤l} stride_j input samples."""
    dims = layers(cnn)
    samples_per_symbol = cnn["n_os"]
    macs, step = 0.0, 1
    for c_out, c_in, k, s in dims:
        step *= s
        macs += c_out * c_in * k * samples_per_symbol / step
    return macs


def ops_per_symbol(cnn: dict) -> float:
    return 2.0 * macs_per_symbol(cnn)


def stream_bytes_per_symbol(cnn: dict) -> int:
    """N_os float32 samples read and one float32 symbol written."""
    return cnn["n_os"] * SAMPLE_BYTES + SYMBOL_BYTES


def call_macs(cnn: dict, rows: int, width: int) -> int:
    """Multiply-accumulates of one call on (rows, width) samples."""
    dims = layers(cnn)
    kernels, strides = [d[2] for d in dims], [d[3] for d in dims]
    sp = spans(width // math.prod(strides), kernels, strides)
    return rows * sum(c_out * c_in * k * sp[i + 1]
                      for i, (c_out, c_in, k, _) in enumerate(dims))


def call_bytes(rows: int, width: int, row_stride: int, out: int) -> int:
    """Input bytes read once (rows that overlap in memory count once) and
    output bytes written once."""
    unique = min(rows * width, (rows - 1) * row_stride + width)
    return unique * SAMPLE_BYTES + out * SYMBOL_BYTES


def roofline_s(n_bytes: float, ops: float, backend: str) -> Tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[BACKEND_PEAK[backend]]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
