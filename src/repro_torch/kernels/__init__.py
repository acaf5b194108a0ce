"""Hand-written Hopper kernels of the port, one directory per kernel.

Each directory keeps the reference's triple: the kernel module (wrappers,
build and binding, with the CUDA source under csrc/), `ops` (entry points
from core params) and `ref` (the plain PyTorch version the CPU path and the
tests use). Ported so far: cnn_eq (fp32, bf16, int8), volterra, quant
(fixed-point quantize), conv1d, flash_attn (the attention forward and
backward) and slstm (the fused sLSTM recurrence); `_build` compiles and
binds them all.
"""
