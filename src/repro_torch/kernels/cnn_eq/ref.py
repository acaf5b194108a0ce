"""Plain PyTorch versions of the fused CNN-equalizer kernels.

Port of `repro.kernels.cnn_eq.ref`, with the same STREAM semantics: the
input is padded ONCE with half a receptive field of zeros per side and the
layer stack runs VALID convolutions (no per-layer padding, as on the
streaming hardware). This differs from `core.equalizer.apply_folded`
(per-layer SAME padding) only within o_sym symbols of the stream edges.

The layer helpers work on a batch of rows, h: (R, C_in, W), with weights
shared, w: (C_out, C_in, K), or one set per row, w: (R, C_out, C_in, K).

Summation order. Every output (c_out, m) accumulates TAP-MAJOR, THEN C_in
ASCENDING, one product at a time, starting from zero, with the bias added
last:

    acc = 0;  for kk: for ci: acc = acc + w[c, ci, kk] · x[ci, m·s + kk]
    y = acc + b[c]

written as elementwise multiplies and adds vectorised over rows and width
(no matmul, einsum, conv or addcmul, whose internal order or FMA use is not
fixed). The order therefore depends on neither the width nor the batch, and
it is the order the CUDA kernels in csrc/cnn_eq.cu use, so on the card a
kernel equals its plain version bitwise. Against the JAX reference (whose
tap dots sum each tap over C_in before adding it) the fp32 and bf16 paths
differ by rounding only; the int8 path is exact.

Datapaths:
  * fp32  `cnn_eq`        — `conv_valid_taps`;
  * bf16  `cnn_eq_bf16`   — `conv_valid_taps_bf16`: each layer's input and
    weights rounded to bf16 (nearest even), products (exact in fp32) and
    sums in fp32, fp32 bias and activations between layers;
  * int8  `cnn_eq_int8`   — the integer path the int8 kernel runs: requant
    each layer's input to int8 (`requant_int8`), int32 tap dots, rescale by
    the per-channel power of two, fp32 bias;
  * `cnn_eq_quant`        — the QAT fake-quant oracle of the int8 path
    (values snapped to their grids, convs in fp32); equal to `cnn_eq_int8`
    because every product and partial sum is exact on those grids.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def receptive_halo(kernels: Sequence[int], strides: Sequence[int]) -> int:
    """Half a receptive field, in input samples."""
    r, jump = 0, 1
    for k, s in zip(kernels, strides):
        r += (k // 2) * jump
        jump *= s
    return r


def _rows(w: torch.Tensor, b: torch.Tensor):
    """Shared or stacked (w, b) → views with a leading row dim (R or 1)."""
    return (w[None] if w.dim() == 3 else w), (b[None] if b.dim() == 1 else b)


def _taps(h: torch.Tensor, w: torch.Tensor, stride: int, n_out: int,
          acc: torch.Tensor) -> torch.Tensor:
    """acc += Σ_kk Σ_ci w[..., ci, kk] · h[:, ci, kk::stride], in that order."""
    k, c_in = w.shape[-1], w.shape[-2]
    for kk in range(k):
        xk = h[:, :, kk:kk + (n_out - 1) * stride + 1:stride]
        for ci in range(c_in):
            acc = acc + w[:, :, ci, kk, None] * xk[:, ci, None, :]
    return acc


def conv_valid_taps(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int, n_out: int) -> torch.Tensor:
    """(R, C_in, W) ⊛ w → (R, C_out, n_out), fp32, tap-major accumulation."""
    w, b = _rows(w, b)
    acc = torch.zeros((h.shape[0], w.shape[1], n_out), dtype=torch.float32,
                      device=h.device)
    acc = _taps(h.float(), w.float(), stride, n_out, acc)
    return acc + b.float()[:, :, None]


def conv_valid_taps_bf16(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         stride: int, n_out: int) -> torch.Tensor:
    """bf16 variant: input and weights rounded to bf16, fp32 accumulation.

    A bf16×bf16 product is exact in fp32, so only the sums round — in the
    same order as `conv_valid_taps`. Weights may already be bf16.
    """
    hb = h.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    return conv_valid_taps(hb, wb, b, stride, n_out)


def _halo_pad(x: torch.Tensor, kernels: Sequence[int],
              strides: Sequence[int]):
    """Stream-semantics padding shared by every plain version: ONE halo of
    zeros on the left, zeros on the right up to the last position's window."""
    halo = receptive_halo(kernels, strides)
    total_stride = int(np.prod(strides))
    n_pos = x.shape[1] // total_stride
    need = (n_pos - 1) * total_stride + 2 * halo + 1
    xp = F.pad(x, (halo, max(0, need - x.shape[1] - halo)))
    return xp, n_pos


def _spans(n_pos: int, kernels: Sequence[int],
           strides: Sequence[int]) -> list:
    """Positions needed at each level to produce n_pos final positions."""
    spans = [n_pos]
    for k, s in zip(reversed(list(kernels)), reversed(list(strides))):
        spans.append((spans[-1] - 1) * s + k)
    return spans[::-1]


def _interleave(h: torch.Tensor) -> torch.Tensor:
    """(R, V_p, n) → (R, n·V_p): symbol m·V_p + c."""
    return h.transpose(1, 2).reshape(h.shape[0], -1)


def _stack_valid(xp: torch.Tensor, weights, strides: Sequence[int],
                 n_pos: int, conv_fn=conv_valid_taps) -> torch.Tensor:
    """Run the halo-padded layer stack on rows: (R, W_pad) → (R, n_pos·V_p).

    conv_fn picks the datapath: `conv_valid_taps` (fp32) or
    `conv_valid_taps_bf16`.
    """
    spans = _spans(n_pos, [int(w.shape[-1]) for w, _ in weights], strides)
    h = xp[:, None, :].float()
    for i, ((w, b), s) in enumerate(zip(weights, strides)):
        h = conv_fn(h, w, b, s, spans[i + 1])
        if i < len(weights) - 1:
            h = torch.relu(h)
    return _interleave(h)


def cnn_eq(x: torch.Tensor, weights, strides: Sequence[int]) -> torch.Tensor:
    """x: (B, W) waveform → (B, W//(∏strides)·V_p) symbols, fp32."""
    kernels = [int(w.shape[-1]) for w, _ in weights]
    xp, n_pos = _halo_pad(x, kernels, strides)
    return _stack_valid(xp, weights, strides, n_pos).to(x.dtype)


def cnn_eq_bf16(x: torch.Tensor, weights,
                strides: Sequence[int]) -> torch.Tensor:
    """bf16-datapath forward — the fused_bf16 plain version."""
    kernels = [int(w.shape[-1]) for w, _ in weights]
    xp, n_pos = _halo_pad(x, kernels, strides)
    return _stack_valid(xp, weights, strides, n_pos,
                        conv_fn=conv_valid_taps_bf16).to(x.dtype)


# ---------------------------------------------------------------------------
# int8 datapath
# ---------------------------------------------------------------------------

def requant_int8(h: torch.Tensor, a_int: int, a_frac: int) -> torch.Tensor:
    """fp32 → int8 on the Q(a_int).(a_frac) grid (values are x·2^a_frac).

    Round half to even, clip in float, THEN convert (a float→int8 cast out
    of range is undefined).
    """
    hi = float(2 ** (a_int + a_frac)) - 1.0
    lo = -float(2 ** (a_int + a_frac))
    q = torch.clamp(torch.round(h * float(2.0 ** a_frac)), lo, hi)
    return q.to(torch.int8)


def _wformat_cols(wi, wf):
    """Weight-format components as fp32 numpy columns, (1, 1) or (C_out, 1)
    for scalar or per-output-channel formats."""
    return (np.asarray(wi, np.float32).reshape(-1, 1),
            np.asarray(wf, np.float32).reshape(-1, 1))


def rescale_column(fmt, c_out: int) -> np.ndarray:
    """(C_out,) fp32: the exact power of two 2^-(w_frac + a_frac) that takes
    a layer's int32 accumulator back to real units."""
    wi, wf, ai, af = fmt
    _, wf_col = _wformat_cols(wi, wf)
    return np.broadcast_to(np.exp2(-(wf_col + af)).reshape(-1),
                           (c_out,)).astype(np.float32)


def _stack_valid_int8(xp: torch.Tensor, qweights, strides: Sequence[int],
                      n_pos: int, formats, scales) -> torch.Tensor:
    """Integer layer stack on rows: requant, int32 taps, rescale, bias."""
    spans = _spans(n_pos, [int(w.shape[-1]) for w, _ in qweights], strides)
    h = xp[:, None, :].float()
    for i, ((w, b), s) in enumerate(zip(qweights, strides)):
        _, _, ai, af = formats[i]
        hq = requant_int8(h, ai, af).to(torch.int32)
        w, b = _rows(w, b)
        acc = torch.zeros((h.shape[0], w.shape[1], spans[i + 1]),
                          dtype=torch.int32, device=h.device)
        acc = _taps(hq, w.to(torch.int32), s, spans[i + 1], acc)
        h = acc.float() * scales[i][None, :, None] + b.float()[:, :, None]
        if i < len(qweights) - 1:
            h = torch.relu(h)
    return _interleave(h)


def cnn_eq_int8(x: torch.Tensor, qweights, strides: Sequence[int],
                formats) -> torch.Tensor:
    """The int8 kernel's plain version: int8 weights (`quantize_weights_int8`)
    and fp32 biases, per-layer formats (w_int, w_frac, a_int, a_frac)."""
    kernels = [int(w.shape[-1]) for w, _ in qweights]
    xp, n_pos = _halo_pad(x, kernels, strides)
    scales = [torch.from_numpy(rescale_column(fmt, int(w.shape[-3]))).to(
        x.device) for (w, _), fmt in zip(qweights, formats)]
    return _stack_valid_int8(xp, qweights, strides, n_pos, formats,
                             scales).to(x.dtype)


def _fake_quant(x: torch.Tensor, int_bits, frac_bits) -> torch.Tensor:
    """quantize_fixed without the STE (forward values are identical).

    int_bits/frac_bits are python ints or numpy arrays broadcastable against
    `x` (per-output-channel weight formats: shape (C_out, 1, 1))."""
    scale = np.exp2(np.asarray(frac_bits, np.float32))
    hi = np.exp2(np.asarray(int_bits, np.float32)) - 1.0 / scale
    lo = -np.exp2(np.asarray(int_bits, np.float32))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(x.device)
    q = torch.round(x * t(scale)) / t(scale)
    return torch.minimum(torch.maximum(q, t(lo)), t(hi))


def cnn_eq_quant(x: torch.Tensor, weights, strides: Sequence[int],
                 formats) -> torch.Tensor:
    """Fake-quantized stream-semantics forward — the int8 path's oracle.

    formats[l] = (w_int, w_frac, a_int, a_frac). Layer l snaps its input to
    Q(a_int).(a_frac) and its BN-folded fp32 weights to Q(w_int).(w_frac),
    then convolves in fp32; biases stay fp32.
    """
    kernels = [int(w.shape[-1]) for w, _ in weights]
    xp, n_pos = _halo_pad(x, kernels, strides)
    spans = _spans(n_pos, kernels, strides)
    h = xp[:, None, :].float()
    for i, ((w, b), s) in enumerate(zip(weights, strides)):
        wi, wf, ai, af = formats[i]
        wi_col, wf_col = _wformat_cols(wi, wf)
        wq = _fake_quant(w.float(), wi_col.reshape(-1, 1, 1),
                         wf_col.reshape(-1, 1, 1))
        h = _fake_quant(h, ai, af)
        h = conv_valid_taps(h, wq, b, s, spans[i + 1])
        if i < len(weights) - 1:
            h = torch.relu(h)
    return _interleave(h).to(x.dtype)
