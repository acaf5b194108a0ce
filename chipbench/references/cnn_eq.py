"""Plain reference of the paper's CNN equalizer, as the benchmark judges it.

Written for the benchmark from the paper's description (§3.1, §5.3) and the
configuration files; it imports torch and numpy only, nothing of the
program. It works from the raw seeded parameters the benchmark hands to the
program too, and derives everything else itself:

  * BN folding in float32: g = gamma / sqrt(var + 1e-5), w·g and
    (b - mean)·g + beta, for every layer but the last;
  * the datapath the configuration states:
      - "int": weights rounded to Q(w_int).(w_frac) and each layer's input
        to Q(a_int).(a_frac) (round half to even, saturating at the grid's
        ends), integer tap dots, the sum scaled by 2^-(w_frac + a_frac) and
        the float32 bias added. Every product and sum is an integer that
        float64 holds exactly, so this path has one right answer;
      - "float": each layer's input and weights rounded to ``operand``
        (bfloat16, or float8 for the control), products and sums in
        float64, the bias added, the result rounded to float32;
  * stream semantics: a row is zero outside its samples, and final
    position m (V_p symbols) is centred on input sample m·V_p·N_os, so the
    row is padded once by half a receptive field and every layer is a
    valid convolution. ReLU between layers, none after the last; symbol
    m·V_p + c is channel c of position m.

Long rows run in blocks of positions and many rows in blocks of rows, so
that a batch of tens of millions of symbols fits beside the program's.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def fold(raw: dict) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Raw parameters with a leading head dim → [(w, b)] per layer, fp32:
    w (H, C_out, C_in, K), b (H, C_out)."""
    layers = []
    n = len(raw["w"])
    for i in range(n):
        w, b = raw["w"][i], raw["b"][i]
        if i < n - 1:
            g = raw["gamma"][i] / torch.sqrt(raw["var"][i] + BN_EPS)
            w = w * g[..., None, None]
            b = (b - raw["mean"][i]) * g + raw["beta"][i]
        layers.append((w.float(), b.float()))
    return layers


def halo(kernels: Sequence[int], strides: Sequence[int]) -> int:
    """Half a receptive field, in input samples."""
    r, jump = 0, 1
    for k, s in zip(kernels, strides):
        r += (k // 2) * jump
        jump *= s
    return r


def spans(n_pos: int, kernels: Sequence[int],
          strides: Sequence[int]) -> List[int]:
    """Positions each level needs for n_pos final positions; [0] is the
    input samples."""
    out = [n_pos]
    for k, s in zip(reversed(list(kernels)), reversed(list(strides))):
        out.append((out[-1] - 1) * s + k)
    return out[::-1]


def _grid(v: torch.Tensor, int_bits: int, frac_bits: int) -> torch.Tensor:
    """Integer values of v on the signed Q(int_bits).(frac_bits) grid, as
    float64."""
    top = float(2 ** (int_bits + frac_bits))
    return torch.clamp(torch.round(v.float() * float(2.0 ** frac_bits)),
                       -top, top - 1.0).double()


def _conv(h: torch.Tensor, w: torch.Tensor, stride: int,
          n_out: int) -> torch.Tensor:
    """Valid convolution in float64: h (R, C_in, n), w (R or 1, C_out,
    C_in, K) → (R, C_out, n_out)."""
    u = h.unfold(2, w.shape[-1], stride)[:, :, :n_out]
    if w.shape[0] == 1:
        return torch.einsum("rcnk,ock->ron", u, w[0])
    return torch.einsum("rcnk,rock->ron", u, w)


def _stack(xp: torch.Tensor, layers, strides, n_pos: int,
           datapath: dict) -> torch.Tensor:
    """Padded rows (R, ≥ spans[0]) → (R, n_pos·V_p) fp32."""
    kernels = [int(w.shape[-1]) for w, _ in layers]
    sp = spans(n_pos, kernels, strides)
    h = xp[:, None, :sp[0]].float()
    for i, ((w, b), s) in enumerate(zip(layers, strides)):
        if datapath["kind"] == "int":
            wi, wf, ai, af = datapath["formats"][i]
            acc = _conv(_grid(h, ai, af), _grid(w, wi, wf), s, sp[i + 1])
            h = (acc * float(2.0 ** -(wf + af))).float() + b[:, :, None]
        else:
            op = getattr(torch, datapath["operand"])
            acc = _conv(h.to(op).double(), w.to(op).double(), s, sp[i + 1])
            h = (acc + b.double()[:, :, None]).float()
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h.transpose(1, 2).reshape(h.shape[0], -1)


def _pad(x: torch.Tensor, n_pos: int, kernels, strides) -> torch.Tensor:
    total = 1
    for s in strides:
        total *= s
    left = halo(kernels, strides)
    need = total * (n_pos - 1) + spans(1, kernels, strides)[0]
    return F.pad(x, (left, max(0, need - x.shape[-1] - left)))


def equalize_stream(x: torch.Tensor, layers, strides, datapath: dict,
                    block: int = 1 << 18) -> torch.Tensor:
    """One stream x (N,) → (N // (V_p·N_os) · V_p,) symbols, ``block``
    final positions at a time. ``layers``: one head, leading dim 1."""
    kernels = [int(w.shape[-1]) for w, _ in layers]
    total = 1
    for s in strides:
        total *= s
    n_pos = x.shape[0] // total
    v_p = int(layers[-1][0].shape[-3])
    xp = _pad(x, n_pos, kernels, strides)
    span1 = spans(1, kernels, strides)[0]
    out = torch.empty(n_pos * v_p, dtype=torch.float32, device=x.device)
    for m0 in range(0, n_pos, block):
        m1 = min(n_pos, m0 + block)
        seg = xp[total * m0:total * (m1 - 1) + span1][None]
        out[m0 * v_p:m1 * v_p] = _stack(seg, layers, strides, m1 - m0,
                                        datapath)[0]
    return out


def equalize_rows(x: torch.Tensor, layers, strides, datapath: dict,
                  head_of_row: torch.Tensor, block: int = 64
                  ) -> torch.Tensor:
    """Rows x (R, W), each a record of its own, row r through head
    ``head_of_row[r]`` → (R, W // (V_p·N_os) · V_p), ``block`` rows at a
    time."""
    kernels = [int(w.shape[-1]) for w, _ in layers]
    total = 1
    for s in strides:
        total *= s
    n_pos = x.shape[1] // total
    v_p = int(layers[-1][0].shape[-3])
    out = torch.empty((x.shape[0], n_pos * v_p), dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, x.shape[0], block):
        r1 = min(x.shape[0], r0 + block)
        heads = head_of_row[r0:r1]
        rows = [(w[heads], b[heads]) for w, b in layers]
        out[r0:r1] = _stack(_pad(x[r0:r1], n_pos, kernels, strides), rows,
                            strides, n_pos, datapath)
    return out


def lower_precision(datapath: dict) -> dict:
    """The control's datapath: the nearest precision below the stated one.
    int8 → int4 on grids of the same range (4 fewer fraction bits);
    bfloat16 operands → float8 (e4m3)."""
    if datapath["kind"] == "int":
        return {"kind": "int",
                "formats": [[wi, wf - 4, ai, af - 4]
                            for wi, wf, ai, af in datapath["formats"]]}
    return {"kind": "float", "operand": "float8_e4m3fn"}
