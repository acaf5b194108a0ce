"""Plain PyTorch version of the Volterra equalizer kernel (orders 0–3).

Port of `repro.kernels.volterra.ref`, with the same STREAM semantics: the
input is padded once by the common halo max(m1//2, m2//2, m3//2) and each
output symbol n reads its order-r window at n·stride + halo − m_r//2.

Summation order — the order of the CUDA kernel (csrc/volterra.cu), one
product at a time from zero, vectorised over rows and positions:

    o1 = Σ_m win1[m]·w1[m]
    o2 = Σ_k (Σ_j win2[j]·W2[j,k])·win2[k]
    o3 = Σ_i win3[i]·Σ_k (Σ_j win3[j]·W3[i,j,k])·win3[k]
    y  = ((w0 + o1) + o2) + o3

written as elementwise multiplies and adds (no einsum or matmul, whose
internal order is not fixed), so on the card the kernel equals this
version bitwise. Against the JAX reference (einsums) it differs by
rounding only.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def memory_lengths(w1: torch.Tensor, w2: Optional[torch.Tensor],
                   w3: Optional[torch.Tensor]):
    """(m1, m2, m3); 0 for a disabled order."""
    return (int(w1.shape[0]), int(w2.shape[0]) if w2 is not None else 0,
            int(w3.shape[0]) if w3 is not None else 0)


def volterra_valid(xp: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                   w2: Optional[torch.Tensor], w3: Optional[torch.Tensor],
                   stride: int, halo: int, n_out: int) -> torch.Tensor:
    """n_out symbols per row of the halo-padded xp: (B, W') → (B, n_out)."""
    m1, m2, m3 = memory_lengths(w1, w2, w3)

    def win(m: int, j: int) -> torch.Tensor:       # window element j, order m
        start = halo - m // 2 + j
        return xp[:, start:start + (n_out - 1) * stride + 1:stride]

    zeros = xp.new_zeros((xp.shape[0], n_out))
    o1 = zeros
    for m in range(m1):
        o1 = o1 + win(m1, m) * w1[m]
    y = w0.reshape(()) + o1
    if m2 > 0:
        o2 = zeros
        for k in range(m2):
            t = zeros
            for j in range(m2):
                t = t + win(m2, j) * w2[j, k]
            o2 = o2 + t * win(m2, k)
        y = y + o2
    if m3 > 0:
        o3 = zeros
        for i in range(m3):
            s = zeros
            for k in range(m3):
                t = zeros
                for j in range(m3):
                    t = t + win(m3, j) * w3[i, j, k]
                s = s + t * win(m3, k)
            o3 = o3 + win(m3, i) * s
        y = y + o3
    return y


def volterra(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
             w2: Optional[torch.Tensor], w3: Optional[torch.Tensor],
             stride: int) -> torch.Tensor:
    """x: (B, W) → (B, W//stride), of x's type (float32 arithmetic, one
    rounding at the end, as the reference). w1: (M1,), w2: (M2, M2), w3:
    (M3,M3,M3); orders 2/3 off when None."""
    halo = max(m // 2 for m in memory_lengths(w1, w2, w3))
    xp = F.pad(x.float(), (halo, halo))
    return volterra_valid(xp, w0.float(), w1.float(),
                          None if w2 is None else w2.float(),
                          None if w3 is None else w3.float(), stride, halo,
                          x.shape[1] // stride).to(x.dtype)
