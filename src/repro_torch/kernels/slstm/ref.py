"""Plain PyTorch versions of the fused sLSTM recurrence.

Port of `repro.kernels.slstm.ref`. `slstm` is the oracle, with xg in the
reference's (B, S, 4, d) layout; `slstm_fused` is the same function in the
kernel's (B, S, 4·d) layout, the body the wrapper runs on a CPU tensor and
the version the kernel (csrc/slstm.cu) is held against on the card. Both
step through time in a Python loop, one einsum for the block-diagonal
recurrent product a step, in f32 (xg and r are cast exactly, as the
reference casts them) or, for measuring, in float64; the einsum orders its
sums as the backend chooses, so the kernel agrees with them to a
tolerance, not bitwise.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _step(x_t: torch.Tensor, rf: torch.Tensor, state: State) -> State:
    """One step: x_t (B, 4, d), rf (4, nh, dh, dh), state (c, n, h, m)
    each (B, d), all of one float type → (c', n', h', m')."""
    c, n, h, m = state
    bb, _, d = x_t.shape
    _, nh, dh, _ = rf.shape
    rec = torch.einsum("bhd,ghde->bghe", h.reshape(bb, nh, dh),
                       rf).reshape(bb, 4, d)
    pre = x_t + rec
    z = torch.tanh(pre[:, 0])
    i_pre, f_pre = pre[:, 1], pre[:, 2]
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(f_pre + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(f_pre + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm(xg: torch.Tensor, r: torch.Tensor, state: State,
          dtype: torch.dtype = torch.float32
          ) -> Tuple[torch.Tensor, State]:
    """Stabilized sLSTM over time (the oracle the kernel must match).

    xg: (B, S, 4, d) input pre-activations [z, i, f, o];
    r:  (4, H, dh, dh) block-diagonal recurrent weights (d = H·dh);
    state: (c, n, h, m) each (B, d) f32.
    Returns (hs (B, S, d), new_state), computed in ``dtype``: f32, as the
    reference, or float64 to measure how far f32 rounding carries.
    """
    rf = r.to(dtype)
    st = tuple(s.to(dtype) for s in state)
    hs = []
    for t in range(xg.shape[1]):
        st = _step(xg[:, t].to(dtype), rf, st)
        hs.append(st[2])
    bb, _, _, d = xg.shape
    out = (torch.stack(hs, dim=1) if hs
           else xg.new_zeros((bb, 0, d), dtype=dtype))
    return out, st


def slstm_fused(xg: torch.Tensor, r: torch.Tensor, state: State, nh: int,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, State]:
    """`slstm` in the kernel's layout: xg (B, S, 4·d), gates [z, i, f, o]
    along the last axis, r (4, nh, dh, dh). Returns (hs (B, S, d),
    (c, n, h, m)) in ``dtype``."""
    bb, s, d4 = xg.shape
    if r.shape[1] != nh:
        raise ValueError(f"r has {r.shape[1]} heads, nh = {nh}")
    return slstm(xg.reshape(bb, s, 4, d4 // 4), r, state, dtype)
