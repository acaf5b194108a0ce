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

`slstm_fused_bwd` is the plain backward: the reverse-time loop that the
backward kernel (csrc/slstm_bwd.cu) runs, held on the CPU against
`torch.autograd` through `slstm_fused`. The reference has no backward of
its own (it differentiates its `lax.scan`). Both work from values
recomputed after the forward (`recompute`): the gate pre-activations
from hs by one batched product over all steps, then c, n, m by the gates'
elementwise recurrence, so the forward saves nothing beyond its inputs
and hs.
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


EPS = 1e-6


def recompute(xg: torch.Tensor, r: torch.Tensor, state: State, nh: int,
              hs: torch.Tensor, dtype: torch.dtype = torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pre (B, S, 4·d), h_prev (B, S, d)) in ``dtype``: h_prev is h0
    followed by hs[:, :-1], and pre_t = xg_t + h_{t−1}·R_blockdiag, one
    batched product over all steps (the forward's sums, in another
    order)."""
    bb, s, d4 = xg.shape
    d = d4 // 4
    dh = d // nh
    h_prev = torch.cat([state[2].to(dtype)[:, None],
                        hs[:, :-1].to(dtype)], dim=1)
    rec = torch.einsum("bshk,ghke->bsghe", h_prev.reshape(bb, s, nh, dh),
                       r.to(dtype)).reshape(bb, s, d4)
    return xg.to(dtype) + rec, h_prev


def gate_states(pre: torch.Tensor, state: State
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """c, n, m (B, S, d) after each step, from pre (B, S, 4·d) and the
    initial state: the forward's gate recurrence, elementwise."""
    bb, s, d4 = pre.shape
    p4 = pre.reshape(bb, s, 4, d4 // 4)
    c, n, _, m = (t.to(pre.dtype) for t in state)
    cs, ns, ms = [], [], []
    for t in range(s):
        z = torch.tanh(p4[:, t, 0])
        i_pre, f_pre = p4[:, t, 1], p4[:, t, 2]
        m_new = torch.maximum(f_pre + m, i_pre)
        i_s = torch.exp(i_pre - m_new)
        f_s = torch.exp(f_pre + m - m_new)
        c = f_s * c + i_s * z
        n = f_s * n + i_s
        m = m_new
        cs.append(c)
        ns.append(n)
        ms.append(m)
    return (torch.stack(cs, dim=1), torch.stack(ns, dim=1),
            torch.stack(ms, dim=1))


def slstm_fused_bwd(xg: torch.Tensor, r: torch.Tensor, state: State,
                    nh: int, hs: torch.Tensor, dhs: torch.Tensor,
                    dstate: State, dtype: torch.dtype = torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """The backward of `slstm_fused`: given its inputs (xg (B, S, 4·d), r
    (4, nh, dh, dh), state (c, n, h, m)), its hs and the cotangents of hs
    and of the final (c, n, h, m), returns (dxg (B, S, 4·d), dr (4, nh,
    dh, dh), (dc0, dn0, dh0, dm0)), all in ``dtype``.

    A reverse-time loop over the recomputed forward values, per step and
    column with N = max(n_t, ε): dh = dhs_t + the carried dh; d(o·c) =
    dh/N, do = d(o·c)·c_t, dc += d(o·c)·o, and dn −= dh·h_t/N where n_t ≥
    ε (the clamp's gradient, a tie at ε included); then through c_t = f_s
    c + i_s z, n_t = f_s n + i_s, the stabilizer m_t = max(f̃ + m, ĩ) (a
    tie split in halves, as `torch.maximum`'s gradient does) and the two
    exponentials, to dpre_t = [dz̃, dĩ, df̃, dõ]; the carried dh is the
    block-diagonal transpose product Σ_g Σ_e r[g, hd, k, e]·dpre_t[g, hd,
    e], and dc, dn carry as dc·f_s, dn·f_s, dm as df̃. dr = Σ_{b,t}
    h_{t−1} ⊗ dpre_t, one einsum after the loop."""
    bb, s, d4 = xg.shape
    d = d4 // 4
    dh_ = d // nh
    rf = r.to(dtype)
    pre, h_prev = recompute(xg, r, state, nh, hs, dtype)
    cs, ns, ms = gate_states(pre, state)
    hs_ = hs.to(dtype)
    p4 = pre.reshape(bb, s, 4, d)
    dc, dn, dh_c, dm = (t.to(dtype) for t in dstate)
    dpre = torch.empty_like(p4)
    c0, n0, _, m0 = (t.to(dtype) for t in state)
    for t in reversed(range(s)):
        pz, pi, pf, po = p4[:, t].unbind(1)
        c_t, n_t, m_t = cs[:, t], ns[:, t], ms[:, t]
        c_p, n_p, m_p = ((cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t
                         else (c0, n0, m0))
        z = torch.tanh(pz)
        o = torch.sigmoid(po)
        fm = pf + m_p
        i_s = torch.exp(pi - m_t)
        f_s = torch.exp(fm - m_t)
        big = torch.clamp(n_t, min=EPS)
        g = dhs[:, t].to(dtype) + dh_c
        doc = g / big
        do = doc * c_t
        dc = dc + doc * o
        dn = dn + torch.where(n_t >= EPS, -(g * (hs_[:, t] / big)),
                              torch.zeros_like(g))
        dz = dc * i_s
        di_s = dc * z + dn
        df_s = dc * c_p + dn * n_p
        dpi = di_s * i_s
        dfm = df_s * f_s
        dmt = dm - dpi - dfm
        half = dmt / 2
        zero = torch.zeros_like(dmt)
        dfm = dfm + torch.where(fm > pi, dmt, torch.where(fm == pi, half,
                                                          zero))
        dpi = dpi + torch.where(pi > fm, dmt, torch.where(fm == pi, half,
                                                          zero))
        dpre[:, t, 0] = dz * (1 - z * z)
        dpre[:, t, 1] = dpi
        dpre[:, t, 2] = dfm
        dpre[:, t, 3] = do * (1 - o) * o
        dh_c = torch.einsum("bghe,ghke->bhk",
                            dpre[:, t].reshape(bb, 4, nh, dh_),
                            rf).reshape(bb, d)
        dc = dc * f_s
        dn = dn * f_s
        dm = dfm
    dr = torch.einsum("bshk,bsghe->ghke", h_prev.reshape(bb, s, nh, dh_),
                      dpre.reshape(bb, s, 4, nh, dh_))
    return dpre.reshape(bb, s, d4), dr, (dc, dn, dh_c, dm)
