"""xLSTM blocks: chunkwise-parallel mLSTM + recurrent sLSTM (arXiv:2405.04517).

Port of `repro.models.xlstm`. mLSTM (matrix memory, exponential gating)
runs in the chunkwise form: within a chunk the gated outer-product
recurrence expands to a masked attention-like product, across chunks a
Python loop carries the stabilized state (C, n, m) where the reference
runs a `lax.scan` (under `jax.checkpoint`, which only matters for a
gradient). sLSTM (scalar memory, recurrent gate connections) is
sequential: `slstm_scan` hands the whole sequence to the fused kernel
(`kernels.slstm.slstm_fused`), which the reference's own `slstm_scan`
computes with a `lax.scan` of the same function on the same layout.

Block layout follows the paper: mLSTM blocks use pre-up-projection (×2)
with a causal conv feeding q/k; sLSTM blocks use post-up-projection (×4/3,
gated). Stabilized exponential gating (log-space max-shift) throughout;
the stabilizer m starts at NEG = -1e30, finite, so f + m − m' never
becomes inf − inf.

The reference's `sharding.logical` annotations have no counterpart on one
card (tp = 1) and are dropped. The forward takes no `jax.checkpoint`
counterpart either: on the card the sLSTM kernel has no backward and
refuses autograd, and `launch.train` refuses this family (ROADMAP Queue 1
item 10); `loss_fn` runs, for the loss value. Scalars that the reference
divides a stream by (1/sqrt(D)) are cast to the stream's type first, as
JAX's weak typing does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..kernels.slstm import slstm_fused
from .common import ModelConfig, dense_init, rms_norm

NEG = -1e30


def _div_sqrt(x: torch.Tensor, d: int) -> torch.Tensor:
    """x / sqrt(d) with the divisor in x's type (JAX's weak-typed scalar)."""
    return x / torch.tensor(math.sqrt(d), dtype=x.dtype)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """−softplus(−x), softplus as logaddexp(x, 0) (`jax.nn.softplus`; F.
    softplus switches to the identity above its threshold)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel
# ---------------------------------------------------------------------------

def mlstm_chunked(q, k, v, log_i, log_f, chunk: int,
                  state: Optional[Tuple] = None):
    """q/k/v: (B, S, H, D); log_i/log_f: (B, S, H) f32 (log input/forget
    gate).

    Returns (h (B, S, H, D) f32, (C (B, H, D, D), n (B, H, D), m (B, H))).
    Stabilizer convention: true state = stored · exp(m).
    """
    bb, s_orig, h, d = q.shape
    cl = min(chunk, s_orig)
    # pad to a chunk multiple: log_i = NEG (no input), log_f = 0 (decay 1)
    pad = (-s_orig) % cl
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // cl
    q = _div_sqrt(q.reshape(bb, nc, cl, h, d), d)
    k = k.reshape(bb, nc, cl, h, d)
    v = v.reshape(bb, nc, cl, h, d)
    li = log_i.reshape(bb, nc, cl, h)
    lf = log_f.reshape(bb, nc, cl, h)
    cum_f = torch.cumsum(lf, dim=2)                     # inclusive
    total_f = cum_f[:, :, -1, :]                        # (B, nc, H)

    if state is None:
        c_st = torch.zeros((bb, h, d, d), dtype=torch.float32,
                           device=q.device)
        n_st = torch.zeros((bb, h, d), dtype=torch.float32, device=q.device)
        m_st = torch.full((bb, h), NEG, dtype=torch.float32, device=q.device)
    else:
        c_st, n_st, m_st = state

    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    hs = []
    for ci in range(nc):
        qc = q[:, ci].float()
        kc = k[:, ci].float()
        vc = v[:, ci].float()
        li_c, cumf_c, totf_c = li[:, ci], cum_f[:, ci], total_f[:, ci]
        wlog_c = (cumf_c[:, :, None, :] - cumf_c[:, None, :, :]
                  + li_c[:, None, :, :])                 # (B, Qi, Qj, H)
        wlog_c = torch.where(tri, wlog_c, NEG)
        wmax_c = wlog_c.amax(dim=2)                      # (B, Qi, H)
        glog_c = totf_c[:, None, :] - cumf_c + li_c      # (B, Q, H)
        gmax_c = glog_c.amax(dim=1)                      # (B, H)
        # per-query stabilizer: max(intra max, cum_f_i + m_prev)
        m_q = torch.maximum(wmax_c, cumf_c + m_st[:, None, :])
        w = torch.exp(wlog_c - m_q[:, :, None, :])
        inter_scale = torch.exp(cumf_c + m_st[:, None, :] - m_q)
        qk = torch.einsum("bihd,bjhd->bijh", qc, kc)
        num = torch.einsum("bijh,bjhd->bihd", w * qk, vc)
        num = num + inter_scale[..., None] * torch.einsum(
            "bihd,bhde->bihe", qc, c_st)
        den = torch.einsum("bijh,bijh->bih", w, qk) \
            + inter_scale * torch.einsum("bihd,bhd->bih", qc, n_st)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_q))[..., None])

        # state update to the end of the chunk
        m_new = torch.maximum(totf_c + m_st, gmax_c)    # (B, H)
        g = torch.exp(glog_c - m_new[:, None, :])        # (B, Q, H)
        carry_scale = torch.exp(totf_c + m_st - m_new)
        c_st = carry_scale[:, :, None, None] * c_st \
            + torch.einsum("bjh,bjhd,bjhe->bhde", g, kc, vc)
        n_st = carry_scale[:, :, None] * n_st \
            + torch.einsum("bjh,bjhd->bhd", g, kc)
        m_st = m_new
    h_out = torch.stack(hs, dim=1).reshape(bb, s, h, d)
    return h_out[:, :s_orig], (c_st, n_st, m_st)


def mlstm_step(q, k, v, log_i, log_f, state):
    """Single decode step. q/k/v: (B, H, D); log_i/log_f: (B, H)."""
    c_st, n_st, m_st = state
    d = q.shape[-1]
    q = _div_sqrt(q, d)
    m_new = torch.maximum(log_f + m_st, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m_st - m_new)
    c_new = f_s[..., None, None] * c_st \
        + i_s[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n_new = f_s[..., None] * n_st + i_s[..., None] * k
    # the reference promotes q to the state's f32 inside these dots
    num = torch.einsum("bhd,bhde->bhe", q.to(c_new.dtype), c_new)
    den = torch.einsum("bhd,bhd->bh", q.to(n_new.dtype), n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (c_new, n_new, m_new)


# ---------------------------------------------------------------------------
# mLSTM block (pre-up-projection ×2, conv4 → q/k)
# ---------------------------------------------------------------------------

def mlstm_block_init(generator: torch.Generator, cfg: ModelConfig,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    d = cfg.d_model
    di = cfg.expand * d
    nh = cfg.n_heads
    dt = cfg.param_dtype()

    def w(shape, scale=None):
        return dense_init(generator, shape, dt, scale, device=dev)
    return {
        "norm": torch.ones((d,), dtype=dt, device=dev),
        "mlstm_up": w((d, 2 * di)),
        "conv_w": w((cfg.d_conv, di)),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        # block-diagonal per-head projections (official xLSTM layout)
        "mlstm_q": w((nh, di // nh, di // nh)),
        "mlstm_k": w((nh, di // nh, di // nh)),
        "mlstm_v": w((nh, di // nh, di // nh)),
        "gate_if": w((di, 2 * nh)),
        "if_bias": torch.cat([torch.zeros((nh,)),
                              torch.linspace(3.0, 6.0, nh)]).to(
                                  dev, torch.float32),
        "skip": torch.ones((di,), dtype=dt, device=dev),
        "mlstm_norm": torch.ones((di,), dtype=dt, device=dev),
        "mlstm_down": w((di, d)),
    }


def _conv_causal(x, w, b, state=None):
    """Depthwise causal conv over S then SiLU. x: (B, S, C), w: (K, C);
    state: the last K − 1 inputs (B, K − 1, C) or None (zeros). Returns
    (y, new_state)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return F.silu(out + b[None, None, :]), new_state


def mlstm_block_apply(p, x, cfg: ModelConfig, state=None):
    """x: (B, S, d). state: {"conv", "cell": (C, n, m)} or None (no state
    returned)."""
    bb, s, d = x.shape
    di = cfg.expand * d
    nh = cfg.n_heads
    dh = di // nh
    h = rms_norm(x, p["norm"])
    up = h @ p["mlstm_up"]
    xm, gate = up[..., :di], up[..., di:]
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _conv_causal(xm, p["conv_w"], p["conv_b"], conv_state)
    xch = xc.reshape(bb, s, nh, dh)
    xmh = xm.reshape(bb, s, nh, dh)
    # streams stay in the model dtype; numerics are upcast per chunk inside
    # mlstm_chunked
    q = torch.einsum("bshd,hde->bshe", xch, p["mlstm_q"])
    k = torch.einsum("bshd,hde->bshe", xch, p["mlstm_k"])
    v = torch.einsum("bshd,hde->bshe", xmh, p["mlstm_v"])
    if_pre = (xc.float() @ p["gate_if"].float()) + p["if_bias"][None, None, :]
    log_i, f_pre = if_pre[..., :nh], if_pre[..., nh:]     # (B, S, H)
    log_f = _log_sigmoid(f_pre)

    cell_state = None if state is None else state["cell"]
    if state is not None and s == 1:
        hv, new_cell = mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                  log_f[:, 0], cell_state)
        hv = hv[:, None]
    else:
        hv, new_cell = mlstm_chunked(q, k, v, log_i, log_f, cfg.ssd_chunk,
                                     cell_state)
    hv = hv.reshape(bb, s, di).to(x.dtype)
    hv = rms_norm(hv + p["skip"][None, None, :] * xc, p["mlstm_norm"])
    out = (hv * F.silu(gate)) @ p["mlstm_down"]
    if state is None:
        return x + out, None
    return x + out, {"conv": new_conv, "cell": new_cell}


def mlstm_block_state(cfg: ModelConfig, batch: int,
                      device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    di = cfg.expand * cfg.d_model
    nh = cfg.n_heads
    dh = di // nh
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di),
                            dtype=cfg.param_dtype(), device=dev),
        "cell": (torch.zeros((batch, nh, dh, dh), **f32),
                 torch.zeros((batch, nh, dh), **f32),
                 torch.full((batch, nh), NEG, **f32)),
    }


# ---------------------------------------------------------------------------
# sLSTM block (recurrent; post-up-projection 4/3 gated FFN)
# ---------------------------------------------------------------------------

def slstm_block_init(generator: torch.Generator, cfg: ModelConfig,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    df = max(1, int(d * 4 / 3) // 16 * 16)
    dt = cfg.param_dtype()

    def w(shape, scale=None):
        return dense_init(generator, shape, dt, scale, device=dev)
    return {
        "norm": torch.ones((d,), dtype=dt, device=dev),
        "conv_w": w((cfg.d_conv, d)),
        "conv_b": torch.zeros((d,), dtype=dt, device=dev),
        # input weights for gates z, i, f, o
        "slstm_w": w((d, 4 * d)),
        # block-diagonal recurrent weights per head, per gate
        "slstm_r": w((4, nh, dh, dh), scale=0.3),
        "slstm_b": torch.cat([torch.zeros((2 * d,)), torch.ones((d,)),
                              torch.zeros((d,))]).to(dev, torch.float32),
        "gn": torch.ones((d,), dtype=dt, device=dev),
        "ffn_norm": torch.ones((d,), dtype=dt, device=dev),
        "w_gate": w((d, df)),
        "w_up": w((d, df)),
        "w_down": w((df, d)),
    }


def slstm_scan(p, xg: torch.Tensor, nh: int, state):
    """xg: (B, S, 4d) pre-activations from inputs. The recurrence over the
    whole sequence in one launch of the fused kernel (its plain version on
    a CPU tensor). Returns (hs (B, S, d) f32, (c, n, h, m))."""
    return slstm_fused(xg, p["slstm_r"], state, nh)


def slstm_block_apply(p, x, cfg: ModelConfig, state=None):
    bb, s, d = x.shape
    nh = cfg.n_heads
    h = rms_norm(x, p["norm"])
    conv_state = None if state is None else state["conv"]
    hc, new_conv = _conv_causal(h, p["conv_w"], p["conv_b"], conv_state)
    xg = hc @ p["slstm_w"] + p["slstm_b"][None, None, :].to(h.dtype)
    cell = (slstm_block_state(cfg, bb, x.device)["cell"] if state is None
            else state["cell"])
    hv, new_cell = slstm_scan(p, xg, nh, cell)
    hv = rms_norm(hv.to(x.dtype), p["gn"])
    y = x + hv
    f = rms_norm(y, p["ffn_norm"])
    f = F.silu(f @ p["w_gate"]) * (f @ p["w_up"])
    out = y + f @ p["w_down"]
    if state is None:
        return out, None
    return out, {"conv": new_conv, "cell": new_cell}


def slstm_block_state(cfg: ModelConfig, batch: int,
                      device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    d = cfg.d_model

    def z():
        return torch.zeros((batch, d), dtype=torch.float32, device=dev)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d),
                            dtype=cfg.param_dtype(), device=dev),
        "cell": (z(), z(), z(), torch.full((batch, d), NEG,
                                           dtype=torch.float32, device=dev)),
    }


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: ModelConfig,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Seeded random weights in the reference's tree: embed, the
    heterogeneous `blocks` list ({"slstm": …} at `cfg.slstm_at`, {"mlstm":
    …} elsewhere), final_norm, lm_head. Drawn on the generator's device."""
    dev = resolve_device(device)
    dt = cfg.param_dtype()
    blocks: List[Dict[str, Any]] = []
    for i in range(cfg.n_layers):
        if i in cfg.slstm_at:
            blocks.append({"slstm": slstm_block_init(generator, cfg, dev)})
        else:
            blocks.append({"mlstm": mlstm_block_init(generator, cfg, dev)})
    return {
        "embed": dense_init(generator, (cfg.vocab_padded, cfg.d_model), dt,
                            scale=1.0, device=dev),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": dense_init(generator, (cfg.d_model, cfg.vocab_padded), dt,
                              device=dev),
    }


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, states=None):
    """states=None → no state in or out (training form); else a list of
    per-block states (serving). Returns (logits (B, S, V_pad), states)."""
    h = params["embed"][tokens].to(cfg.param_dtype())
    new_states = []
    for i, bp in enumerate(params["blocks"]):
        st = None if states is None else states[i]
        if "slstm" in bp:
            h, ns = slstm_block_apply(bp["slstm"], h, cfg, st)
        else:
            h, ns = mlstm_block_apply(bp["mlstm"], h, cfg, st)
        new_states.append(ns)
    h = rms_norm(h, params["final_norm"])
    logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"])
    return logits, (None if states is None else new_states)


def init_states(cfg: ModelConfig, batch: int, device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    return [slstm_block_state(cfg, batch, dev) if i in cfg.slstm_at
            else mlstm_block_state(cfg, batch, dev)
            for i in range(cfg.n_layers)]


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """(ce, {"ce", "aux"}): next-token cross entropy, aux 0."""
    from .transformer import cross_entropy
    logits, _ = forward(params, batch["tokens"], cfg)
    ce = cross_entropy(logits[:, :-1, :], batch["labels"][:, 1:], cfg.vocab)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, states):
    """Full-sequence pass from ``states``. Returns (last_logits (B, V_pad),
    new_states)."""
    logits, new_states = forward(params, tokens, cfg, states)
    return logits[:, -1], new_states


def decode_step(params, token: torch.Tensor, pos, states, cfg: ModelConfig):
    """One decode step (the position is implicit in the recurrent state).
    Returns (logits (B, V_pad), new_states)."""
    logits, new_states = forward(params, token, cfg, states)
    return logits[:, 0], new_states
