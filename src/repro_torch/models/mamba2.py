"""Mamba2 (SSD) block — chunkwise-parallel training, O(1)-state decode.

Port of `repro.models.mamba2`. The SSD recurrence per head (state
S ∈ R^{p×n}, scalar decay a_t = e^{Δ_t A}):

    S_t = a_t · S_{t-1} + Δ_t · x_t B_tᵀ          y_t = S_t C_t + D · x_t

A sequence runs in the chunked algorithm of the Mamba-2 paper: cut into
chunks of ``cfg.ssd_chunk``, within a chunk the recurrence expands to a
masked, decay-weighted attention-like product, and across chunks the
(B, H, P, N) state is carried. The reference computes each chunk's terms
inside its `lax.scan` step, so that one chunk's (B, Q, Q, H) decay matrix
lives at a time on the TPU. The port computes the terms that do not
depend on the carried state (the masked decay matrix, the intra-chunk
output, each chunk's contribution to the state and its decay) for all
chunks at once, and carries the state through a Python loop over the
chunks (two elementwise ops a chunk, as `models.xlstm.mlstm_chunked`
loops over its chunks); the inter-chunk output then reads the stacked
states in one product. The same sums as the reference's, in a few dozen
launches a layer instead of ~25 a chunk: on the card the loop's launches,
not the (B, S / Q, Q, Q, H) tensors, set the time. Decode carries
(conv_state, ssm_state), constant in the sequence length.

The reference puts `jax.checkpoint` on its chunk step, so that a backward
recomputes the intra-chunk tensors instead of saving them for every
chunk. The port does not: its trainer runs each mamba layer under
`torch.utils.checkpoint` (`models.zamba2.forward` with ``cfg.remat``), so a
backward holds one layer's chunk tensors at a time.

Where the frameworks differ, the port follows the reference:
  * softplus is `jax.nn.softplus`'s logaddexp(x, 0); `F.softplus` switches
    to the identity above 20, below an f32 ulp from it there, but keeping
    the reference's formula keeps the gradient's formula too;
  * the conv state stays in the param dtype and the SSM state in f32, as
    `init_state` makes them; the conv history is concatenated in x's type;
    where the reference casts to f32, the port upcasts (`common.upcast`):
    the same f32 for bf16 and f32, float64 kept in a float64 run;
  * the reference's `sharding.logical` layouts stand where it puts them
    (heads over ``model``, the block's output over the batch), no-ops
    without a mesh; on a mesh in_proj and out_proj multiply each rank's
    own rows by their ``ssm_inner`` columns / rows
    (`sharding.weight_products`), and the scan runs on local shards
    (`ssd_chunked`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..parallel import sharding
from .common import ModelConfig, dense_init, rms_norm, upcast
# the reference's mamba2 and xlstm each carry this depthwise causal conv
# (pad or state, a sum over taps, SiLU); the port keeps one copy
from .xlstm import _conv_causal as _causal_conv

NEG_INF = -1e30


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_p, conv_dim)."""
    d_inner = cfg.expand * cfg.d_model
    nh = d_inner // cfg.ssm_head
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, nh, cfg.ssm_head, conv_dim


def init(generator: torch.Generator, cfg: ModelConfig,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The reference's leaves: in_proj → [z, x, B, C, dt], the depthwise
    conv, A_log = log(linspace(1, 16, H)), dt_bias, D (f32), the gated
    norm and out_proj."""
    dev = resolve_device(device)
    d = cfg.d_model
    d_inner, nh, _, conv_dim = dims(cfg)
    n = cfg.ssm_state
    dt = cfg.param_dtype()
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(generator, (d, 2 * d_inner + 2 * n + nh), dt,
                              device=dev),
        "conv_w": dense_init(generator, (cfg.d_conv, conv_dim), dt,
                             device=dev),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "ssm_norm": torch.ones((d_inner,), dtype=dt, device=dev),
        "out_proj": dense_init(generator, (d_inner, d), dt, device=dev),
    }


def _split_proj(params, u: torch.Tensor, cfg: ModelConfig):
    """u (B, S, d) @ in_proj → (z, x, B, C, dt). On DTensors the product
    runs on each rank's own rows, its columns over ``model``
    (`sharding.weight_products`), gathered to be cut into the five."""
    d_inner, nh, _, _ = dims(cfg)
    n = cfg.ssm_state
    zxbcdt = sharding.weight_products(torch.matmul, u, (params["in_proj"],),
                                      ("cols",))
    return sharding.split_cols(zxbcdt, [d_inner, d_inner, n, n, nh])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x, dt, a_log, b, c, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """`_ssd_chunked`, on each rank's local rows and heads where x is a
    DTensor (the scan is independent per row and head; B and C are
    shared by the heads, so with the heads split their gradient is a
    partial sum over ``model``; A is shared by the rows, so with the rows
    split its gradient is a partial sum over the batch dims)."""
    bs, h = sharding.batch_head_entries(x.shape[0], x.shape[2])
    pl = sharding.spec_placements
    s4, s3, sbc, st = (pl(bs, None, h, None), pl(bs, None, h),
                       pl(bs, None, None), pl(bs, h, None, None))

    def call(x_, dt_, a_, b_, c_, *init):
        return _ssd_chunked(x_, dt_, a_, b_, c_, chunk,
                            init[0] if init else None)
    args = (x, dt, a_log, b, c) + (() if init_state is None
                                   else (init_state,))
    ins = (s4, s3, pl(h), sbc, sbc) + (() if init_state is None else (st,))
    from torch.distributed.tensor import Partial
    dbc = tuple(Partial() if h and a == "model" else p_ for a, p_ in zip(
        sharding.mesh_axes(sharding.get_mesh()), sbc))
    da = sharding.grad_partial(ins[2], bs or ())
    return sharding.local_call(call, args, ins, (s4, st),
                               ins[:2] + (da, dbc, dbc) + ins[5:])


def _ssd_chunked(x, dt, a_log, b, c, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B,S,H,P) f32, dt: (B,S,H) f32 (post-softplus), a_log = A (H,) < 0,
    b/c: (B,S,N) f32 (ngroups=1, shared over heads); float64 throughout in
    a float64 run (`common.upcast`).
    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    bb, s_orig, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s_orig)
    # pad to a chunk multiple: dt = 0 ⇒ decay 1, contribution 0 — a no-op
    # tail
    pad = (-s_orig) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // q
    xc = x.reshape(bb, nc, q, h, p)
    dtc = dt.reshape(bb, nc, q, h)
    bc = b.reshape(bb, nc, q, n)
    cc = c.reshape(bb, nc, q, n)
    log_a = dtc * a_log[None, None, None, :]                  # ≤ 0
    cum = torch.cumsum(log_a, dim=2)                          # inclusive
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]

    # the terms that do not depend on the carried state, for every chunk
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nc,Qi,Qj,H)
    # mask BEFORE exp: the j > i region has li > 0 (cum decreases), so
    # exp overflows there and its gradient would be inf·0 = NaN
    l_mat = torch.exp(torch.where(tri, li, NEG_INF))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    m = cb[..., None] * l_mat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,Q,H)
    contrib = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_end * dtc, bc,
                           xc)                                # (B,nc,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)

    # the recurrence across chunks: the state entering each chunk
    state = (torch.zeros((bb, h, p, n), dtype=x.dtype, device=x.device)
             if init_state is None else init_state.to(x.dtype))
    entering = []
    for j in range(nc):
        entering.append(state)
        state = chunk_decay[:, j, :, None, None] * state + contrib[:, j]
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", cc,
                           torch.stack(entering, dim=1), torch.exp(cum))
    y = (y_intra + y_inter).reshape(bb, s, h, p)
    return y[:, :s_orig], state


def apply(params, u: torch.Tensor, cfg: ModelConfig,
          state: Optional[Dict[str, torch.Tensor]] = None):
    """Full block: (B, S, d) → (B, S, d). state=None → training path
    (returns (out, None)).

    With ``state`` ({"conv": (B, k−1, C), "ssm": (B, H, P, N)}) an S > 1
    input runs the chunked scan from that state (prefill) and S = 1 takes
    the single-step recurrence (decode); both return the new state."""
    d_inner, nh, p, _ = dims(cfg)
    n = cfg.ssm_state
    z, x, b, c, dt = _split_proj(params, u, cfg)
    xbc = torch.cat([x, b, c], dim=-1)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    x, b, c = sharding.split_cols(xbc, [d_inner, n, n])

    dtf = _softplus(upcast(dt) + params["dt_bias"][None, None, :])
    a = -torch.exp(params["A_log"])
    xh = sharding.split_last(upcast(x), nh, p)
    xh = sharding.logical(xh, ("batch", None, "ssm_inner", None))

    if state is None or u.shape[1] > 1:
        init_state = None if state is None else state["ssm"]
        y, final = ssd_chunked(xh, dtf, a, upcast(b), upcast(c),
                               cfg.ssd_chunk, init_state)
    else:
        # decode: one recurrence step
        s_prev = state["ssm"].to(xh.dtype)                    # (B,H,P,N)
        da = torch.exp(dtf[:, 0, :] * a[None, :])             # (B,H)
        dbx = torch.einsum("bh,bn,bhp->bhpn", dtf[:, 0, :],
                           upcast(b[:, 0, :]), xh[:, 0])
        final = da[:, :, None, None] * s_prev + dbx
        y = torch.einsum("bhpn,bn->bhp", final,
                         upcast(c[:, 0, :]))[:, None]
    y = y + params["D"][None, None, :, None] * xh
    y = sharding.merge_last(y).to(u.dtype)

    y = rms_norm(y * F.silu(z), params["ssm_norm"])
    out = sharding.weight_products(torch.matmul, y, (params["out_proj"],),
                                   ("rows",))
    out = sharding.logical(out, ("batch", None, None))
    if state is None:
        return out, None
    return out, {"conv": new_conv, "ssm": final}


def init_state(cfg: ModelConfig, batch: int,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Zero conv history (B, d_conv − 1, conv_dim) in the param dtype and
    SSM state (B, H, P, N) in f32 (float64 in a float64 model)."""
    dev = resolve_device(device)
    _, nh, p, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim),
                            dtype=cfg.param_dtype(), device=dev),
        "ssm": torch.zeros((batch, nh, p, cfg.ssm_state),
                           dtype=torch.promote_types(cfg.param_dtype(),
                                                     torch.float32),
                           device=dev),
    }
