"""GQA attention with qk-norm, RoPE, sliding windows, KV caching.

Port of `repro.models.attention`. TP policy (`parallel.sharding.
resolve_heads`): Q heads padded to the TP degree; KV heads either kept or
EXPANDED to per-Q-head replicas (on one card, tp = 1: neither happens).

Two causal paths, chosen as the reference chooses them
(`attend_causal`):
  * fused — an int ``q_offset`` and more than one query: the hand-written
    CUDA flash-attention kernels (`kernels.flash_attn`), which read the kv
    heads in place (GQA by index). Where a gradient is wanted (grad mode on
    and q, k or v requiring grad) it is `_FusedCausal`, the reference's
    `custom_vjp` `_fused_causal`: the forward kernel with lse, then the
    dK/dV and dQ kernels. Otherwise (serving prefill) it is the plain
    forward kernel `flash_attention`, whose output has no gradient;
  * plain — `_attend_causal_xla`: scores materialized per Q-CHUNK of
    ``q_chunk`` rows, the K/V band sliced per chunk for sliding windows
    (the reference's XLA-level path, here plain PyTorch).

Sharded. Where q, k and v are DTensors (a step built by
`launch.steps.make_lowerable`), the kernels run on each rank's local shard
through `torch.distributed.tensor.experimental.local_map`, batch over the
mesh's batch dims and heads over ``model`` wherever they divide: the
counterparts of the reference's shard_map wrappers `_flash_sharded`,
`_flash_fwd_lse_sharded` and `_flash_bwd_sharded`, which `_FusedCausal`
and the serving path call. A DTensor never reaches a kernel wrapper (a
wrapper would read its `data_ptr()` of 0 as a null pointer, and its
launchers refuse it). `qkv` and `out_proj` carry the reference's
`sharding.logical` layouts (no-ops without a mesh).

Where the reference returns new cache arrays, `self_attention` writes the
caller's cache tensors in place and returns them (a DTensor cache through
its local shard, `sharding.local_pair`). `cross_attention`
(decoder to encoder, whisper) and bidirectional encoder attention take the
plain `attend_full`, as the reference does: it never sends them to its
kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..device import DeviceLike, resolve_device
from ..kernels.flash_attn import (flash_attention, flash_attention_bwd,
                                  flash_attention_fwd, rows_aligned)
from ..parallel import sharding
from .common import ModelConfig, dense_init, rms_norm, rope, upcast

NEG_INF = -1e30

Offset = Union[int, torch.Tensor]


def init(generator: torch.Generator, cfg: ModelConfig,
         d_out: Optional[int] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Attention parameters. Logical KV heads = cfg.n_kv_heads."""
    dev = resolve_device(device)
    d = cfg.d_model
    dh = cfg.head_dim
    hq_pad, _ = sharding.resolve_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    dt = cfg.param_dtype()
    p = {
        "wq": dense_init(generator, (d, hq_pad, dh), dt, device=dev),
        "wk": dense_init(generator, (d, cfg.n_kv_heads, dh), dt, device=dev),
        "wv": dense_init(generator, (d, cfg.n_kv_heads, dh), dt, device=dev),
        "wo": dense_init(generator, (hq_pad, dh, d_out or d), dt,
                         scale=1.0 / np.sqrt(hq_pad * dh), device=dev),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((dh,), dtype=dt, device=dev)
    return p


def _expand_kv(k: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, n_kv, D) → (B, S, kv_eff, D) per resolve_heads policy."""
    hq, kv_eff = sharding.resolve_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    if kv_eff == cfg.n_kv_heads:
        return k
    idx = torch.from_numpy(sharding.kv_head_map(
        cfg.n_heads, cfg.n_kv_heads, hq, kv_eff)).long().to(k.device)
    # on a DTensor each rank expands its rows' heads whole (its backward,
    # an index_add, has no DTensor rule on every torch)
    b, _ = sharding.batch_head_entries(k.shape[0])
    rows = sharding.spec_placements(b, None, None, None)
    return sharding.local_call(lambda t: t.index_select(2, idx), (k,),
                               (rows,), rows)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) · w (d, H, K) → (B, S, H, K). On DTensors each rank
    multiplies its rows by its heads of the whole-d weight (the FSDP dim
    gathered first), so no unevenly split head dim is ever reshaped."""
    b, h = sharding.batch_head_entries(x.shape[0], w.shape[1])
    pl = sharding.spec_placements
    xs, ws = pl(b, None, None), pl(None, h, None)
    b_dims = b or ()
    return sharding.local_call(
        lambda x_, w_: torch.einsum("bsd,dhk->bshk", x_, w_), (x, w),
        (xs, ws), pl(b, None, h, None),
        (sharding.grad_partial(xs, ("model",) if h else ()),
         sharding.grad_partial(ws, b_dims)))


def merge_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, K) · w (H, K, d) → (B, S, d). On DTensors each rank
    contracts its heads: the result is a partial sum over ``model``."""
    b, h = sharding.batch_head_entries(o.shape[0], w.shape[0], o.shape[2])
    pl = sharding.spec_placements
    os_, ws = pl(b, None, h, None), pl(h, None, None)
    b_dims = b or ()
    return sharding.local_call(
        lambda o_, w_: torch.einsum("bshk,hkd->bsd", o_, w_), (o, w),
        (os_, ws),
        sharding.grad_partial(pl(b, None, None), ("model",) if h else ()),
        (os_, sharding.grad_partial(ws, b_dims)))


def qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → q (B,S,Hq,D), k/v (B,S,KVeff,D) — rope'd, normed."""
    q = project_heads(x, params["wq"])
    k = project_heads(x, params["wk"])
    v = project_heads(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    k = _expand_kv(k, cfg)
    v = _expand_kv(v, cfg)
    heads = ("batch", None, "heads", None)
    return (sharding.logical(q, heads), sharding.logical(k, heads),
            sharding.logical(v, heads))


def repeat_kv(k: torch.Tensor, v: torch.Tensor, hq: int):
    """k, v (B, S, Hkv, D) with each kv head repeated for its group of the
    hq query heads. A DTensor pair passes as it is: `_attend_dense`
    repeats each rank's local heads."""
    rep = hq // k.shape[2]
    if rep == 1 or isinstance(k, DTensor):
        return k, v
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def _attend_dense(q, k, v, mask, scale):
    """Masked softmax attention, q (B, Sq, H, D), k/v (B, Sk, Hkv, D),
    mask broadcast to (B, H, Sq, Sk); on each rank's local rows and heads
    where q or k is a DTensor (each (row, head) is independent)."""
    b, h = sharding.batch_head_entries(q.shape[0], q.shape[2], k.shape[2])
    s4 = sharding.spec_placements(b, None, h, None)
    rep = sharding.spec_placements(*(None,) * mask.dim())
    return sharding.local_call(
        lambda q_, k_, v_, m_: _attend_dense_local(q_, k_, v_, m_, scale),
        (q, k, v, mask), (s4, s4, s4, rep), s4)


def _attend_dense_local(q, k, v, mask, scale):
    k, v = repeat_kv(k, v, q.shape[2])
    s = upcast(torch.einsum("bqhd,bkhd->bhqk", q, k)) * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _kernel_specs(q: torch.Tensor, k: torch.Tensor):
    """The kernels' local layouts on the current mesh, as the reference's
    shard_map ``in_specs``: ((B, S, H, D) placements, (B, S, H)
    placements), batch over the batch dims and heads over ``model`` where
    each divides (q's heads and k's both, for heads)."""
    b, h = sharding.batch_head_entries(q.shape[0], q.shape[2], k.shape[2])
    return (sharding.spec_placements(b, None, h, None),
            sharding.spec_placements(b, None, h))


def _flash_sharded(q, k, v, window: int, q_offset: int):
    """The serving kernel (`flash_attention`), on local shards where q is a
    DTensor (the reference's `_flash_sharded`)."""
    def call(q_, k_, v_):
        return flash_attention(q_, k_, v_, causal=True, window=window,
                               q_offset=q_offset)
    s4, _ = _kernel_specs(q, k)
    return sharding.local_call(call, (q, k, v), (s4, s4, s4), s4)


def _flash_fwd_lse_sharded(q, k, v, window: int, q_offset: int):
    """The training forward (`flash_attention_fwd`: o and lse), on local
    shards where q is a DTensor (the reference's
    `_flash_fwd_lse_sharded`)."""
    def call(q_, k_, v_):
        return flash_attention_fwd(q_, k_, v_, causal=True, window=window,
                                   q_offset=q_offset)
    s4, s3 = _kernel_specs(q, k)
    return sharding.local_call(call, (q, k, v), (s4, s4, s4), (s4, s3))


def _flash_bwd_sharded(q, k, v, o, lse, g, window: int, q_offset: int):
    """The backward kernels (`flash_attention_bwd`: dq, dk, dv), on local
    shards where q is a DTensor (the reference's `_flash_bwd_sharded`).
    An unaligned cotangent is copied first: the kernels take 16-byte
    rows."""
    def call(q_, k_, v_, o_, lse_, g_):
        if g_.stride(-1) != 1 or (type(g_) is torch.Tensor
                                  and not rows_aligned(g_)):
            g_ = g_.clone(memory_format=torch.contiguous_format)
        return flash_attention_bwd(q_, k_, v_, o_, lse_, g_, causal=True,
                                   window=window, q_offset=q_offset)
    s4, s3 = _kernel_specs(q, k)
    return sharding.local_call(call, (q, k, v, o, lse, g),
                               (s4, s4, s4, s4, s3, s4), (s4, s4, s4))


class _FusedCausal(torch.autograd.Function):
    """Flash attention with its backward in the flash kernels (port of the
    reference's `custom_vjp` `_fused_causal`): forward
    `_flash_fwd_lse_sharded`, backward `_flash_bwd_sharded`, on local
    shards where the inputs are DTensors. The forward saves q, k, v, o
    and lse; q_offset, window and q_chunk get no gradient (the reference's
    ``nondiff_argnums``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, window: int, q_chunk: int):
        o, lse = _flash_fwd_lse_sharded(q, k, v, window, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.q_offset, ctx.window = q_offset, window
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_sharded(q, k, v, o, lse, g, ctx.window,
                                        ctx.q_offset)
        return dq, dk, dv, None, None, None


def attend_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: Offset = 0, window: int = 0,
                  q_chunk: int = 1024, fused: bool = False) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, q (B, Sq, Hq, D),
    k/v (B, Sk, Hkv, D). ``fused`` takes the flash kernels where the
    reference does: an int q_offset and more than one query; with a
    gradient wanted through `_FusedCausal`, else the serving forward."""
    if fused and isinstance(q_offset, int) and q.shape[1] > 1:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FusedCausal.apply(q, k, v, q_offset, window, q_chunk)
        return _flash_sharded(q, k, v, window, q_offset)
    return _attend_causal_xla(q, k, v, q_offset, window, q_chunk)


def _attend_causal_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_offset: Offset = 0, window: int = 0,
                       q_chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, chunked over queries.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) with Hq % Hkv == 0.
    q_offset: absolute position of q[0] relative to k[0] (prefill: 0).
    On DTensors the whole chunk loop runs on each rank's local rows and
    heads (one `local_map`, not one a chunk).
    """
    b, h = sharding.batch_head_entries(q.shape[0], q.shape[2], k.shape[2])
    s4 = sharding.spec_placements(b, None, h, None)
    return sharding.local_call(
        lambda q_, k_, v_: _attend_causal_local(q_, k_, v_, q_offset,
                                                window, q_chunk),
        (q, k, v), (s4, s4, s4), s4)


def _attend_causal_local(q, k, v, q_offset, window, q_chunk):
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / np.sqrt(d)
    k, v = repeat_kv(k, v, hq)
    ar_k = torch.arange(sk, device=q.device)

    if sq <= q_chunk:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = ar_k[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask = mask & (kpos > qpos - window)
        return _attend_dense(q, k, v, mask[None, None], scale)

    if sq % q_chunk:
        raise ValueError(f"q_chunk ({q_chunk}) must divide the sequence "
                         f"({sq})")
    outs = []
    for i in range(sq // q_chunk):
        qs = q_offset + i * q_chunk
        qc = q[:, i * q_chunk:(i + 1) * q_chunk]
        qpos = qs + torch.arange(q_chunk, device=q.device)[:, None]
        if 0 < window < sk:
            # only the K/V band [qs - window + 1, qs + q_chunk) can attend
            band = min(q_chunk + window, sk)
            start = int(min(max(qs - window + 1, 0), sk - band))
            kc, vc = k[:, start:start + band], v[:, start:start + band]
            kpos = start + torch.arange(band, device=q.device)[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window)
            outs.append(_attend_dense(qc, kc, vc, mask[None, None], scale))
            continue
        kpos = ar_k[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask = mask & (kpos > qpos - window)
        outs.append(_attend_dense(qc, k, v, mask[None, None], scale))
    return torch.cat(outs, dim=1)


def attend_full(q, k, v):
    """Bidirectional attention (encoder / cross); on each rank's local rows
    and heads where q or k is a DTensor."""
    b, h = sharding.batch_head_entries(q.shape[0], q.shape[2], k.shape[2])
    s4 = sharding.spec_placements(b, None, h, None)
    return sharding.local_call(_attend_full_local, (q, k, v), (s4, s4, s4),
                               s4)


def _attend_full_local(q, k, v):
    scale = 1.0 / np.sqrt(q.shape[-1])
    k, v = repeat_kv(k, v, q.shape[2])
    mask = torch.ones((1, 1, q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    return _attend_dense(q, k, v, mask, scale)


def out_proj(params, o: torch.Tensor) -> torch.Tensor:
    y = merge_heads(o, params["wo"])
    return sharding.logical(y, ("batch", None, None))


# ---------------------------------------------------------------------------
# Full layers with cache plumbing
# ---------------------------------------------------------------------------

def self_attention(params, x, cfg: ModelConfig, positions,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cache_pos: Optional[int] = None,
                   causal: bool = True, q_chunk: int = 1024):
    """Returns (out, cache).

    Modes:
      train/eval: cache=None → full pass.
      prefill:    cache=zeros, cache_pos=0 → fills cache[0:S].
      decode:     x is (B,1,d), cache_pos = current length → one step.
    The cache's k and v are written in place (at cache_pos, clamped so the
    S new entries fit, as the reference's dynamic_update_slice does).
    """
    q, k, v = qkv(params, x, cfg, positions)
    if cache is None:
        o = (attend_causal(q, k, v, 0, cfg.window, q_chunk,
                           fused=cfg.fused_attention) if causal
             else attend_full(q, k, v))
        return out_proj(params, o), None

    sq = x.shape[1]
    start = min(max(int(cache_pos), 0), cache["k"].shape[1] - sq)
    for name, new in (("k", k), ("v", v)):
        buf, vals = sharding.local_pair(cache[name], new)
        buf[:, start:start + sq] = vals.to(buf.dtype)
    if sq == 1:
        # decode: attend to cache[0:cache_pos+1] via position masking
        kk, vv = cache["k"], cache["v"]
        sk = kk.shape[1]
        kk, vv = repeat_kv(kk, vv, q.shape[2])
        kpos = torch.arange(sk, device=x.device)[None, :]
        mask = kpos <= cache_pos
        if cfg.window > 0:
            mask = mask & (kpos > cache_pos - cfg.window)
        o = _attend_dense(q, kk, vv, mask[None, None],
                          1.0 / np.sqrt(q.shape[-1]))
    else:
        o = attend_causal(q, k, v, cache_pos, cfg.window, q_chunk)
    return out_proj(params, o), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Zero (B, max_len, kv_eff, head_dim) k and v caches."""
    _, kv_eff = sharding.resolve_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    shape = (batch, max_len, kv_eff, cfg.head_dim)
    dt = dtype or cfg.param_dtype()
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def cross_attention(params, x, enc_out, cfg: ModelConfig,
                    cached_kv: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None):
    """Decoder→encoder attention; the encoder's K/V can be precomputed at
    prefill (``cached_kv``). Returns (out, (k, v))."""
    q = project_heads(x, params["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
    if cached_kv is None:
        k = project_heads(enc_out, params["wk"])
        v = project_heads(enc_out, params["wv"])
        if cfg.qk_norm:
            k = rms_norm(k, params["k_norm"])
        k = _expand_kv(k, cfg)
        v = _expand_kv(v, cfg)
    else:
        k, v = cached_kv
    o = attend_full(q, k, v)
    return out_proj(params, o), (k, v)
