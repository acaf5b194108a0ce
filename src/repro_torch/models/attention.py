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

Where the reference returns new cache arrays, `self_attention` writes the
caller's cache tensors in place and returns them. `cross_attention`
(decoder to encoder, whisper) and bidirectional encoder attention take the
plain `attend_full`, as the reference does: it never sends them to its
kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

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
    return k.index_select(2, idx)


def qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → q (B,S,Hq,D), k/v (B,S,KVeff,D) — rope'd, normed."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, _expand_kv(k, cfg), _expand_kv(v, cfg)


def _attend_dense(q, k, v, mask, scale):
    s = upcast(torch.einsum("bqhd,bkhd->bhqk", q, k)) * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class _FusedCausal(torch.autograd.Function):
    """Flash attention with its backward in the flash kernels (port of the
    reference's `_fused_causal` custom VJP). The forward saves q, k, v, o
    and lse; q_offset, window and q_chunk get no gradient (the reference's
    ``nondiff_argnums``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, window: int, q_chunk: int):
        o, lse = flash_attention_fwd(q, k, v, causal=True, window=window,
                                     q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.q_offset, ctx.window = q_offset, window
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        if g.stride(-1) != 1 or not rows_aligned(g):
            g = g.clone(memory_format=torch.contiguous_format)   # 16-byte rows
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, causal=True,
                                         window=ctx.window,
                                         q_offset=ctx.q_offset)
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
        return flash_attention(q, k, v, causal=True, window=window,
                               q_offset=q_offset)
    return _attend_causal_xla(q, k, v, q_offset, window, q_chunk)


def _attend_causal_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_offset: Offset = 0, window: int = 0,
                       q_chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, chunked over queries.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) with Hq % Hkv == 0.
    q_offset: absolute position of q[0] relative to k[0] (prefill: 0).
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(d)
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
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
    """Bidirectional attention (encoder / cross)."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    mask = torch.ones((1, 1, q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    return _attend_dense(q, k, v, mask, scale)


def out_proj(params, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])


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
    cache["k"][:, start:start + sq] = k.to(cache["k"].dtype)
    cache["v"][:, start:start + sq] = v.to(cache["v"].dtype)
    if sq == 1:
        # decode: attend to cache[0:cache_pos+1] via position masking
        kk, vv = cache["k"], cache["v"]
        sk = kk.shape[1]
        rep = q.shape[2] // kk.shape[2]
        if rep > 1:
            kk = kk.repeat_interleave(rep, dim=2)
            vv = vv.repeat_interleave(rep, dim=2)
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
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
    if cached_kv is None:
        k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"])
        v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"])
        if cfg.qk_norm:
            k = rms_norm(k, params["k_norm"])
        k = _expand_kv(k, cfg)
        v = _expand_kv(v, cfg)
    else:
        k, v = cached_kv
    o = attend_full(q, k, v)
    return out_proj(params, o), (k, v)
