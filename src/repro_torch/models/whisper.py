"""Whisper-large-v3 backbone: encoder–decoder transformer (arXiv:2212.04356).

Port of `repro.models.whisper`. The conv/mel frontend is a stub, as in the
reference: the caller provides frame embeddings (B, enc_len, d_model)
standing in for the log-mel → conv1d×2 downsampling. Pre-RMSNorm blocks,
a GELU MLP (the tanh approximation, `mlp.apply`), sinusoidal positions
(`common.sinusoidal_positions`; ``rope_theta = 0`` disables RoPE in
`attention.qkv`).

Attention: the encoder's self-attention and the decoder's cross-attention
are bidirectional and take the plain `attention.attend_full`, as the
reference does. The decoder's causal self-attention takes the flash
kernels where the reference takes its fused path: `attend_causal` in
prefill (the serving kernel) and `attention.self_attention` in
`decode_train` (`_FusedCausal` under a gradient). With ``cfg.remat`` and
grad enabled, every encoder and decoder layer runs under
`torch.utils.checkpoint` (non-reentrant), where the reference wraps its
scan body in `jax.checkpoint`.

Serving: the state holds a self-attention KV ring cache per decoder layer
and each layer's cross-attention K/V over the encoder output, which
prefill computes once and decode reads (never recomputing them from the
encoder). Where the reference returns new state arrays, the port writes
the state's tensors in place. Decode adds the position table's row
min(pos, W − 1), W the cache width, as the reference clamps it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..parallel import sharding
from . import attention, mlp
from .common import (ModelConfig, dense_init, embed_lookup, lm_logits,
                     remat_run, rms_norm, sinusoidal_positions, stack_layers)
from .transformer import _ring_write, _unbind_layers, next_token_ce


def init_enc_layer(generator: torch.Generator, cfg: ModelConfig,
                   device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    dt = cfg.param_dtype()
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "attn": attention.init(generator, cfg, device=dev),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "mlp": mlp.init(generator, cfg, device=dev),
    }


def init_dec_layer(generator: torch.Generator, cfg: ModelConfig,
                   device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    dt = cfg.param_dtype()
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "attn": attention.init(generator, cfg, device=dev),
        "xattn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "xattn": attention.init(generator, cfg, device=dev),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "mlp": mlp.init(generator, cfg, device=dev),
    }


def init(generator: torch.Generator, cfg: ModelConfig,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Seeded random weights in the reference's tree: the stacked encoder
    layers, enc_norm, embed, the stacked decoder layers, final_norm and
    lm_head. Drawn on the generator's device."""
    dev = resolve_device(device)
    dt = cfg.param_dtype()
    enc = [init_enc_layer(generator, cfg, dev)
           for _ in range(cfg.enc_layers)]
    dec = [init_dec_layer(generator, cfg, dev) for _ in range(cfg.n_layers)]
    return {
        "enc_layers": stack_layers(enc),
        "enc_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "embed": dense_init(generator, (cfg.vocab_padded, cfg.d_model), dt,
                            scale=1.0, device=dev),
        "dec_layers": stack_layers(dec),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": dense_init(generator, (cfg.d_model, cfg.vocab_padded), dt,
                              device=dev),
    }


def _enc_body(h, lp, cfg, positions):
    x = rms_norm(h, lp["attn_norm"])
    a, _ = attention.self_attention(lp["attn"], x, cfg, positions,
                                    causal=False)
    h = h + a
    return h + mlp.apply(lp["mlp"], rms_norm(h, lp["mlp_norm"]), cfg)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, enc_len, d) stub embeddings → encoder output."""
    dt = cfg.param_dtype()
    pos = sinusoidal_positions(frames.shape[1], cfg.d_model, frames.device)
    h = frames.to(dt) + pos[None].to(dt)
    h = sharding.logical(h, ("batch", None, None))
    positions = torch.arange(h.shape[1], device=h.device)
    run = remat_run(cfg.remat)
    for lp in _unbind_layers(params["enc_layers"], cfg.enc_layers):
        h = run(_enc_body, h, lp, cfg, positions)
    return rms_norm(h, params["enc_norm"])


def _embed(params, tokens: torch.Tensor, pos_rows: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    h = embed_lookup(params["embed"], tokens).to(cfg.param_dtype())
    return h + pos_rows[None].to(h.dtype)


def _dec_body(h, lp, enc_out, cfg, positions):
    a, _ = attention.self_attention(
        lp["attn"], rms_norm(h, lp["attn_norm"]), cfg, positions,
        q_chunk=cfg.q_chunk)
    h = h + a
    x, _ = attention.cross_attention(
        lp["xattn"], rms_norm(h, lp["xattn_norm"]), enc_out, cfg)
    h = h + x
    return h + mlp.apply(lp["mlp"], rms_norm(h, lp["mlp_norm"]), cfg)


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder over tokens (B, S) → logits (B, S, V_pad)."""
    h = _embed(params, tokens, sinusoidal_positions(
        tokens.shape[1], cfg.d_model, tokens.device), cfg)
    h = sharding.logical(h, ("batch", None, None))
    positions = torch.arange(h.shape[1], device=h.device)
    run = remat_run(cfg.remat)
    for lp in _unbind_layers(params["dec_layers"], cfg.n_layers):
        h = run(_dec_body, h, lp, enc_out, cfg, positions)
    return _head(params, h)


def _head(params, h: torch.Tensor) -> torch.Tensor:
    """Final norm, LM head, logits laid out over batch and vocab."""
    h = rms_norm(h, params["final_norm"])
    logits = lm_logits(h, params["lm_head"])
    return sharding.logical(logits, ("batch", None, "vocab"))


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """batch: tokens, labels (B, S), enc_embed (B, enc_len, d) → (ce,
    {"ce", "aux"}), aux 0."""
    enc_out = encode(params, batch["enc_embed"], cfg)
    logits = decode_train(params, batch["tokens"], enc_out, cfg)
    ce = next_token_ce(logits, batch["labels"], cfg.vocab)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Zero self-attention caches k, v (L, B, max_len, kv_eff, hd) and
    cross-attention K/V xk, xv (L, B, enc_len, kv_eff, hd)."""
    dev = resolve_device(device)
    _, kv_eff = sharding.resolve_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    dt = cfg.param_dtype()

    def z(n):
        return torch.zeros((cfg.n_layers, batch, n, kv_eff, cfg.head_dim),
                           dtype=dt, device=dev)
    return {"k": z(max_len), "v": z(max_len), "xk": z(cfg.enc_len),
            "xv": z(cfg.enc_len)}


def prefill(params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, state: Dict[str, Any]):
    """Encoder pass + decoder prefill, filling ``state`` in place (frames
    (B, enc_len, d)). Returns (last_logits (B, V_pad), state)."""
    enc_out = encode(params, frames, cfg)
    h = _embed(params, tokens, sinusoidal_positions(
        tokens.shape[1], cfg.d_model, tokens.device), cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    for i, lp in enumerate(_unbind_layers(params["dec_layers"],
                                          cfg.n_layers)):
        x = rms_norm(h, lp["attn_norm"])
        q, k, v = attention.qkv(lp["attn"], x, cfg, positions)
        _ring_write(state["k"][i], k, 0)
        _ring_write(state["v"][i], v, 0)
        o = attention.attend_causal(q, k, v, 0, 0, cfg.q_chunk,
                                    fused=cfg.fused_attention)
        h = h + attention.out_proj(lp["attn"], o)
        xo, (xk, xv) = attention.cross_attention(
            lp["xattn"], rms_norm(h, lp["xattn_norm"]), enc_out, cfg)
        for name, new in (("xk", xk), ("xv", xv)):
            buf, vals = sharding.local_pair(state[name][i], new)
            buf.copy_(vals)
        h = h + xo
        h = h + mlp.apply(lp["mlp"], rms_norm(h, lp["mlp_norm"]), cfg)
    return _head(params, h[:, -1:, :])[:, 0], state


def decode_step(params, token: torch.Tensor, pos, state: Dict[str, Any],
                cfg: ModelConfig):
    """One decode step at absolute position ``pos``: the self-attention
    cache written in place, cross-attention over the state's xk / xv.
    Returns (logits (B, V_pad), state)."""
    w = state["k"].shape[2]
    row = sinusoidal_positions(w, cfg.d_model, token.device)[
        min(int(pos), w - 1)]
    h = _embed(params, token, row[None], cfg)
    positions = torch.full((1,), int(pos), dtype=torch.int32,
                           device=h.device)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    slot = torch.arange(w, device=h.device)[None, :]
    valid = ((pos - slot) % w) <= pos
    for i, lp in enumerate(_unbind_layers(params["dec_layers"],
                                          cfg.n_layers)):
        x = rms_norm(h, lp["attn_norm"])
        q, k, v = attention.qkv(lp["attn"], x, cfg, positions)
        kk = _ring_write(state["k"][i], k, pos)
        vv = _ring_write(state["v"][i], v, pos)
        kk, vv = attention.repeat_kv(kk, vv, q.shape[2])
        o = attention._attend_dense(q, kk, vv, valid[None, None], scale)
        h = h + attention.out_proj(lp["attn"], o)
        xo, _ = attention.cross_attention(
            lp["xattn"], rms_norm(h, lp["xattn_norm"]), None, cfg,
            cached_kv=(state["xk"][i], state["xv"][i]))
        h = h + xo
        h = h + mlp.apply(lp["mlp"], rms_norm(h, lp["mlp_norm"]), cfg)
    return _head(params, h)[:, 0], state
