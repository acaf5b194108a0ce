"""Decoder-only transformer stack: the dense GQA, MoE and VLM families.

Port of `repro.models.transformer` for the dense, MoE and VLM families:
pre-RMSNorm blocks, RoPE, GQA attention (`models.attention`), a SwiGLU or
GELU MLP or, where ``cfg.n_experts`` > 0, the MoE layer (`models.mlp`;
its aux loss is summed over the layers and `loss_fn` adds 1e-2 of it),
the training forward and loss, and the ring-buffer KV cache of capacity
min(max_len, window). Covers internlm2, deepseek, smollm, qwen3, mixtral
and moonshot, and llava (family "vlm"): a prefix-LM whose stubbed vision
tower's patch embeddings (``embed_prefix``, (B, img_tokens, d)) are
prepended to the token embeddings, so text positions start after the
prefix in prefill and decode alike, and `loss_fn` covers only the text.

Where the reference scans over the stacked layer params, the port loops
over them in Python (eager PyTorch: one layer's ops at a time), and where
it threads the stacked caches through the scan as a carry, the port
writes each layer's cache slice in place (`_ring_write` on the layer's
view), so the (L, B, W, kv, hd) caches are never copied. Prefill attention
goes through the flash kernel when ``cfg.fused_attention`` is set; decode
attends over the cache with the dense `_attend_dense`, as the reference
does (it left decode to XLA).

Sharded: the reference's `sharding.logical` layouts (the embedded stream
over the batch, logits over batch and vocab) are applied where it applies
them, no-ops without a mesh; `shard_cache` lays a stacked cache out as
(None, batch, None, heads, None); a DTensor cache is written through its
local shards (`sharding.local_pair`), and `next_token_ce` takes each
rank's rows whole.

Training (`forward`, `cross_entropy`, `loss_fn`): with ``cfg.remat`` each
layer body runs under `torch.utils.checkpoint` (non-reentrant), where the
reference wraps it in `jax.checkpoint`: its activations are dropped after
the forward and recomputed in the backward, so a fused-attention layer
launches the forward kernel twice per backward pass. The stacked layer
params are split with one `unbind` per leaf, so each leaf's gradient is
stacked once, not scattered into a zero (L, ...) tensor per layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..parallel import sharding
from . import attention, mlp
from .common import (ModelConfig, dense_init, embed_lookup, lm_logits,
                     remat_run, rms_norm, stack_layers)

Pos = Union[int, torch.Tensor]


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.n_experts > 0


def _mlp(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig):
    """The block's MLP on the normed stream: (y, aux), aux 0 unless MoE."""
    if _is_moe(cfg):
        return mlp.moe_apply(lp["mlp"], x, cfg)
    return mlp.apply(lp["mlp"], x, cfg), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _layer(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i's params: views into the stacked (L, ...) tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, cfg: ModelConfig,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    dt = cfg.param_dtype()
    init_mlp = mlp.moe_init if _is_moe(cfg) else mlp.init
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "attn": attention.init(generator, cfg, device=dev),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "mlp": init_mlp(generator, cfg, device=dev),
    }


def init(generator: torch.Generator, cfg: ModelConfig,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Seeded random weights in the reference's tree: embed, stacked
    layers, final_norm, lm_head. Drawn on the generator's device."""
    dev = resolve_device(device)
    dt = cfg.param_dtype()
    layers = [init_layer(generator, cfg, dev) for _ in range(cfg.n_layers)]
    return {
        "embed": dense_init(generator, (cfg.vocab_padded, cfg.d_model), dt,
                            scale=1.0, device=dev),
        "layers": stack_layers(layers),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": dense_init(generator, (cfg.d_model, cfg.vocab_padded), dt,
                              device=dev),
    }


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def layer_apply(lp: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_pos: Optional[int] = None):
    """One transformer block. Returns (h, cache, aux_loss)."""
    a, new_cache = attention.self_attention(
        lp["attn"], rms_norm(h, lp["attn_norm"]), cfg, positions,
        cache=cache, cache_pos=cache_pos, q_chunk=cfg.q_chunk)
    h = h + a
    m, aux = _mlp(lp, rms_norm(h, lp["mlp_norm"]), cfg)
    return h + m, new_cache, aux


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 embed_prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = embed_lookup(params["embed"], tokens).to(cfg.param_dtype())
    if embed_prefix is not None:
        h = torch.cat([embed_prefix.to(h.dtype), h], dim=1)
    return sharding.logical(h, ("batch", None, None))


def _head(params, h: torch.Tensor) -> torch.Tensor:
    """Final norm, LM head, logits laid out over batch and vocab."""
    h = rms_norm(h, params["final_norm"])
    logits = lm_logits(h, params["lm_head"])
    return sharding.logical(logits, ("batch", None, "vocab"))


# ---------------------------------------------------------------------------
# forward (train / eval, no cache)
# ---------------------------------------------------------------------------

def _unbind_layers(stacked: Dict[str, Any], n: int) -> list:
    """The stacked (L, ...) layer params as n per-layer dicts of views,
    one `unbind` per leaf."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: p[i] for k, p in parts.items()} for i in range(n)]
        return tree.unbind(0)
    return split(stacked)


def _body(h: torch.Tensor, lp: Dict[str, Any], cfg: ModelConfig,
          positions: torch.Tensor):
    h, _, aux = layer_apply(lp, h, cfg, positions)
    return h, aux


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            embed_prefix: Optional[torch.Tensor] = None):
    """tokens: (B, S_txt) [+ prefix (B, P, d)] → (logits (B, S, V_pad),
    aux). Layers are rematerialized in the backward when ``cfg.remat``
    (the body draws no random numbers, so no RNG state is kept)."""
    h = embed_tokens(params, tokens, cfg, embed_prefix)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    run = remat_run(cfg.remat)
    for lp in _unbind_layers(params["layers"], cfg.n_layers):
        h, a = run(_body, h, lp, cfg, positions)
        aux = aux + a
    return _head(params, h), aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean CE in f32 over (B, S); padded vocab entries masked to −1e30
    before the logsumexp. The reference picks the label's logit as
    sum(where(iota == label, lf, 0)), which equals lf[label] exactly; a
    gather takes the same value without a (B, S, V) index tensor."""
    return _token_ce(logits, labels, vocab).mean()


def next_token_ce(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                  start: int = 0) -> torch.Tensor:
    """`cross_entropy(logits[:, start:-1], labels[:, 1:], vocab)`: the
    next-token loss over the positions from ``start`` (a vlm's text). On
    DTensor logits each rank takes its own rows whole (the vocab gathered
    over ``model``), slicing them locally, and the mean runs over the
    per-token losses laid out by rows: no rank ever holds another rank's
    rows, in the forward or the backward (DTensor's own strategies for the
    slice, the logsumexp and their backwards run them on the whole batch
    on every rank)."""
    b, _ = sharding.batch_head_entries(logits.shape[0])
    rows = sharding.spec_placements(b, None, None)
    tok = sharding.spec_placements(b, None)
    return sharding.local_call(
        lambda lg, lb: _token_ce(lg[:, start:-1, :], lb[:, 1:], vocab),
        (logits, labels), (rows, tok), tok).mean()


def _token_ce(logits: torch.Tensor, labels: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """Each token's CE in f32, (B, S)."""
    lf = logits.float()
    v_pad = lf.shape[-1]
    if v_pad > vocab:
        pad = torch.arange(v_pad, device=lf.device) >= vocab
        lf = lf.masked_fill(pad, -1e30)
    lse = torch.logsumexp(lf, dim=-1)                         # (B, S)
    picked = lf.gather(-1, labels[..., None].long())[..., 0]
    return lse - picked


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """batch: tokens (B, S), labels (B, S) [, embed_prefix (B, P, d)] →
    (ce + 1e-2 · aux, {"ce", "aux"}). With a prefix, the loss covers only
    the text positions."""
    prefix = batch.get("embed_prefix")
    logits, aux = forward(params, batch["tokens"], cfg, embed_prefix=prefix)
    ce = next_token_ce(logits, batch["labels"], cfg.vocab,
                       0 if prefix is None else prefix.shape[1])
    return ce + 1e-2 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: ring-buffer KV cache, prefill + decode
# ---------------------------------------------------------------------------

def cache_capacity(cfg: ModelConfig, max_len: int) -> int:
    win = cfg.window or cfg.decode_window
    return min(max_len, win) if win > 0 else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Stacked (L, B, W, kv_eff, hd) ring-buffer caches."""
    _, kv_eff = sharding.resolve_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    w = cache_capacity(cfg, max_len)
    shape = (cfg.n_layers, batch, w, kv_eff, cfg.head_dim)
    dt = cfg.param_dtype()
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def shard_cache(cache, mesh=None):
    """Each stacked (L, B, W, kv, hd) cache leaf laid out as (None, batch,
    None, heads, None) on the current mesh (`sharding.logical`: a no-op
    without a mesh or on a plain tensor). ``mesh`` is unused, as in the
    reference."""
    from ..interop import tree_map
    return tree_map(lambda a: sharding.logical(
        a, (None, "batch", None, "heads", None)), cache)


def _ring_write(buf: torch.Tensor, vals: torch.Tensor,
                pos: Pos) -> torch.Tensor:
    """Write vals (B, S, H, D) at ring slots [(pos) % W ...] of buf
    (B, W, H, D), in place (the reference returns a new buffer); a DTensor
    buf through its local shard."""
    out = buf
    buf, vals = sharding.local_pair(buf, vals)
    w = buf.shape[1]
    s = vals.shape[1]
    vals = vals.to(buf.dtype)
    if s == 1:
        buf[:, pos % w] = vals[:, 0]
    elif s >= w:
        # whole buffer replaced: keep the LAST w entries, rotated so that
        # abs position p lands at slot p % w
        start = max(int(pos) + s - w, 0)
        buf.copy_(torch.roll(vals[:, -w:], start % w, dims=1))
    else:
        start = max(int(pos) + s - w, 0)
        slots = (start + torch.arange(s, device=buf.device)) % w
        buf[:, slots] = vals
    return out


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            cache: Dict[str, torch.Tensor],
            embed_prefix: Optional[torch.Tensor] = None):
    """Full-sequence pass filling the cache (in place). Returns
    (last_logits (B, V_pad), cache)."""
    h = embed_tokens(params, tokens, cfg, embed_prefix)
    positions = torch.arange(h.shape[1], device=h.device)
    ck, cv = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x = rms_norm(h, lp["attn_norm"])
        q, k, v = attention.qkv(lp["attn"], x, cfg, positions)
        o = attention.attend_causal(q, k, v, 0, cfg.window, cfg.q_chunk,
                                    fused=cfg.fused_attention)
        h = h + attention.out_proj(lp["attn"], o)
        h = h + _mlp(lp, rms_norm(h, lp["mlp_norm"]), cfg)[0]
        _ring_write(ck[i], k, 0)
        _ring_write(cv[i], v, 0)
    return _head(params, h[:, -1:, :])[:, 0], cache


def decode_step(params, token: torch.Tensor, pos: Pos,
                cache: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One decode step. token: (B, 1) ints, pos: absolute position.

    Cache slots hold absolute positions p ≡ slot (mod W); the validity mask
    is age-based so the same code serves full caches and ring buffers. The
    cache is written in place."""
    h = embed_tokens(params, token, cfg)
    positions = torch.full((1,), int(pos), dtype=torch.int32,
                           device=h.device)
    ck, cv = cache["k"], cache["v"]
    w = ck.shape[2]
    scale = 1.0 / np.sqrt(cfg.head_dim)
    win = cfg.window or cfg.decode_window or w
    slot = torch.arange(w, device=h.device)[None, :]
    age = (pos - slot) % w                               # 0 .. w-1
    valid = (age <= pos) & (age < win)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x = rms_norm(h, lp["attn_norm"])
        q, k, v = attention.qkv(lp["attn"], x, cfg, positions)
        kk = _ring_write(ck[i], k, pos)
        vv = _ring_write(cv[i], v, pos)
        kk, vv = attention.repeat_kv(kk, vv, q.shape[2])
        o = attention._attend_dense(q, kk, vv, valid[None, None], scale)
        h = h + attention.out_proj(lp["attn"], o)
        h = h + _mlp(lp, rms_norm(h, lp["mlp_norm"]), cfg)[0]
    return _head(params, h)[:, 0], cache
