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
local shards (`sharding.local_pair`), and `next_token_ce` is
vocab-parallel (`_VocabCE`: the logits stay split over ``model``). The
serving loops read their layers through `_unbind_layers`, so an int8
weight tree (`common.Int8Weight` leaves, `launch.steps.make_lowerable`
with ``cfg.serve_int8_weights``) is gathered and dequantized one layer at
a time.

Training (`forward`, `cross_entropy`, `loss_fn`): with ``cfg.remat`` each
layer body runs under `torch.utils.checkpoint` (non-reentrant), where the
reference wraps it in `jax.checkpoint`: its activations are dropped after
the forward and recomputed in the backward, so a fused-attention layer
launches the forward kernel twice per backward pass. The stacked layer
params are split with one `unbind` per leaf, so each leaf's gradient is
stacked once, not scattered into a zero (L, ...) tensor per layer. On
DTensor params each layer's view passes through `_LayerGrad`, whose
backward lays that layer's gradient out as the parameter's shard (a
Partial sum reduce-scattered, a replicated dim sliced) as soon as the
layer's backward has made it: the stack holds (L, local shard)
gradients, never whole ones, where the reference's GSPMD lays its scan's
gradient out from the params' shardings. Plain tensors get no such node.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..device import DeviceLike, resolve_device
from ..parallel import sharding
from . import attention, mlp
from .common import (Int8Weight, ModelConfig, dense_init, embed_lookup,
                     lm_logits, remat_run, rms_norm, stack_layers)

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
    """Layer i's params: views into the stacked (L, ...) tensors, a
    DTensor view that takes a gradient through `_LayerGrad`."""
    return {k: _layer(v, i) if isinstance(v, dict) else _layer_view(v[i])
            for k, v in stacked.items()}


def _layer_view(v):
    if isinstance(v, DTensor) and v.requires_grad and torch.is_grad_enabled():
        return _LayerGrad.apply(v)
    return v


class _LayerGrad(torch.autograd.Function):
    """The identity on one layer's view of a stacked DTensor leaf; its
    backward lays the layer's gradient out as the view is laid out (a
    Partial sum reduce-scattered, a replicated dim sliced), so that
    `unbind`'s backward stacks (L, local shard) gradients, never whole
    ones. The node is made when the layer is read, just before the
    layer's forward, so the autograd engine runs it as soon as the layer's
    backward is done."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


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

class _Layers(Sequence):
    """The n per-layer dicts of a stacked layer tree, each built when it is
    read (`_layer` on the leaves split once). Iterating over a tree with
    int8 leaves (`Int8Weight`) empties each layer's dict before the next
    layer's weights are dequantized, so one layer's are live at a time."""

    def __init__(self, parts: Dict[str, Any], n: int, lazy: bool):
        self.parts, self.n, self.lazy = parts, n, lazy

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, Any]:
        if not 0 <= i < self.n:
            raise IndexError(i)
        return _layer(self.parts, i)

    def __iter__(self):
        prev = None
        for i in range(self.n):
            if self.lazy and prev is not None:
                prev.clear()
            prev = self[i]
            yield prev


def _unbind_layers(stacked: Dict[str, Any], n: int) -> _Layers:
    """The stacked (L, ...) layer params as n per-layer dicts of views,
    one `unbind` per leaf; an int8 leaf (`Int8Weight`) is dequantized
    layer by layer as the dicts are read."""
    lazy = False

    def split(tree):
        nonlocal lazy
        if isinstance(tree, dict):
            return {k: split(v) for k, v in tree.items()}
        if isinstance(tree, Int8Weight):
            lazy = True
            return tree
        return tree.unbind(0)
    parts = split(stacked)
    return _Layers(parts, n, lazy)


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
    next-token loss over the positions from ``start`` (a vlm's text).

    On DTensor logits it is vocab-parallel, as the reference's GSPMD
    reduces its CE over ``model``: the logits stay laid out over batch
    and vocab, and each rank runs `_VocabCE` on its (B_l, S, V_pad /
    model) slice, with the row max, the sum of exponentials and the
    label's logit all-reduced over ``model``; the mean runs over the
    per-token losses laid out by rows. No rank holds another rank's rows
    or vocab columns, in the forward or the backward."""
    b, v = sharding.batch_head_entries(logits.shape[0], logits.shape[-1])
    pl = sharding.spec_placements
    tok = pl(b, None)
    group, rank = sharding.axis_group("model") if v else (None, 0)
    rows = slice(start, -1)
    return sharding.local_call(
        lambda lg, lb: _VocabCE.apply(lg, lb[:, 1:], vocab, rows, group,
                                      rank),
        (logits, labels), (pl(b, None, v), tok), tok).mean()


def _token_ce(logits: torch.Tensor, labels: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """Each token's CE in f32, (B, S), over the whole vocab."""
    return _VocabCE.apply(logits, labels, vocab, slice(None), None, 0)


def _masked_f32(lg: torch.Tensor, vocab: int, col0: int) -> torch.Tensor:
    """An f32 copy of the logits (..., n) that are vocab columns col0 ..
    col0 + n − 1, padded columns (≥ vocab) set to −1e30 (the reference's
    iota mask, by global column)."""
    lf = lg.to(torch.float32, copy=True)
    n = lf.shape[-1]
    if col0 + n > vocab:
        lf.masked_fill_(torch.arange(col0, col0 + n, device=lf.device)
                        >= vocab, -1e30)
    return lf


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` all-reduced with ``op`` over ``group`` (a functional
    collective), waited for (under `FakeTensorMode` it returns a plain
    fake tensor)."""
    from torch.distributed import _functional_collectives as fc
    out = fc.all_reduce(t, op, group)
    return out.wait() if isinstance(out, fc.AsyncCollectiveTensor) else out


class _VocabCE(torch.autograd.Function):
    """Each token's CE in f32 of ``logits[:, rows]`` (B, S, n), vocab
    columns rank·n .. rank·n + n − 1 of V_pad, against ``labels`` (B, S').

    With ``group`` (a mesh dim over which the vocab is split) the row max
    is all-reduced with MAX, Σ exp(lf − max) and the label's logit (taken
    on the rank whose slice holds it, 0 elsewhere) with SUM, through
    functional collectives; lse = log(Σ) + max, as `torch.logsumexp`
    takes it. Without one (no mesh, ``model`` of size 1, or the vocab
    whole on each rank) the same arithmetic runs with no collective. The
    backward, (exp(lf − lse) − onehot) · g, needs no collective: it
    recomputes lf from the saved logits (no f32 copy is kept) and comes
    back in the logits' own shape and type, zero outside ``rows``."""

    @staticmethod
    def forward(ctx, logits, labels, vocab, rows, group, rank):
        n = logits.shape[-1]
        col0 = rank * n
        lf = _masked_f32(logits[:, rows], vocab, col0)
        idx = labels.long() - col0
        hit = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)[..., None]
        picked = torch.where(hit, lf.gather(-1, idx)[..., 0], 0.0)
        m = lf.amax(-1)
        if group is not None:
            m = _all_reduce(m, "max", group)
        s = lf.sub_(m[..., None]).exp_().sum(-1)
        del lf
        if group is not None:
            s = _all_reduce(s, "sum", group)
            picked = _all_reduce(picked, "sum", group)
        lse = torch.log(s) + m
        ctx.save_for_backward(logits, lse, idx, hit)
        ctx.vocab, ctx.rows, ctx.col0 = vocab, rows, col0
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, hit = ctx.saved_tensors
        g = g.float()
        d = _masked_f32(logits[:, ctx.rows], ctx.vocab, ctx.col0)
        d.sub_(lse[..., None]).exp_().mul_(g[..., None])
        d.scatter_add_(-1, idx, torch.where(hit, -g, 0.0)[..., None])
        out = torch.zeros_like(logits)
        out[:, ctx.rows] = d
        return out, None, None, None, None, None


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
    for i, lp in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
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
    for i, lp in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
        x = rms_norm(h, lp["attn_norm"])
        q, k, v = attention.qkv(lp["attn"], x, cfg, positions)
        kk = _ring_write(ck[i], k, pos)
        vv = _ring_write(cv[i], v, pos)
        kk, vv = attention.repeat_kv(kk, vv, q.shape[2])
        o = attention._attend_dense(q, kk, vv, valid[None, None], scale)
        h = h + attention.out_proj(lp["attn"], o)
        h = h + _mlp(lp, rms_norm(h, lp["mlp_norm"]), cfg)[0]
    return _head(params, h)[:, 0], cache
