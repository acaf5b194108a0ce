"""Zamba2-style hybrid: a Mamba2 backbone with a SHARED attention block
applied every ``cfg.attn_every`` layers (arXiv:2411.15242).

Port of `repro.models.zamba2`. One set of attention + MLP weights is reused
at every application point (`attn_points`); the published model's per-use
LoRA adapters are omitted, as in the reference.

Training (`forward`): the reference scans contiguous runs of mamba layers
under `jax.checkpoint` with the shared block checkpointed between runs;
the port loops over the layers and, with ``cfg.remat`` and grad enabled,
runs each mamba layer and each application of the shared block under
`torch.utils.checkpoint` (non-reentrant), as `models.transformer` does.
The shared block's attention takes its gradient through the flash kernels
when ``cfg.fused_attention`` is set (`attention._FusedCausal`: the forward
with lse, then the dK/dV and dQ kernels); the same weights are applied at
every point, so their gradient is the sum over the applications, and under
remat each application launches the forward kernel twice a backward pass.

Serving (`prefill`, `decode_step`): the mamba layers carry their (conv,
ssm) states, and each application of the shared block has its own ring
KV cache of width min(max_len, window) (``decode_window`` or ``window``,
else max_len). Where the reference re-stacks the states and caches, the
port writes them in place: each layer's state slice and each application's
cache view (`transformer._ring_write`). Prefill attention goes through
`attention.attend_causal(..., fused=cfg.fused_attention)` with a window of
``decode_window or window`` or the cache width; decode attends over the
ring with the dense `_attend_dense` and an age mask, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..parallel import sharding
from . import attention, mamba2, mlp
from .common import (ModelConfig, dense_init, embed_lookup, lm_logits,
                     remat_run, rms_norm, stack_layers)
from .transformer import (_layer, _ring_write, _unbind_layers,
                          next_token_ce)


def attn_points(cfg: ModelConfig) -> List[int]:
    """Layer indices AFTER which the shared block is applied."""
    if cfg.attn_every <= 0:
        return []
    return [i for i in range(cfg.n_layers) if (i + 1) % cfg.attn_every == 0]


def init(generator: torch.Generator, cfg: ModelConfig,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Seeded random weights in the reference's tree: embed, the stacked
    mamba layers ({"norm", "mamba"}), the shared block, final_norm and
    lm_head. Drawn on the generator's device."""
    dev = resolve_device(device)
    dt = cfg.param_dtype()
    layers = [{"norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
               "mamba": mamba2.init(generator, cfg, dev)}
              for _ in range(cfg.n_layers)]
    shared = {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "attn": attention.init(generator, cfg, device=dev),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "mlp": mlp.init(generator, cfg, device=dev),
    }
    return {
        "embed": dense_init(generator, (cfg.vocab_padded, cfg.d_model), dt,
                            scale=1.0, device=dev),
        "layers": stack_layers(layers),
        "shared": shared,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": dense_init(generator, (cfg.d_model, cfg.vocab_padded), dt,
                              device=dev),
    }


def _mamba_layer(lp, h, cfg, state):
    y, new_state = mamba2.apply(lp["mamba"], rms_norm(h, lp["norm"]), cfg,
                                state)
    return h + y, new_state


def _mamba_body(h, lp, cfg):
    return _mamba_layer(lp, h, cfg, None)[0]


def _shared_block(sp, h, cfg, positions):
    """The shared attention + MLP block, training form (no cache)."""
    a, _ = attention.self_attention(
        sp["attn"], rms_norm(h, sp["attn_norm"]), cfg, positions,
        q_chunk=cfg.q_chunk)
    h = h + a
    return h + mlp.apply(sp["mlp"], rms_norm(h, sp["mlp_norm"]), cfg)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training path: tokens (B, S) → logits (B, S, V_pad). Each mamba
    layer and each application of the shared block is rematerialized in
    the backward when ``cfg.remat`` (grad enabled; no random numbers
    drawn, so no RNG state is kept)."""
    h = embed_lookup(params["embed"], tokens).to(cfg.param_dtype())
    h = sharding.logical(h, ("batch", None, None))
    positions = torch.arange(h.shape[1], device=h.device)
    points = set(attn_points(cfg))
    run = remat_run(cfg.remat)
    for i, lp in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
        h = run(_mamba_body, h, lp, cfg)
        if i in points:
            h = run(_shared_block, params["shared"], h, cfg, positions)
    h = rms_norm(h, params["final_norm"])
    logits = lm_logits(h, params["lm_head"])
    return sharding.logical(logits, ("batch", None, "vocab"))


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """(ce, {"ce", "aux"}): next-token cross entropy, aux 0."""
    logits = forward(params, batch["tokens"], cfg)
    ce = next_token_ce(logits, batch["labels"], cfg.vocab)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Mamba states (stacked over layers) + per-application attention ring
    caches (n_apps, B, W, kv_eff, hd), W = min(max_len, decode_window or
    window), else max_len."""
    dev = resolve_device(device)
    n_apps = len(attn_points(cfg))
    _, kv_eff = sharding.resolve_heads(cfg.n_heads, cfg.n_kv_heads, cfg.tp)
    win = cfg.decode_window or cfg.window
    w = min(max_len, win) if win > 0 else max_len
    shape = (n_apps, batch, w, kv_eff, cfg.head_dim)
    dt = cfg.param_dtype()
    return {
        "mamba": stack_layers([mamba2.init_state(cfg, batch, dev)
                               for _ in range(cfg.n_layers)]),
        "attn": {"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev)},
    }


def _serve_pass(params, tokens: torch.Tensor, pos, state,
                cfg: ModelConfig):
    """Shared serve path: prefill (S ≥ 1, pos = 0) or decode (S = 1,
    pos = t). Writes ``state`` in place and returns (last_logits, state)."""
    h = embed_lookup(params["embed"], tokens).to(cfg.param_dtype())
    s = h.shape[1]
    decode = s == 1
    positions = (torch.full((1,), int(pos), dtype=torch.int32,
                            device=h.device) if decode
                 else torch.arange(s, device=h.device))
    points = set(attn_points(cfg))
    ck_all, cv_all = state["attn"]["k"], state["attn"]["v"]
    w = ck_all.shape[2]
    win = cfg.decode_window or cfg.window or w
    scale = 1.0 / np.sqrt(cfg.head_dim)
    if decode:
        slot = torch.arange(w, device=h.device)[None, :]
        age = (pos - slot) % w
        valid = (age <= pos) & (age < win)
    sp = params["shared"]
    mamba_st = state["mamba"]
    app = 0
    for i in range(cfg.n_layers):
        h, ns = _mamba_layer(_layer(params["layers"], i), h, cfg,
                             _layer(mamba_st, i))
        for key in ("conv", "ssm"):
            buf, new = sharding.local_pair(mamba_st[key][i], ns[key])
            buf.copy_(new)
        if i not in points:
            continue
        x = rms_norm(h, sp["attn_norm"])
        q, k, v = attention.qkv(sp["attn"], x, cfg, positions)
        ck = _ring_write(ck_all[app], k, pos)
        cv = _ring_write(cv_all[app], v, pos)
        if decode:
            kk, vv = ck, cv
            kk, vv = attention.repeat_kv(kk, vv, q.shape[2])
            o = attention._attend_dense(q, kk, vv, valid[None, None], scale)
        else:
            o = attention.attend_causal(q, k, v, 0, win, cfg.q_chunk,
                                        fused=cfg.fused_attention)
        h = h + attention.out_proj(sp["attn"], o)
        h = h + mlp.apply(sp["mlp"], rms_norm(h, sp["mlp_norm"]), cfg)
        app += 1
    h = rms_norm(h[:, -1:, :], params["final_norm"])
    logits = lm_logits(h, params["lm_head"])
    return sharding.logical(logits, ("batch", None, "vocab"))[:, 0], state


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, state):
    """Full-sequence pass from ``state`` (written in place). Returns
    (last_logits (B, V_pad), state)."""
    return _serve_pass(params, tokens, 0, state, cfg)


def decode_step(params, token: torch.Tensor, pos, state, cfg: ModelConfig):
    """One decode step at absolute position ``pos`` (state written in
    place). Returns (logits (B, V_pad), state)."""
    return _serve_pass(params, token, pos, state, cfg)
