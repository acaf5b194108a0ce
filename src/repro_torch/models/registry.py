"""Uniform model interface over the architecture families.

Port of `repro.models.registry`. `build(cfg)` returns a `Model` whose
methods are what the launchers call: `loss_fn` for training, prefill and
decode for serving. The dense and moe families (`transformer`) and the ssm
family (`xlstm`) are ported; the others raise NotImplementedError naming
their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..device import DeviceLike
from . import transformer, xlstm
from .common import ModelConfig

# family → (what it is, its ROADMAP Queue 1 item)
_NOT_PORTED = {
    "vlm": ("VLM prefix-LM (llava)", 1),
    "hybrid": ("zamba2 hybrid", 2),
    "encdec": ("whisper encoder-decoder", 3),
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]              # (generator, device) → params
    loss_fn: Callable[..., Any]           # (params, batch) → (loss, aux)
    init_serve_state: Callable[..., Any]  # (batch, max_len, device) → state
    prefill: Callable[..., Any]           # (params, batch, state) → (logits, state)
    decode: Callable[..., Any]            # (params, token, pos, state) → (logits, state)


def _transformer_model(cfg: ModelConfig) -> Model:
    def init(generator, device: DeviceLike = "cuda"):
        return transformer.init(generator, cfg, device)

    def loss_fn(params, batch):
        return transformer.loss_fn(params, batch, cfg)

    def init_serve_state(batch: int, max_len: int,
                         device: DeviceLike = "cuda"):
        return transformer.init_cache(cfg, batch, max_len, device)

    def prefill(params, batch, state):
        return transformer.prefill(params, batch["tokens"], cfg, state,
                                   embed_prefix=batch.get("embed_prefix"))

    def decode(params, token, pos, state):
        return transformer.decode_step(params, token, pos, state, cfg)

    return Model(cfg=cfg, init=init, loss_fn=loss_fn,
                 init_serve_state=init_serve_state,
                 prefill=prefill, decode=decode)


def _xlstm_model(cfg: ModelConfig) -> Model:
    def init(generator, device: DeviceLike = "cuda"):
        return xlstm.init(generator, cfg, device)

    def loss_fn(params, batch):
        return xlstm.loss_fn(params, batch, cfg)

    def init_serve_state(batch: int, max_len: int,
                         device: DeviceLike = "cuda"):
        return xlstm.init_states(cfg, batch, device)

    def prefill(params, batch, state):
        return xlstm.prefill(params, batch["tokens"], cfg, state)

    def decode(params, token, pos, state):
        return xlstm.decode_step(params, token, pos, state, cfg)

    return Model(cfg=cfg, init=init, loss_fn=loss_fn,
                 init_serve_state=init_serve_state,
                 prefill=prefill, decode=decode)


_FAMILIES = {"dense": _transformer_model, "moe": _transformer_model,
             "ssm": _xlstm_model}


def build(cfg: ModelConfig) -> Model:
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family](cfg)
    if cfg.family in _NOT_PORTED:
        what, item = _NOT_PORTED[cfg.family]
        raise NotImplementedError(
            f"family {cfg.family!r} ({what}) is not ported yet (ROADMAP "
            f"Queue 1 item {item})")
    raise ValueError(f"unknown family {cfg.family!r}")
