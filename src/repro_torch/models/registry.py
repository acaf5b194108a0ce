"""Uniform model interface over the architecture families.

Port of `repro.models.registry`. Every architecture reduces to one of six
families:

    dense / moe / vlm  → models.transformer   (llava = prefix-LM stub)
    hybrid             → models.zamba2
    ssm                → models.xlstm
    encdec             → models.whisper

`build(cfg)` returns a `Model` whose methods are what the launchers call:
`loss_fn` for training, prefill and decode for serving. The families
differ in their batch (a vlm prefill reads ``embed_prefix``, an encdec
one ``enc_embed``, both made by `stub_inputs`) and in what their serve
state is (KV ring caches, SSM
states, or both). An unknown family raises ValueError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..interop import tree_leaves
from . import transformer, whisper, xlstm, zamba2
from .common import ModelConfig


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


def _zamba2_model(cfg: ModelConfig) -> Model:
    def init(generator, device: DeviceLike = "cuda"):
        return zamba2.init(generator, cfg, device)

    def loss_fn(params, batch):
        return zamba2.loss_fn(params, batch, cfg)

    def init_serve_state(batch: int, max_len: int,
                         device: DeviceLike = "cuda"):
        return zamba2.init_state(cfg, batch, max_len, device)

    def prefill(params, batch, state):
        return zamba2.prefill(params, batch["tokens"], cfg, state)

    def decode(params, token, pos, state):
        return zamba2.decode_step(params, token, pos, state, cfg)

    return Model(cfg=cfg, init=init, loss_fn=loss_fn,
                 init_serve_state=init_serve_state,
                 prefill=prefill, decode=decode)


def _whisper_model(cfg: ModelConfig) -> Model:
    def init(generator, device: DeviceLike = "cuda"):
        return whisper.init(generator, cfg, device)

    def loss_fn(params, batch):
        return whisper.loss_fn(params, batch, cfg)

    def init_serve_state(batch: int, max_len: int,
                         device: DeviceLike = "cuda"):
        return whisper.init_state(cfg, batch, max_len, device)

    def prefill(params, batch, state):
        return whisper.prefill(params, batch["tokens"], batch["enc_embed"],
                               cfg, state)

    def decode(params, token, pos, state):
        return whisper.decode_step(params, token, pos, state, cfg)

    return Model(cfg=cfg, init=init, loss_fn=loss_fn,
                 init_serve_state=init_serve_state,
                 prefill=prefill, decode=decode)


_FAMILIES = {
    "dense": _transformer_model,
    "moe": _transformer_model,
    "vlm": _transformer_model,
    "hybrid": _zamba2_model,
    "ssm": _xlstm_model,
    "encdec": _whisper_model,
}


def build(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg)


def param_count(params: Any) -> int:
    """The number of parameters: elements summed over every leaf."""
    return sum(t.numel() for t in tree_leaves(params))


def stub_inputs(cfg: ModelConfig, lead: Tuple[int, ...],
                device: DeviceLike = "cuda",
                make: Optional[Callable[[Tuple[int, ...]], torch.Tensor]]
                = None) -> Dict[str, torch.Tensor]:
    """The family's input beside the tokens, standing in for the frontends
    the reference stubs: a vlm's image prefix ``embed_prefix`` (*lead,
    img_tokens, d_model), an encdec model's frame embeddings
    ``enc_embed`` (*lead, enc_len, d_model); nothing for the other
    families. ``make(shape)`` builds the tensor; by default zeros in the
    param dtype on ``device``, as the reference's CLI and pipeline build
    them."""
    extra = {"vlm": ("embed_prefix", cfg.img_tokens),
             "encdec": ("enc_embed", cfg.enc_len)}.get(cfg.family)
    if extra is None:
        return {}
    if make is None:
        dev = resolve_device(device)

        def make(shape):
            return torch.zeros(shape, dtype=cfg.param_dtype(), device=dev)
    key, n = extra
    return {key: make(tuple(lead) + (n, cfg.d_model))}
