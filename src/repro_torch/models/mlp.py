"""Dense MLPs (SwiGLU / GELU).

Port of the dense half of `repro.models.mlp`; the MoE layer comes with the
MoE family (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .common import ModelConfig, dense_init


def init(generator: torch.Generator, cfg: ModelConfig,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype()
    if cfg.mlp_act == "silu":
        return {"w_gate": dense_init(generator, (d, f), dt, device=dev),
                "w_up": dense_init(generator, (d, f), dt, device=dev),
                "w_down": dense_init(generator, (f, d), dt, device=dev)}
    return {"w_in": dense_init(generator, (d, f), dt, device=dev),
            "w_out": dense_init(generator, (f, d), dt, device=dev)}


def apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_act == "silu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ params["w_in"], approximate="tanh") @ params["w_out"]
