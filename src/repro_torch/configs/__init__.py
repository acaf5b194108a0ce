"""Configurations the port runs: the paper's equalizer operating points
(equalizer_ht, equalizer_lp) and the LM architectures, by --arch id.

Port of `repro.configs`. `ARCHS` lists only the architectures the port
builds (`models.registry.build`): the dense transformers, the MoE ones
(mixtral-8x22b, moonshot-v1-16b-a3b) and xlstm-125m (family "ssm"); the
other families of the reference come with ROADMAP Queue 1 items 1 (VLM),
2 (hybrid) and 3 (encdec).
"""
from __future__ import annotations

import dataclasses

from . import (deepseek_7b, equalizer_ht, equalizer_lp, internlm2_1_8b,
               mixtral_8x22b, moonshot_v1_16b_a3b, qwen3_0_6b, smollm_135m,
               xlstm_125m)
from .shapes import LONG_CONTEXT_ARCHS, SHAPES, ShapeSpec, long_500k_runnable

_MODULES = {
    "internlm2-1.8b": internlm2_1_8b,
    "deepseek-7b": deepseek_7b,
    "smollm-135m": smollm_135m,
    "qwen3-0.6b": qwen3_0_6b,
    "mixtral-8x22b": mixtral_8x22b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "xlstm-125m": xlstm_125m,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False, **overrides):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; choose from {ARCHS}")
    cfg = _MODULES[arch].REDUCED if reduced else _MODULES[arch].CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["ARCHS", "LONG_CONTEXT_ARCHS", "SHAPES", "ShapeSpec",
           "equalizer_ht", "equalizer_lp", "get_config",
           "long_500k_runnable"]
