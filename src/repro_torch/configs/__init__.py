"""Configurations the port runs: the paper's equalizer operating points
(equalizer_ht, equalizer_lp) and the LM architectures, by --arch id.

Port of `repro.configs`: the reference's ten architectures in its order,
each module the port's own copy of the reference's CONFIG and REDUCED.
`models.registry.build` builds all six families: the dense transformers,
llava-next-34b (the VLM prefix-LM, on the same transformer), the MoE ones
(mixtral-8x22b, moonshot-v1-16b-a3b), zamba2-1.2b (hybrid), xlstm-125m
(ssm) and whisper-large-v3 (encdec).
"""
from __future__ import annotations

import dataclasses

from . import (deepseek_7b, equalizer_ht, equalizer_lp, internlm2_1_8b,
               llava_next_34b, mixtral_8x22b, moonshot_v1_16b_a3b,
               qwen3_0_6b, smollm_135m, whisper_large_v3, xlstm_125m,
               zamba2_1_2b)
from .shapes import LONG_CONTEXT_ARCHS, SHAPES, ShapeSpec, long_500k_runnable

_MODULES = {
    "internlm2-1.8b": internlm2_1_8b,
    "deepseek-7b": deepseek_7b,
    "smollm-135m": smollm_135m,
    "qwen3-0.6b": qwen3_0_6b,
    "llava-next-34b": llava_next_34b,
    "mixtral-8x22b": mixtral_8x22b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "zamba2-1.2b": zamba2_1_2b,
    "xlstm-125m": xlstm_125m,
    "whisper-large-v3": whisper_large_v3,
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
