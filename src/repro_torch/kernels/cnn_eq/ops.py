"""Run the fused equalizer from core params.

`equalize` is the thin shim kept from the reference (quickstart, kernel
tests). New code builds a `repro_torch.core.engine.EqualizerEngine`, the
production inference path (backend selection, int8 deployment, autotuned
tiling).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ...core.equalizer import (CNNEqConfig, fold_bn, folded_weights,
                               layer_strides)
from ...device import DeviceLike
from .cnn_eq import cnn_eq_fused, cnn_eq_fused_int8, quantize_weights_int8
from .ref import cnn_eq as cnn_eq_ref

# canonical definitions live next to fold_bn (core/equalizer.py); these
# aliases keep the historical kernel-side names importable
strides_of = layer_strides
weights_of = folded_weights


def equalize(params: Dict[str, Any], bn_state, x, cfg: CNNEqConfig,
             use_kernel: bool = True, tile_m: int = 64,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Deployment-path inference: fold BN, run the fused fp32 kernel
    (or, with ``use_kernel=False``, the plain version)."""
    from ...core.engine import EqualizerEngine
    folded = fold_bn(params, bn_state, cfg)
    engine = EqualizerEngine.from_folded(
        folded, cfg, backend="fused_fp32" if use_kernel else "ref",
        tile_m=tile_m, device=device)
    return engine(x)


__all__ = ["cnn_eq_fused", "cnn_eq_fused_int8", "cnn_eq_ref", "equalize",
           "quantize_weights_int8", "strides_of", "weights_of"]
