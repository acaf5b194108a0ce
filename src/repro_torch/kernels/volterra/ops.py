"""Run the Volterra kernel from core params (port of
`repro.kernels.volterra.ops`)."""
from __future__ import annotations

from typing import Dict

import torch

from ...core.volterra import VolterraConfig
from ...device import DeviceLike, as_float, resolve_device
from .ref import volterra as volterra_ref
from .volterra import volterra as volterra_kernel


def equalize(params: Dict[str, torch.Tensor], x, cfg: VolterraConfig,
             use_kernel: bool = True, tile: int = 128,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Deployment-path inference with the kernel's stream semantics (one
    common halo; `core.volterra.apply` pads each order on its own, with the
    same zeros, so the two differ by rounding only). x: (S·N_os,) or
    (B, S·N_os), moved to ``device`` with the params; a float32, bfloat16
    or float16 x keeps its type, which the result takes (anything else
    becomes float32); ``use_kernel=False`` runs the plain version there."""
    dev = resolve_device(device)
    x = as_float(x, dev)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    w = {k: as_float(v, dev) for k, v in params.items()}
    w2 = w.get("w2") if cfg.m2 > 0 else None
    w3 = w.get("w3") if cfg.m3 > 0 else None
    if use_kernel:
        y = volterra_kernel(x, w["w0"], w["w1"], w2, w3, stride=cfg.n_os,
                            tile=tile)
    else:
        y = volterra_ref(x, w["w0"], w["w1"], w2, w3, stride=cfg.n_os)
    return y[0] if squeeze else y


__all__ = ["equalize", "volterra_kernel", "volterra_ref"]
