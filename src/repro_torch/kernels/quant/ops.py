"""Quantize a trained equalizer's parameters (port of
`repro.kernels.quant.ops`)."""
from __future__ import annotations

from typing import Any, Dict

from ...device import DeviceLike, as_float32, resolve_device
from .quant import fixed_point_quantize as quantize_kernel
from .ref import fixed_point_quantize as quantize_ref


def quantize_params(params: Dict[str, Any], qparams: Dict[str, Any],
                    use_kernel: bool = True,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Quantize every layer's w and b with that layer's learned weight
    format (one launch per tensor, as the reference). Params and widths
    move to ``device``; ``use_kernel=False`` runs the plain version."""
    dev = resolve_device(device)
    fn = quantize_kernel if use_kernel else quantize_ref

    def on(v):
        return as_float32(v, dev)
    out: Dict[str, Any] = {"conv": []}
    for i, layer in enumerate(params["conv"]):
        q = qparams[f"layer{i}"]
        wi, wf = on(q["w_int"]), on(q["w_frac"])
        out["conv"].append({"w": fn(on(layer["w"]), wi, wf),
                            "b": fn(on(layer["b"]), wi, wf)})
    return out


__all__ = ["quantize_kernel", "quantize_params", "quantize_ref"]
