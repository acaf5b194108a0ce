"""Quantize a trained equalizer's parameters (port of
`repro.kernels.quant.ops`)."""
from __future__ import annotations

from typing import Any, Dict

from ...device import DeviceLike, as_float, as_float32, resolve_device
from .quant import fixed_point_quantize as quantize_kernel
from .quant import fixed_point_quantize_many as quantize_many_kernel
from .ref import fixed_point_quantize as quantize_ref
from .ref import fixed_point_quantize_many as quantize_many_ref


def quantize_params(params: Dict[str, Any], qparams: Dict[str, Any],
                    use_kernel: bool = True,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Quantize every layer's w and b with that layer's learned weight
    format: every tensor in one call of `fixed_point_quantize_many` (one
    launch on the card; the reference launches once per tensor). Params
    and widths move to ``device``; a float32, bfloat16 or float16 tensor
    keeps its type (anything else becomes float32), the widths become
    float32; ``use_kernel=False`` runs the plain version."""
    dev = resolve_device(device)
    xs, widths = [], []
    for i, layer in enumerate(params["conv"]):
        q = qparams[f"layer{i}"]
        wi, wf = as_float32(q["w_int"], dev), as_float32(q["w_frac"], dev)
        xs += [as_float(layer["w"], dev), as_float(layer["b"], dev)]
        widths += [(wi, wf)] * 2
    fn = quantize_many_kernel if use_kernel else quantize_many_ref
    ys = fn(xs, widths)
    return {"conv": [{"w": ys[2 * i], "b": ys[2 * i + 1]}
                     for i in range(len(params["conv"]))]}


__all__ = ["quantize_kernel", "quantize_many_kernel", "quantize_params",
           "quantize_ref"]
