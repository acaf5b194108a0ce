"""Learnable-bit-width quantization-aware training (paper §4), in PyTorch.

Port of `repro.core.qat`. Per layer, a fixed-point format for weights and
activations is learned by making the bit width differentiable:

  * integer width i and fraction width f are separate continuous
    parameters, so deployed values ARE their fixed-point representation;
  * quantization at a non-integer width b interpolates between the two
    adjacent integer widths: Q_b(x) = (1-α)·Q_⌊b⌋(x) + α·Q_⌈b⌉(x);
  * a straight-through estimator passes gradients through the rounding;
  * the loss gains QLF · (B_p + B_a)/2, the average parameter/activation
    widths.

At deployment the learned (i, f) map onto the card's native datapaths:
int8 (≤ 8 bits), bf16 (≤ 16 bits) or fp32 — `deployment_plan` and
`plan_backend` below. `torch.round` rounds half to even, as `jnp.round`
does, so the fake-quantized values agree bitwise with the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class QATConfig:
    qlf: float = 5e-4             # quantization trade-off factor
    init_int_bits: float = 16.0   # phase-1 format: Q16.16
    init_frac_bits: float = 16.0
    min_bits: float = 1.0
    enabled: bool = True


def _t(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _scalar(v) -> float:
    return float(v.item() if isinstance(v, torch.Tensor) else v)


# ---------------------------------------------------------------------------
# Fixed-point fake quantization
# ---------------------------------------------------------------------------

def _round_ste(x: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def quantize_fixed(x: torch.Tensor, int_bits, frac_bits) -> torch.Tensor:
    """Fixed-point quantization to signed Q(int_bits).(frac_bits).

    Integer widths only — see `quantize_interp` for the differentiable-width
    version. STE on the rounding; the clip passes gradients inside the range.
    """
    scale = torch.exp2(_t(frac_bits, x))
    hi = torch.exp2(_t(int_bits, x)) - 1.0 / scale
    lo = -torch.exp2(_t(int_bits, x))
    xq = _round_ste(x * scale) / scale
    return torch.minimum(torch.maximum(xq, lo), hi)


def quantize_interp(x: torch.Tensor, int_bits, frac_bits) -> torch.Tensor:
    """Differentiable-width quantization via floor/ceil interpolation.

    Differentiable with respect to both widths (and x through the STE), so
    the widths can be learned by backprop.
    """
    int_bits, frac_bits = _t(int_bits, x), _t(frac_bits, x)
    f_lo, f_hi = torch.floor(frac_bits), torch.ceil(frac_bits)
    a_f = frac_bits - f_lo
    i_lo, i_hi = torch.floor(int_bits), torch.ceil(int_bits)
    a_i = int_bits - i_lo
    q_ll = quantize_fixed(x, i_lo, f_lo)
    q_lh = quantize_fixed(x, i_lo, f_hi)
    q_hl = quantize_fixed(x, i_hi, f_lo)
    q_hh = quantize_fixed(x, i_hi, f_hi)
    q_l = (1 - a_f) * q_ll + a_f * q_lh
    q_h = (1 - a_f) * q_hl + a_f * q_hh
    return (1 - a_i) * q_l + a_i * q_h


# ---------------------------------------------------------------------------
# Per-layer quantizer parameter handling
# ---------------------------------------------------------------------------

def init_qparams(layer_names, cfg: QATConfig,
                 device: DeviceLike = "cuda") -> Dict[str, Any]:
    """One (w_int, w_frac, a_int, a_frac) quadruple per layer."""
    dev = resolve_device(device)

    def mk(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)
    return {
        name: {
            "w_int": mk(cfg.init_int_bits), "w_frac": mk(cfg.init_frac_bits),
            "a_int": mk(cfg.init_int_bits), "a_frac": mk(cfg.init_frac_bits),
        }
        for name in layer_names
    }


def clip_qparams(qparams: Dict[str, Any], cfg: QATConfig) -> Dict[str, Any]:
    """Project widths onto the feasible region after an optimizer step."""
    return {n: {k: torch.clamp(v, cfg.min_bits, 16.0) for k, v in q.items()}
            for n, q in qparams.items()}


def freeze_qparams(qparams: Dict[str, Any]) -> Dict[str, Any]:
    """Phase 3: fix widths to the next-highest integer (paper §4 step 3)."""
    return {n: {k: torch.ceil(v) for k, v in q.items()}
            for n, q in qparams.items()}


def apply_weight_quant(w: torch.Tensor, q: Dict[str, Any],
                       enabled: bool = True) -> torch.Tensor:
    if not enabled:
        return w
    return quantize_interp(w, q["w_int"], q["w_frac"])


def apply_act_quant(a: torch.Tensor, q: Dict[str, Any],
                    enabled: bool = True) -> torch.Tensor:
    if not enabled:
        return a
    return quantize_interp(a, q["a_int"], q["a_frac"])


def average_bits(qparams: Dict[str, Any]):
    """(B_p, B_a): average total width of params / activations (+sign bit)."""
    w = [q["w_int"] + q["w_frac"] + 1.0 for q in qparams.values()]
    a = [q["a_int"] + q["a_frac"] + 1.0 for q in qparams.values()]
    return sum(w) / len(w), sum(a) / len(a)


def quant_loss_term(qparams: Dict[str, Any], cfg: QATConfig):
    """QLF · (B_p + B_a) / 2 — the paper's quantization-aware loss term."""
    bp, ba = average_bits(qparams)
    return cfg.qlf * (bp + ba) / 2.0


def deployment_dtype(q: Dict[str, Any]) -> str:
    """Map a learned weight format to the nearest native dtype."""
    total = _scalar(q["w_int"]) + _scalar(q["w_frac"]) + 1.0
    if total <= 8:
        return "int8"
    if total <= 16:
        return "bfloat16"   # 8-bit exponent covers the int range
    return "float32"


def frozen_format(q: Dict[str, Any]):
    """Learned widths → concrete integer (w_int, w_frac, a_int, a_frac).

    Rounds UP like phase-3 freezing (`freeze_qparams`), so the deployed grid
    always covers the trained one. This is the per-layer fixed-point format
    the int8 fused kernel takes as its scales and clip bounds.
    """
    return tuple(int(np.ceil(np.float32(_scalar(q[k]))))
                 for k in ("w_int", "w_frac", "a_int", "a_frac"))


def _np64(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float64).numpy()
    return np.asarray(w, np.float64)


def per_channel_formats(weights, formats):
    """Refine per-layer weight formats to per-OUTPUT-CHANNEL scales.

    Keeps each layer's learned TOTAL weight width (w_int + w_frac) but
    redistributes it per output channel: a channel whose folded weights are
    small narrows its integer width and gains fraction bits. The int8 dot is
    unchanged; only the per-row requantization scale becomes per channel.

    weights: BN-folded ((w, b), …) — the weights the int8 kernel quantizes.
    formats: per-layer scalar (w_int, w_frac, a_int, a_frac).

    Returns formats where w_int/w_frac are length-C_out tuples of ints;
    layers whose every channel needs the full learned integer width come
    back unchanged (scalar).
    """
    out = []
    for (w, _), (wi, wf, ai, af) in zip(weights, formats):
        total = int(wi) + int(wf)            # magnitude bits, sign excluded
        wv = _np64(w)
        wabs = np.max(np.abs(wv).reshape(wv.shape[0], -1), axis=1)
        wi_c = np.ceil(np.log2(np.maximum(wabs, 1e-12))).astype(np.int64)
        # never widen past the learned grid, never narrow absurdly (an
        # all-zero channel would otherwise get a 2^-40 grid)
        wi_c = np.clip(wi_c, int(wi) - 8, int(wi))
        # Q(i).(f) tops out at 2^i − 2^−f: a max right at the power of two
        # needs one more integer bit
        for c in range(wi_c.shape[0]):
            f_c = total - int(wi_c[c])
            if wabs[c] > 2.0 ** int(wi_c[c]) - 2.0 ** -f_c:
                wi_c[c] = min(int(wi_c[c]) + 1, int(wi))
        if np.all(wi_c == int(wi)):
            out.append((wi, wf, ai, af))     # nothing to reclaim
            continue
        out.append((tuple(int(v) for v in wi_c),
                    tuple(total - int(v) for v in wi_c), ai, af))
    return tuple(out)


def format_max_bits(wi, wf) -> int:
    """Worst-case total width (+sign) of a scalar OR per-channel format."""
    return int(np.max(np.asarray(wi) + np.asarray(wf))) + 1


def _layer_order(qparams: Dict[str, Any]):
    """'layer0' … 'layerN' keys in layer order (robust to dict ordering)."""
    return sorted(qparams, key=lambda n: int("".join(filter(str.isdigit, n))
                                             or 0))


def layer_formats(qparams: Dict[str, Any]):
    """Ordered tuple of frozen per-layer formats for the whole stack."""
    return tuple(frozen_format(qparams[n]) for n in _layer_order(qparams))


def _format_dtype(total_bits: int) -> str:
    if total_bits <= 8:
        return "int8"
    if total_bits <= 16:
        return "bfloat16"
    return "float32"


def plan_backend(plan: Dict[str, Any]) -> str:
    """Map a deployment plan to the engine backend that serves it natively.

    all layers int8        → "fused_int8"   (int8 dots, int32 accumulation)
    all layers ≤ 16 bits   → "fused_bf16"   (bf16 dots, fp32 accumulation)
    anything wider         → "fused_fp32"
    """
    dts = set(plan["dtypes"].values())
    if dts <= {"int8"}:
        return "fused_int8"
    if dts <= {"int8", "bfloat16"}:
        return "fused_bf16"
    return "fused_fp32"


def deployment_plan(qparams: Dict[str, Any]) -> Dict[str, Any]:
    """Summarize how a trained quantizer deploys on the card's datapaths.

    Returns {"formats": ((w_int, w_frac, a_int, a_frac), …),
             "dtypes": {layer: dtype}, "all_int8": bool}. The per-layer dtype
    uses the FROZEN formats and the wider of the weight and activation
    requirement, so the record never says "int8" for a layer the engine
    refuses to deploy as int8.
    """
    names = _layer_order(qparams)
    formats = tuple(frozen_format(qparams[n]) for n in names)
    dtypes = {n: _format_dtype(max(wi + wf, ai + af) + 1)
              for n, (wi, wf, ai, af) in zip(names, formats)}
    all_int8 = all(d == "int8" for d in dtypes.values())
    return {"formats": formats, "dtypes": dtypes, "all_int8": all_int8}
