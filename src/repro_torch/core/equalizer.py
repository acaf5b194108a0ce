"""The paper's CNN equalizer topology template (§3.1, Fig. 1/3), in PyTorch.

Port of `repro.core.equalizer`. Topology (L layers, kernel K, channels C,
parallel symbols V_p, oversampling N_os):

    conv1  : 1   → C     stride V_p   + BN + ReLU
    conv i : C   → C     stride 1     + BN + ReLU      (i = 2 … L-1)
    conv L : C   → V_p   stride N_os  (linear output)
    flatten: (width, V_p) → width · V_p output symbols

Parameters are plain dicts of tensors with the reference's layout (w[l] is
(C_out, C_in, K)), so `interop` carries them across unchanged. `fold_bn`
gives the deployment weights the fused kernels consume. Convolutions here
are `F.conv1d` with SAME_LOWER padding, run inside `fp32_exact()` so that
the card does not drop to TF32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, fp32_exact, resolve_device
from . import qat as qat_lib


@dataclasses.dataclass(frozen=True)
class CNNEqConfig:
    layers: int = 3          # L
    kernel: int = 9          # K
    channels: int = 5        # C
    v_parallel: int = 8      # V_p — symbols per network pass
    n_os: int = 2            # oversampling of the input waveform
    levels: int = 2          # PAM order
    bn_momentum: float = 0.9

    @property
    def receptive_field_syms(self) -> int:
        """Overlap formula of paper §6.1: o_sym = (K-1)(1 + V_p(L-1)) / 2
        symbols on EACH side."""
        return (self.kernel - 1) * (1 + self.v_parallel * (self.layers - 1)) // 2

    def mac_per_symbol(self) -> float:
        """Paper's complexity metric MAC_sym (§3.5)."""
        k, c, l, vp, nos = (self.kernel, self.channels, self.layers,
                            self.v_parallel, self.n_os)
        return k * c / vp + (l - 2) * k * c * c / vp + k * c / nos

    def layer_specs(self):
        """[(c_in, c_out, stride), ...] for each conv layer."""
        specs = [(1, self.channels, self.v_parallel)]
        for _ in range(self.layers - 2):
            specs.append((self.channels, self.channels, 1))
        specs.append((self.channels, self.v_parallel, self.n_os))
        return specs


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: CNNEqConfig,
         qat: Optional[qat_lib.QATConfig] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """He-initialized parameters. Layout: w[l] has shape (C_out, C_in, K).

    Draws on the CPU from ``generator`` (so a seed gives the same weights
    whatever the device), then moves them to ``device``.
    """
    dev = resolve_device(device)
    params: Dict[str, Any] = {"conv": [], "bn": []}
    for i, (c_in, c_out, _) in enumerate(cfg.layer_specs()):
        fan_in = c_in * cfg.kernel
        w = torch.randn((c_out, c_in, cfg.kernel), generator=generator,
                        dtype=torch.float32) * (2.0 / fan_in) ** 0.5
        params["conv"].append({"w": w.to(dev),
                               "b": torch.zeros(c_out, device=dev)})
        if i < cfg.layers - 1:
            params["bn"].append({"scale": torch.ones(c_out, device=dev),
                                 "bias": torch.zeros(c_out, device=dev)})
    if qat is not None and qat.enabled:
        params["qat"] = qat_lib.init_qparams(
            [f"layer{i}" for i in range(cfg.layers)], qat, device=dev)
    return params


def init_bn_state(cfg: CNNEqConfig,
                  device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Running statistics for BN (non-trainable state)."""
    dev = resolve_device(device)
    state = []
    for i, (_, c_out, _) in enumerate(cfg.layer_specs()):
        if i < cfg.layers - 1:
            state.append({"mean": torch.zeros(c_out, device=dev),
                          "var": torch.ones(c_out, device=dev)})
    return {"bn": state}


def _conv1d(x: torch.Tensor, w: torch.Tensor, stride: int,
            padding: str | Tuple[int, int] = "SAME_LOWER") -> torch.Tensor:
    """x: (N, C_in, W), w: (C_out, C_in, K) → (N, C_out, W_out)."""
    k = w.shape[-1]
    pad = (k // 2, k - 1 - k // 2) if padding == "SAME_LOWER" else padding
    with fp32_exact():
        return F.conv1d(F.pad(x, pad), w, stride=stride)


def apply(params: Dict[str, Any], x: torch.Tensor, cfg: CNNEqConfig,
          *, train: bool = False, bn_state: Optional[Dict[str, Any]] = None,
          qat_enabled: bool = False):
    """Forward pass on ``x``'s device.

    Args:
      x: waveform, shape (S·N_os,) or (batch, S·N_os).
    Returns:
      (soft_symbols[(batch,) S], new_bn_state)
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    h = x[:, None, :]  # (N, 1, W)
    new_bn: Dict[str, Any] = {"bn": []}
    qp = params.get("qat")

    for i, (_, _, stride) in enumerate(cfg.layer_specs()):
        w = params["conv"][i]["w"]
        b = params["conv"][i]["b"]
        if qat_enabled and qp is not None:
            q = qp[f"layer{i}"]
            w = qat_lib.apply_weight_quant(w, q)
            h = qat_lib.apply_act_quant(h, q)
        h = _conv1d(h, w, stride) + b[None, :, None]
        if i < cfg.layers - 1:
            bn_p = params["bn"][i]
            if train or bn_state is None:
                mean = torch.mean(h, dim=(0, 2))
                var = torch.var(h, dim=(0, 2), correction=0)
            else:
                mean = bn_state["bn"][i]["mean"]
                var = bn_state["bn"][i]["var"]
            if train and bn_state is not None:
                m = cfg.bn_momentum
                new_bn["bn"].append({
                    "mean": m * bn_state["bn"][i]["mean"] + (1 - m) * mean,
                    "var": m * bn_state["bn"][i]["var"] + (1 - m) * var,
                })
            h = (h - mean[None, :, None]) / torch.sqrt(
                var[None, :, None] + 1e-5)
            h = h * bn_p["scale"][None, :, None] + bn_p["bias"][None, :, None]
            h = torch.relu(h)

    # flatten (N, V_p, W_L) → (N, W_L · V_p): feature-map elements ARE the
    # output symbols
    y = h.transpose(1, 2).reshape(h.shape[0], -1)
    if squeeze:
        y = y[0]
    return y, (new_bn if new_bn["bn"] else bn_state)


def fold_bn(params: Dict[str, Any], bn_state: Dict[str, Any],
            cfg: CNNEqConfig) -> Dict[str, Any]:
    """Fold BN running stats into conv weights (FPGA-style deployment).

    After folding, `apply_folded` needs no BN state and matches eval-mode
    `apply`; this is what the fused kernels consume.
    """
    folded: Dict[str, Any] = {"conv": []}
    for i, _ in enumerate(cfg.layer_specs()):
        w = params["conv"][i]["w"]
        b = params["conv"][i]["b"]
        if i < cfg.layers - 1:
            bn_p = params["bn"][i]
            mean = bn_state["bn"][i]["mean"]
            var = bn_state["bn"][i]["var"]
            g = bn_p["scale"] / torch.sqrt(var + 1e-5)
            w = w * g[:, None, None]
            b = (b - mean) * g + bn_p["bias"]
        folded["conv"].append({"w": w, "b": b})
    return folded


def folded_weights(folded: Dict[str, Any]) -> Tuple:
    """Folded params → ((w, b), …) kernel argument layout."""
    return tuple((l["w"], l["b"]) for l in folded["conv"])


def layer_strides(cfg: CNNEqConfig) -> Tuple[int, ...]:
    """(V_p, 1, …, N_os) — per-layer strides in kernel-argument form."""
    return tuple(s for _, _, s in cfg.layer_specs())


def apply_folded(folded: Dict[str, Any], x: torch.Tensor, cfg: CNNEqConfig):
    """Inference with BN pre-folded (ReLU still applied between layers)."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    h = x[:, None, :]
    for i, (_, _, stride) in enumerate(cfg.layer_specs()):
        w = folded["conv"][i]["w"]
        b = folded["conv"][i]["b"]
        h = _conv1d(h, w, stride) + b[None, :, None]
        if i < cfg.layers - 1:
            h = torch.relu(h)
    y = h.transpose(1, 2).reshape(h.shape[0], -1)
    return y[0] if squeeze else y
