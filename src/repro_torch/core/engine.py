"""EqualizerEngine — the single production inference path, in PyTorch.

Port of `repro.core.engine`. The engine owns:

  * BN folding (once, at construction — the FPGA deployment step);
  * backend selection:
      - "ref"        the plain fp32 version (kernels.cnn_eq.ref.cnn_eq),
      - "fused_fp32" the fused CUDA kernel, fp32 datapath,
      - "fused_bf16" the fused CUDA kernel with bf16 operands and fp32
        accumulation — QAT formats of 9–16 bits,
      - "fused_int8" the fused CUDA kernel on int8 weights at QAT's learned
        scales, int32 accumulation, requantization between layers,
      - "auto"       fused_int8 when the trained formats deploy to int8 AND
        the BN-folded weights still fit the learned grid; else fused_bf16
        when every frozen format fits 16 bits; else fused_fp32;
  * tile_m selection: an explicit int, or "auto" → the cached autotune
    sweep (core.autotune) keyed on (topology, backend, platform) where
    the backend's kernel tiles by it, else UNTIMED_TILE_M.

Folding and weight quantization run on the host in fp32 and the results
move to the engine's device afterwards, so the deployed weights on the card
are exactly those the CPU tests check. On the card the fused backends
launch the hand-written kernels; on the CPU they run the kernels' plain
versions (`device="cpu"`, the tests). "auto" never picks "ref".

An engine is a plain callable `(W,) | (B, W) waveform → symbols`. Engines
that share a `group_key()` can be fused into ONE stacked launch with
per-row weights via `stacked_engine_fn` — the multi-tenant serving path:
row i is computed with engine i's weights, bitwise equal to engine i alone.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import interop
from ..device import DeviceLike, resolve_device
from . import autotune as autotune_lib
from . import qat as qat_lib
from .equalizer import (CNNEqConfig, fold_bn, folded_weights, init_bn_state,
                        layer_strides)

BACKENDS = ("ref", "fused_fp32", "fused_bf16", "fused_int8")

# tile_m of a backend whose kernel takes none: "ref", and fp32, bf16 and
# int8 at the paper's widths, whose kernel (cnn_eq_kernel_rb) splits each
# row into runs of its own. The width still sets the serving layer's launch-width
# quantum (serve.scheduler's _bucket_width) and the chunker's tile
# alignment, so it is fixed rather than timed: a timed pick would only
# measure noise. 64 positions is the wrappers' default.
UNTIMED_TILE_M = 64

Format = Tuple[int, int, int, int]          # (w_int, w_frac, a_int, a_frac)


def _folded_fit_grid(weights, formats) -> bool:
    """True iff every BN-folded weight is representable on its layer's
    learned Q(w_int).(w_frac) grid without saturating (per-channel formats
    checked channel by channel)."""
    for (w, _), (wi, wf, _, _) in zip(weights, formats):
        wi_col = np.asarray(wi, np.float64).reshape(-1, 1, 1)
        wf_col = np.asarray(wf, np.float64).reshape(-1, 1, 1)
        hi = np.exp2(wi_col) - np.exp2(-wf_col)
        lo = -np.exp2(wi_col)
        wv = qat_lib._np64(w)
        if bool(np.any(wv > hi)) or bool(np.any(wv < lo)):
            return False
    return True


def _host_f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _to(weights, dev: torch.device) -> Tuple:
    return tuple((w.to(dev).contiguous(), b.to(dev).contiguous())
                 for w, b in weights)


@dataclasses.dataclass
class EqualizerEngine:
    """Callable quantized/fused inference engine for the CNN equalizer.

    Build with `EqualizerEngine.from_params` (trained params + BN state,
    QAT formats picked up automatically) or directly from folded weights
    (tensors or numpy arrays, any device). ``device`` defaults to "cuda"
    and raises when no card is present.
    """
    cfg: CNNEqConfig
    weights: Tuple                                        # BN-folded, fp32
    backend: str = "fused_fp32"
    tile_m: int | str = "auto"
    formats: Optional[Tuple[Format, ...]] = None          # int8 backend only
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        host = tuple((_host_f32(w), _host_f32(b)) for w, b in self.weights)
        if self.backend == "auto":
            # int8 only when the FOLDED weights still fit the learned grid;
            # a vetoed int8 or a 9–16-bit format deploys bf16
            if self._int8_deployable() and _folded_fit_grid(host,
                                                            self.formats):
                self.backend = "fused_int8"
            elif self._bf16_deployable():
                self.backend = "fused_bf16"
            else:
                self.backend = "fused_fp32"
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS + ('auto',)}")
        from ..kernels.cnn_eq import cnn_eq as kern
        if self.backend == "fused_int8":
            if not self._int8_deployable():
                raise ValueError(
                    "fused_int8 needs per-layer formats that fit int8 "
                    "(qat.deployment_plan(...)['all_int8']); got "
                    f"{self.formats}")
            self._qweights = _to(kern.quantize_weights_int8(host,
                                                            self.formats),
                                 self.device)
        if self.backend == "fused_bf16":
            self._bweights = _to(kern.cast_weights_bf16(host), self.device)
        self.weights = _to(host, self.device)
        self._strides = layer_strides(self.cfg)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_params(cls, params: Dict[str, Any], bn_state: Optional[Dict],
                    cfg: CNNEqConfig, backend: str = "auto",
                    tile_m: int | str = "auto",
                    device: DeviceLike = "cuda",
                    per_channel: bool = False) -> "EqualizerEngine":
        """Deployment step: fold BN (on the host, fp32), derive the
        quantized-deployment formats from the learned QAT widths
        (`qat.deployment_plan`), pick the backend.

        Folding multiplies by g = scale/√(var+ε), which can push weights
        past the learned grid; auto-deployment goes int8 only when the
        FOLDED weights still fit, else bf16 (whose exponent covers the
        overflow). per_channel=True refines the per-layer weight formats to
        per-output-channel scales (`qat.per_channel_formats`).
        """
        dev = resolve_device(device)
        host_params = interop.to_torch(params, device="cpu")
        bn = (interop.to_torch(bn_state, device="cpu") if bn_state
              else init_bn_state(cfg, device="cpu"))
        weights = folded_weights(fold_bn(host_params, bn, cfg))
        formats = None
        if "qat" in host_params:
            plan = qat_lib.deployment_plan(host_params["qat"])
            if qat_lib.plan_backend(plan) != "fused_fp32":
                formats = plan["formats"]
        if per_channel and formats is not None:
            formats = qat_lib.per_channel_formats(weights, formats)
        if (backend == "fused_int8" and formats is not None
                and not _folded_fit_grid(weights, formats)):
            raise ValueError(
                "explicit fused_int8 requested but the BN-folded weights "
                "overflow the learned Q(w_int) grids — deploying would "
                "silently saturate; use backend='auto' (deploys bf16) or "
                "retrain with folding-aware QAT")
        return cls(cfg=cfg, weights=weights, backend=backend,
                   tile_m=tile_m, formats=formats, device=dev)

    @classmethod
    def from_folded(cls, folded: Dict[str, Any], cfg: CNNEqConfig,
                    **kw) -> "EqualizerEngine":
        return cls(cfg=cfg, weights=folded_weights(folded), **kw)

    # -- backend plumbing --------------------------------------------------

    def _int8_deployable(self) -> bool:
        return (self.formats is not None
                and all(qat_lib.format_max_bits(wi, wf) <= 8
                        and ai + af + 1 <= 8
                        for wi, wf, ai, af in self.formats))

    def _bf16_deployable(self) -> bool:
        return (self.formats is not None
                and all(max(qat_lib.format_max_bits(wi, wf), ai + af + 1)
                        <= 16
                        for wi, wf, ai, af in self.formats))

    def tile_is_timed(self) -> bool:
        """Whether tile_m reaches this backend's kernel, so that the
        autotune has something to time."""
        from ..kernels.cnn_eq import cnn_eq as kern
        if self.backend == "ref":
            return False
        mode = {"fused_fp32": kern.MODE_FP32, "fused_bf16": kern.MODE_BF16,
                "fused_int8": kern.MODE_INT8}[self.backend]
        return kern.takes_tile_m(mode, self.weights, self._strides)

    def resolved_tile_m(self) -> int:
        """The tile width actually used (runs the autotune sweep if 'auto'
        and the kernel tiles by it)."""
        if isinstance(self.tile_m, int):
            return self.tile_m
        if not self.tile_is_timed():
            return UNTIMED_TILE_M
        best = autotune_lib.best_tile_m(
            self.cfg, self.backend, lambda t: self._make_fn(t),
            device=self.device)
        self.tile_m = best
        return best

    def _make_fn(self, tile_m: int) -> Callable[[torch.Tensor], torch.Tensor]:
        from ..kernels.cnn_eq import cnn_eq as kern
        from ..kernels.cnn_eq import ref
        if self.backend == "ref":
            return functools.partial(ref.cnn_eq, weights=self.weights,
                                     strides=self._strides)
        if self.backend == "fused_fp32":
            return lambda x: kern.cnn_eq_fused(x, self.weights, self._strides,
                                               tile_m=tile_m)
        if self.backend == "fused_bf16":
            return lambda x: kern.cnn_eq_fused_bf16(
                x, self._bweights, self._strides, tile_m=tile_m)
        return lambda x: kern.cnn_eq_fused_int8(
            x, self._qweights, self._strides, self.formats, tile_m=tile_m)

    def _layer_weights(self):
        """The weight tuple the active backend's kernel consumes."""
        if self.backend == "fused_int8":
            return self._qweights
        if self.backend == "fused_bf16":
            return self._bweights
        return self.weights

    # -- the production path -----------------------------------------------

    def __call__(self, x) -> torch.Tensor:
        """(S·N_os,) or (B, S·N_os) waveform → (S,) or (B, S) soft symbols,
        on the engine's device (a numpy or host input is copied there)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        y = self._make_fn(self.resolved_tile_m())(x)
        return y[0] if squeeze else y

    # -- multi-tenant serving surface --------------------------------------

    @property
    def total_stride(self) -> int:
        """Input samples consumed per network pass (V_p · N_os)."""
        return int(np.prod(self._strides))

    @property
    def halo_samples(self) -> int:
        """Half a receptive field per side, in SAMPLES — the overlap a
        streaming chunker must carry between chunks."""
        from ..kernels.cnn_eq.ref import receptive_halo
        kernels = tuple(int(w.shape[-1]) for w, _ in self.weights)
        return receptive_halo(kernels, self._strides)

    def tune_key(self) -> Tuple:
        """Hashable (topology, backend, static kernel config, device) — the
        group key WITHOUT the tile width. Never triggers an autotune sweep.
        """
        fmts = self.formats if self.backend == "fused_int8" else None
        return (self.cfg, self.backend, fmts, str(self.device))

    def group_key(self) -> Tuple:
        """Hashable key of everything a stacked launch must share: same
        topology, backend, static kernel config (int8 formats), device and
        tile width. Weights are NOT in the key: they ride in per-row
        stacked operands. Structurally `tune_key() + (tile_m,)`."""
        return self.tune_key() + (self.resolved_tile_m(),)

    def describe(self) -> Dict[str, Any]:
        """Deployment summary (for logs / benchmark records)."""
        return {
            "backend": self.backend,
            "tile_m": self.tile_m if isinstance(self.tile_m, int) else "auto",
            "layers": self.cfg.layers,
            "formats": self.formats,
            "device": str(self.device),
        }


def stacked_engine_fn(engines) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fuse same-group engines into ONE launch with per-row weights.

    engines: `EqualizerEngine`s whose `group_key()`s agree. Returns a
    callable (B, W) → (B, S) where row i runs through engine i's weights —
    bitwise equal to `engines[i](x[i:i+1])` (same kernel, same tiles; only
    the weight row differs). The "ref" backend has no stacked form and runs
    a per-row loop.
    """
    if not engines:
        raise ValueError("stacked_engine_fn needs at least one engine")
    e0 = engines[0]
    key = e0.group_key()
    for e in engines[1:]:
        if e.group_key() != key:
            raise ValueError(
                f"engines are not batch-compatible: {e.group_key()} != {key}")
    if len(engines) == 1:
        return lambda x: e0(x)
    if e0.backend == "ref":
        fns = [e._make_fn(e.resolved_tile_m()) for e in engines]
        return lambda x: torch.cat(
            [fn(x[i:i + 1]) for i, fn in enumerate(fns)], dim=0)

    from ..kernels.cnn_eq import cnn_eq as kern
    per = [e._layer_weights() for e in engines]
    stacked = tuple(
        (torch.stack([p[layer][0] for p in per]),
         torch.stack([p[layer][1] for p in per]))
        for layer in range(len(per[0])))
    tile_m = e0.resolved_tile_m()
    strides = e0._strides
    if e0.backend == "fused_fp32":
        return lambda x: kern.cnn_eq_fused(x, stacked, strides, tile_m=tile_m)
    if e0.backend == "fused_bf16":
        return lambda x: kern.cnn_eq_fused_bf16(x, stacked, strides,
                                                tile_m=tile_m)
    return lambda x: kern.cnn_eq_fused_int8(x, stacked, strides, e0.formats,
                                            tile_m=tile_m)
