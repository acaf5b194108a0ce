"""Shared model machinery: config, norms, RoPE, init helpers.

Port of `repro.models.common`. `rms_norm` carries the reference's custom
VJP as a `torch.autograd.Function`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..interop import tree_map


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab: int = 1024
    d_head: int = 0              # 0 → d_model // n_heads
    qk_norm: bool = False
    window: int = 0              # sliding-window attention (0 = full)
    rope_theta: float = 1e4
    mlp_act: str = "silu"        # silu (gated) | gelu (2-matrix)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid / xlstm
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head: int = 64           # mamba2 head dim P
    attn_every: int = 0          # zamba2: shared attention block period
    slstm_at: Tuple[int, ...] = ()
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_len: int = 0
    # vlm (llava)
    img_tokens: int = 0
    # numerics / parallelism
    dtype: str = "bfloat16"
    tp: int = 1                  # tensor-parallel degree for head padding
    remat: bool = True
    scan_layers: bool = True
    moe_group: int = 2048        # tokens per MoE dispatch group
    train_accum: int = 1         # gradient-accumulation microbatches
    serve_fsdp: bool = False     # serve with 2-D-sharded params
    fused_attention: bool = False  # prefill attention in the flash kernel
    serve_int8_weights: bool = False  # int8 weight gathers at serve
    q_chunk: int = 1024          # query chunking for causal attention
    ssd_chunk: int = 64          # chunk length for SSD / chunkwise mLSTM
    max_full_attn_seq: int = 65536
    decode_window: int = 0       # 0 = full cache

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to the 128-lane boundary."""
        return ((self.vocab + 127) // 128) * 128

    def param_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"{self.dtype!r} is not a torch float type")
        return dt


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def _rms_norm_impl(x: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(dt)


class _RMSNorm(torch.autograd.Function):
    """The reference's `custom_vjp` (`repro.models.common._rms_bwd`): the
    backward in f32, dx in x's type, dscale summed over every leading axis
    in scale's type."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_impl(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = xf * r
        gs = gf * scale.float()
        dx = r * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
        dscale = (gf * xhat).sum(dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 internal math, cast back to x's type; its gradient
    is the reference's (f32 math, cotangents in the stream's type)."""
    return _RMSNorm.apply(x, scale, eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D), positions: (B, S) or (S,).

    The reference's formula, freqs = exp(−arange(half)·log(θ)/half), all in
    f32 (log θ and its quotient too, rounded on the host), so the two
    packages agree to f32 rounding. Everything is made on x's device: no
    host-to-device copy per call."""
    half = x.shape[-1] // 2
    rate = float(np.float32(np.log(np.float32(theta))) / np.float32(half))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) * rate)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape: Tuple[int, ...],
               dtype: torch.dtype, scale: Optional[float] = None,
               device: DeviceLike = "cuda") -> torch.Tensor:
    """N(0, 1)·scale drawn in f32 on the generator's device, then cast and
    placed on ``device``. The default scale is the reference's
    1/sqrt(fan_in) with fan_in = shape[-2] (so for wq (d, H, dh) it is H)."""
    dev = resolve_device(device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32) * s
    return w.to(dev, dtype)


def stack_layers(layer_params: list) -> Any:
    """[{...}, {...}] → {...} with a leading layer dim."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *layer_params)
